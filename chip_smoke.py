#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py              # needs one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

  1. environment: torch / CUDA versions, the card's name and power limit
     (nvidia-smi), the TF32 switches asserted off;
  2. build: compile (or load) the CUDA kernel library, with ptxas's
     register and spill counts;
  3. kernel vs plain version on the card: ops/walk.walk_tree against
     walk_tree_plain at the largest and the smallest main-path group
     shapes, both compose modes, on the main path's own DP outputs, on
     seeded random maps and on maps with forced ties, on the face-68
     tree (4 root mixtures, layers 7 wide) at a small shape, and on
     shapes and mixture counts that reach every template instance of
     the kernel (lines read in pieces, 6 and 12 mixtures) — X, Y, Mm
     equal; median kernel times with the L2 warm and flushed, with CUDA
     events around the call (the host's time to reach the launch
     counts) and with a device spin hiding the host (the kernel alone),
     and the plain version's; the kernel's bound, with the card's
     dependent-load latency in and out of the L2 measured for its
     latency term; the DP's W-minor copy of tmp;
  4. main path: Detector(person_like(), device="cuda") with thresh 0.0
     on 8 seeded 640x480 uint8 frames (detect_batch_raw, B=8): the walk
     kernel's launch count, output shapes, sorted scores; again with
     thresh -1e9, where every slot a level can fill must be valid —
     min(K, h*w) per level, since the top levels hold fewer than K
     cells (4x6); and the card against the port on the CPU at 120x160
     (the cross-engine contract of tests/test_native_parity.py);
  5. end to end, kernel walk vs plain walk: the same batch with
     walk_impl="torch" gives equal Candidates;
  6. times at B=8: ms/frame and frames/s (median of 7 batches), per-stage
     device ms (the package's utils/profiling.CudaStageTimer: CUDA
     events at the detector's stage hook), peak device memory, and one
     batch under torch.profiler (utils/profiling.device_trace and
     device_busy): the device's busy and idle share and the kernels
     that take the most device time;
  7. the slice-3 paths, each path that ends in the walk kernel with the
     kernel's launch count set to 0 just before it and read just after
     (expected: one launch per dp group and component), ms/frame and
     peak device memory for each:
     (a) person-26 with shared filter ids (aliased_person), B=8: valid
         Candidates, kernel walk == plain walk end to end and on the
         aliased DP's outputs at the largest group, stages 3-4 on the
         card == on the CPU from the same responses at 120x160;
     (b) depth pruning, B=8, seeded depths: all-zero depths give the
         main path's Candidates, a depth implausible at every level
         leaves none valid;
     (c) the masked search on one frame, seeded masks: kernel walk ==
         plain walk;
     (d) the FFT engine, B=8: the cross-engine contract against the
         spatial engine on every frame, card vs CPU at 120x160;
     (e) pyramid_features: card vs CPU at 120x160, atol 1e-4;
     (f) MultiResDetector on one frame (root one octave coarser than
         its parts): shapes, order, card vs CPU at 120x160;
     (g) paint_nms, part_nms and grid_nms on one frame of the thresh
         -1e9 Candidates (a root score map for grid_nms): card == CPU;
  8. the serving path: person-26 (thresh -1e9) written by the port's
     save_filestorage to an .xml, served by the port's ROS node
     (PartsBasedDetectorNode.from_params, device "cuda") over a fake
     transport with mask, bounding_box, part_centers and object_poses
     subscribed, on 16 seeded 640x480 RGB-D frames (uint16 depth in mm,
     organized clouds, Kinect intrinsics): walk launches per dispatch
     of a ROS callback (B=1) and of StreamingDetector.stream (B=8);
     stream == process_batch == detect_batch_raw -> paint_nms ->
     candidates_to_detections; kernel-walk == plain-walk FrameResults;
     card vs CPU at 120x160 through StreamingDetector; the cleaned_cloud
     topic with planes removed on 2 frames; frames/s of process,
     process_batch and stream, the post stage's host ms per frame by
     stage, peak device memory and the messages published per topic;
  9. training on the card (the port's train_parts_model,
     device="cuda"): (1) the config of tests/test_train.py:202-227
     trained on the card and on the CPU: equal decisions (latent
     positives, cache after mining, prune passes), weights within 1e-4
     of max|w|, the same held-out root; (2) person-26 at full width (26
     parts x 4 mixtures, 104 filters; tests/test_accuracy_gate.py:
     89-160's data and config) with held-out PCK and APK >= 0.9, every
     detect checked to launch the walk kernel once per dp group and
     component; (3) kernel walk == plain walk on the latent search
     (masked, compose "correct"), a mining detect and the stage-1
     single-filter model (P = 1, M = 1), with their launches per call;
     (4) |w . detection_feature - score| < 5e-3 on held-out detections;
     (5) the cost: seconds by stage and by kind of call (detect,
     pyramid_features, host QP), peak device memory;
 10. face-68 at full width: synthetic.face_like() (68 parts x 4
     mixtures, 272 filters, interval 5, dp_split 3), thresh 0.0, on the
     8 frames of phase 4 (B=8): walk launches per dispatch (one per dp
     group and component), shapes and order, kernel walk == plain walk
     end to end (phase 5's twin), card vs CPU at 120x160 under the
     cross-engine contract, and phase 6's times;
 11. parallel/ at world size 1, person-26 at 640x480: BatchDetector on a
     (1, 1) mesh (B=8), ScaleShardedDetector on a (1, 1) scale mesh (one
     frame) and PipelinedDetector with front = back = cuda:0 (a stream
     of 2 frames), each equal to Detector on all Candidates fields, with
     its walk launches counted and its ms/frame; ScaleShardedDetector on
     a (1, 1) scale mesh with the multires person (thresh -1e9, one
     frame, its slots split over scale) equal to MultiResDetector on all
     fields with no walk launch, and the ms/frame and peak memory of
     both, in turns;
 12. StreamingDetector(mesh=make_mesh()) at world size 1: process_batch
     and stream (B=8) and process give the detections of the
     StreamingDetector without a mesh;
 13. the kernels line (JSON; launches per path beside the main path's),
     the card line, then the last line {"ok": true, "device": {...}}.

It imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks: HBM rate and
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

IMG = (480, 640)
BATCH = 8
K = 64


def log(*a):
    print(*a, flush=True)


# an L2 flush: writing this many bytes evicts the 50 MB L2
FLUSH_BYTES = 256 * 2**20
# ~0.5 ms of device spin ahead of a timed launch, longer than the host
# takes to reach the launch, so no host gap sits between the events
BUSY_CYCLES = 1_000_000


def cuda_ms(fn, reps: int, warmup: int = 2, pre=None) -> float:
    """Median ms of fn() over reps runs between two CUDA events; the
    device is idle at the first, so the host's time to reach the launch
    counts unless pre() queues device work longer than it.  pre() runs
    before each run's first event, outside the timing."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if pre is not None:
            pre()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------- phase 1
def phase_environment() -> str:
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}  (torch: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()})")
    import partsbaseddetector_tpu_torch.ops.common  # noqa: F401  (flags)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    log(f"cudnn.allow_tf32={flags[0]} cuda.matmul.allow_tf32={flags[1]} "
        f"float32_matmul_precision={flags[2]}")
    if flags != (False, False, "highest"):
        raise RuntimeError(f"TF32 / precision flags not off: {flags}")
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    from partsbaseddetector_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path, build_log = _build.build()
    _build.load_library()
    log(f"build: {path} in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())


# ---------------------------------------------------------------- phase 3
def walk_inputs_from_path(det, frames, group_index: int):
    """The walk's inputs for one dp group of the main path, from the
    port's own stages (largest group: index 0 of bucket 0)."""
    from partsbaseddetector_tpu_torch.infer.detector import (_dp_groups,
                                                             pyramid_pdfs)
    from partsbaseddetector_tpu_torch.ops.argmax import _root_seeds
    from partsbaseddetector_tpu_torch.ops.dp import dp_min_levels
    plan = det.plan_for(IMG)
    packed = det.packed
    groups = [(b, g) for b in plan.buckets
              for g in _dp_groups(b, det.dp_split)]
    bucket, (lo, hi, gfh, gfw) = groups[group_index]
    pdfs = [p for b, p, _, _ in pyramid_pdfs(frames, packed, plan)
            if b.octave == bucket.octave][0]
    B = frames.shape[0]
    tsizes = torch.tensor([lv.featsize for lv in bucket.levels[lo:hi]],
                          dtype=torch.int32, device=frames.device)
    gsizes = tsizes.repeat(B, 1)
    comp = packed.components[0]
    res = dp_min_levels(pdfs[:, lo:hi, :gfh, :gfw].flatten(0, 1), comp,
                        det.compose, true_sizes=gsizes)
    _, _, xs, ys, mv = _root_seeds(res.rootv, res.rooti, packed.thresh,
                                   det.k_per_level, gsizes)
    a = walk_args(res.scores, res.tmp, xs, ys, mv, comp,
                  packed.parent_static[0])
    a["rootv"] = res.rootv          # the group's root score maps
    return a


def walk_args(scores, tmp, xs, ys, mv, comp, parent_static):
    """walk_tree's arguments; tmp as the DP stores it (W-minor), parent
    on the host as the detector passes it."""
    return dict(scores=scores.contiguous(), tmp=tmp, xs=xs, ys=ys, mv=mv,
                defw=comp.defw,
                anchor=comp.anchor.to(torch.float32).contiguous(),
                bias=comp.bias,
                parent=torch.tensor(parent_static, dtype=torch.int32))


def synthetic_walk_inputs(comp, parent_static, L, H, W, seed, ties):
    """Seeded maps at a given shape, tmp stored W-minor as the DP stores
    it; with ties, integer-valued maps and zero deformation weights and
    biases, so argmaxes meet equals."""
    dev = comp.defw.device
    g = torch.Generator(device=dev).manual_seed(seed)
    P, M = comp.filterid.shape
    shape, shape_t = (L, P, M, H, W), (L, P, M, W, H)
    if ties:
        scores = torch.randint(0, 3, shape, generator=g, device=dev).float()
        tmp_t = torch.randint(0, 3, shape_t, generator=g,
                              device=dev).float()
    else:
        scores = torch.randn(shape, generator=g, device=dev)
        tmp_t = torch.randn(shape_t, generator=g, device=dev)
    tmp = tmp_t.transpose(-1, -2)
    nroot = int(comp.nmix[0])
    xs = torch.randint(0, W, (L, K), generator=g, device=dev,
                       dtype=torch.int32)
    ys = torch.randint(0, H, (L, K), generator=g, device=dev,
                       dtype=torch.int32)
    mv = torch.randint(0, nroot, (L, K), generator=g, device=dev,
                       dtype=torch.int32)
    a = walk_args(scores, tmp, xs, ys, mv, comp, parent_static)
    if ties:
        a["defw"] = torch.zeros_like(a["defw"])
        a["bias"] = torch.where(a["bias"] > -1e29, 0.0, a["bias"])
    return a


def call_walk(fn, a, compose):
    return fn(a["scores"], a["tmp"], a["xs"], a["ys"], a["mv"], a["defw"],
              a["anchor"], a["bias"], a["parent"], compose)


def l2_flush():
    """Write a FLUSH_BYTES buffer: every line the L2 held is evicted."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.zero_()


def busy():
    torch.cuda._sleep(BUSY_CYCLES)


def load_latency_ns(n: int, flush=None) -> float:
    """The card's dependent-load latency in ns: one thread chasing a
    random cyclic permutation of n int32, timed at two chain lengths so
    that the launch cancels.  Every run starts at the same link.
    Without flush, the warm-up runs leave the chain's lines (2.5 MB at
    most) in the L2, so this is the latency of a dependent load that
    hits the L2: the least one round of the walk can take, as in the
    walk's warm runs, which repeat one launch.  With flush (run before
    each timed run) over a chain larger than the L2, every link misses
    it: one round of a walk whose maps the DP has pushed out of the
    L2."""
    from partsbaseddetector_tpu_torch.ops import _build
    lib = _build.load_library()
    g = torch.Generator(device="cuda").manual_seed(5)
    perm = torch.randperm(n, generator=g, device="cuda", dtype=torch.int32)
    nxt = torch.empty_like(perm)
    nxt[perm.long()] = perm.roll(-1)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def chase(steps):
        rc = lib.pbd_chase(nxt.data_ptr(), steps, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"latency probe launch failed: CUDA error "
                               f"{rc}")

    short, long_ = 2_000, 20_000
    ms = [cuda_ms(lambda: chase(steps), reps=5, pre=flush)
          for steps in (short, long_)]
    return (ms[1] - ms[0]) / (long_ - short) * 1e6


def walk_bound(a, plain_outs, compose: str, load_ns: float,
               miss_ns: float) -> dict:
    """The least time one walk launch could take on these inputs.

    bytes: each line the walk needs read once — the distinct columns and
    rows that the plain walk of these seeds touches — plus seeds,
    parameters and outputs; operations: the candidate expressions
    evaluated, at the float32 rate.  bound_ms is the larger of the two.
    Beside it, the latency of a walk that takes the parts of one depth
    side by side, as the kernel does: a part waits for its parent and
    is at least two dependent rounds of loads (the lines keyed by the
    parent's position, then the one line keyed by the result), so
    depth*2 loads, of load_ns each with the L2 warm and miss_ns each
    with it flushed; and the bytes the kernel gathers, every candidate
    reading its own lines: L*(P-1)*K*(M*H + M*W + H)*4 under
    "reference" (the M rows are speculative), L*(P-1)*K*(M*H + W)*4
    under "correct"."""
    from partsbaseddetector_tpu_torch.ops.walk import depth_layers
    X, Y, Mm = (o.long() for o in plain_outs)
    L, P, M, H, W = a["scores"].shape
    Kk = X.shape[-1]
    par = a["parent"].long().to(X.device)
    px, py = X[:, par[1:]], Y[:, par[1:]]          # parents' (L, P-1, K)
    x, y, mc = X[:, 1:], Y[:, 1:], Mm[:, 1:]
    lp = (torch.arange(L, device=X.device)[:, None, None] * P
          + torch.arange(1, P, device=X.device)[None, :, None])
    lp = lp.expand_as(px)
    # tmp columns (l, p, m, col): every m at px; the y step's (mc, col)
    cols_mix = ((lp[..., None] * M + torch.arange(M, device=X.device))
                * W + px[..., None])
    ycol = x if compose == "reference" else px
    cols_y = (lp * M + mc) * W + ycol
    ncols = torch.unique(torch.cat([cols_mix.flatten(),
                                    cols_y.flatten()])).numel()
    xrow = py if compose == "reference" else y
    nrows = torch.unique(((lp * M + mc) * H + xrow).flatten()).numel()
    params = sum(a[k].numel() * 4 for k in ("defw", "anchor", "bias",
                                            "parent"))
    nbytes = (ncols * H + nrows * W) * 4 + 3 * L * Kk * 4 + params \
        + 3 * L * P * Kk * 4
    flops = L * (P - 1) * Kk * (M * (H * 7 + 1) + (W + H) * 7)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    per_item = M * H + M * W + H if compose == "reference" else M * H + W
    gathered = L * (P - 1) * Kk * per_item * 4
    depth = len(depth_layers(a["parent"])[1]) - 2
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, depth=depth,
                latency_ms=depth * 2 * load_ns * 1e-6,
                latency_cold_ms=depth * 2 * miss_ns * 1e-6,
                gathered_bytes=gathered,
                gathered_ms=gathered / HBM_BYTES_PER_S * 1e3)


def walk_instance(M: int, H: int, W: int):
    """The kernel instance (mixtures, column slots, row slots a lane)
    that csrc/walk.cu's dispatch picks for these shapes."""
    def slots(n):
        need = -(-n // 32)
        return min(8, need + need % 2)
    sh, sw = slots(H), slots(W)
    if M <= 4:
        return 4, sh, sw
    if M <= 8:
        return (8, 2, 2) if sh <= 2 and sw <= 2 else (8, 4, 4)
    return 16, 2, 2


# every instance dispatch holds: 4 mixtures x column and row slots in
# {2, 4, 6, 8}, then 8 and 16 mixtures
WALK_INSTANCES = ({(4, a, b) for a in (2, 4, 6, 8) for b in (2, 4, 6, 8)}
                  | {(8, 2, 2), (8, 4, 4), (16, 2, 2)})


def coverage_cases():
    """Synthetic walk cases that reach every kernel instance, and every
    way an instance reads a line: in one piece or several (a line
    longer than 32 x slots), so that under "reference" the speculative
    rows are not held and under "correct" the column is read again.
    Odd H or W take 4-byte loads, even ones 8-byte.  Returns {name:
    inputs} and the set of (instance, column pieces, row pieces) hit."""
    from partsbaseddetector_tpu_torch.models import synthetic
    from partsbaseddetector_tpu_torch.models.part_tree import pack_model
    trees = {M: pack_model(synthetic.person_like(nmixtures=M,
                                                 root_nmixtures=r), "cuda")
             for M, r in ((4, 1), (6, 3), (12, 2))}
    shapes = [(4, h, w, False) for h in (37, 100, 171, 230)
              for w in (52, 117, 190, 230)]
    shapes += [(4, 300, 400, False), (4, 300, 400, True),
               (4, 37, 117, True),
               (6, 40, 52, False), (6, 118, 158, False),
               (6, 118, 158, True), (6, 300, 400, False),
               (12, 40, 52, False), (12, 118, 158, False),
               (12, 118, 158, True)]
    cases, hit = {}, set()
    for i, (M, H, W, ties) in enumerate(shapes):
        packed = trees[M]
        inst = walk_instance(M, H, W)
        hit.add((inst, H > 32 * inst[1], W > 32 * inst[2]))
        name = f"M{M}-{H}x{W}{'-ties' if ties else ''}"
        cases[name] = synthetic_walk_inputs(
            packed.components[0], packed.parent_static[0], 2, H, W,
            100 + i, ties)
    return cases, hit


def phase_kernel_vs_plain(det, frames) -> dict:
    from partsbaseddetector_tpu_torch.infer.detector import _dp_groups
    from partsbaseddetector_tpu_torch.models import synthetic
    from partsbaseddetector_tpu_torch.models.part_tree import pack_model
    from partsbaseddetector_tpu_torch.ops import walk
    comp = det.packed.components[0]
    pst = det.packed.parent_static[0]
    face = pack_model(synthetic.face_like(), "cuda")
    fcomp, fpst = face.components[0], face.parent_static[0]
    plan = det.plan_for(IMG)
    ngroups = sum(len(_dp_groups(b, det.dp_split)) for b in plan.buckets)
    real_big = walk_inputs_from_path(det, frames, 0)
    real_small = walk_inputs_from_path(det, frames, ngroups - 1)
    L, _, _, H, W = real_big["scores"].shape
    Ls, _, _, Hs, Ws = real_small["scores"].shape
    log(f"largest group: L={L} H={H} W={W} K={K};  smallest: L={Ls} "
        f"H={Hs} W={Ws};  face-68: L=4 H=40 W=52")
    cases = {
        "path-largest": real_big, "path-smallest": real_small,
        "rand-largest": synthetic_walk_inputs(comp, pst, L, H, W, 1, False),
        "rand-smallest": synthetic_walk_inputs(comp, pst, Ls, Hs, Ws, 2,
                                               False),
        "ties-largest": synthetic_walk_inputs(comp, pst, L, H, W, 3, True),
        "ties-smallest": synthetic_walk_inputs(comp, pst, Ls, Hs, Ws, 4,
                                               True),
        "face68-rand": synthetic_walk_inputs(fcomp, fpst, 4, 40, 52, 5,
                                             False),
        "face68-ties": synthetic_walk_inputs(fcomp, fpst, 4, 40, 52, 6,
                                             True),
    }
    extra, hit = coverage_cases()
    missing = WALK_INSTANCES - {inst for inst, _, _ in hit}
    for M in (4, 8, 16):
        for j, lines in ((1, "columns"), (2, "rows")):
            if not any(h[0][0] == M and h[j] for h in hit):
                missing.add(f"{M} mixtures, {lines} in pieces")
    if missing:
        raise RuntimeError(f"coverage cases miss kernel paths: {missing}")
    max_err = 0
    plain = {}
    for name, a in {**cases, **extra}.items():
        for compose in ("reference", "correct"):
            got = call_walk(walk.walk_tree, a, compose)
            ref = plain[name, compose] = call_walk(walk.walk_tree_plain, a,
                                                   compose)
            torch.cuda.synchronize()
            err = max(int((g.long() - r.long()).abs().max())
                      for g, r in zip(got, ref))
            max_err = max(max_err, err)
            log(f"walk {name:20s} {compose:9s}: max |kernel - plain| = "
                f"{err}")
            if err != 0:
                raise RuntimeError(f"walk kernel != plain on {name} "
                                   f"({compose})")
    log(f"coverage: all {len(WALK_INSTANCES)} kernel instances checked, "
        f"lines in one piece and in several for 4, 8 and 16 mixtures")
    a = real_big
    flush = l2_flush()

    def flush_then_sync():
        flush()
        torch.cuda.synchronize()

    def flush_then_busy():
        flush()
        busy()

    load_ns = load_latency_ns(1 << 22)
    miss_ns = load_latency_ns(1 << 25, flush=flush)
    bound = walk_bound(a, plain["path-largest", det.compose], det.compose,
                       load_ns, miss_ns)
    run = lambda: call_walk(walk.walk_tree, a, det.compose)  # noqa: E731
    # events around the wrapper call, as earlier versions of this script
    # timed it: the host's time to reach the launch counts
    kernel_ms = cuda_ms(run, reps=50, warmup=5)
    cold_ms = cuda_ms(run, reps=50, warmup=5, pre=flush_then_sync)
    # a device spin ahead of the first event hides the host: the kernel
    device_ms = cuda_ms(run, reps=50, warmup=5, pre=busy)
    device_cold_ms = cuda_ms(run, reps=50, warmup=5, pre=flush_then_busy)
    plain_ms = cuda_ms(lambda: call_walk(walk.walk_tree_plain, a,
                                         det.compose), reps=10)
    log(f"walk at the largest group ({det.compose}), events around the "
        f"call: kernel {kernel_ms:.4f} ms with the L2 warm, {cold_ms:.4f} "
        f"ms with it flushed; plain {plain_ms:.4f} ms")
    log(f"walk at the largest group, the host hidden by a device spin: "
        f"kernel {device_ms:.4f} ms with the L2 warm, {device_cold_ms:.4f} "
        f"ms with it flushed; bound {bound['bound_ms']:.4f} ms by "
        f"{bound['bound_by']} ({bound['bytes']} B needed, "
        f"{bound['flops']} flop)")
    log(f"walk terms of this design: dependent chain depth {bound['depth']}"
        f" x 2 loads at {load_ns:.1f} ns (L2 hit) = "
        f"{bound['latency_ms']:.4f} ms, at {miss_ns:.1f} ns (L2 miss) = "
        f"{bound['latency_cold_ms']:.4f} ms; gathered "
        f"{bound['gathered_bytes']} B = {bound['gathered_ms']:.4f} ms")
    # the DP's W-minor store of tmp at this group: one permuted copy
    src = a["tmp"].contiguous()
    copy_ms = cuda_ms(lambda: src.transpose(-1, -2).contiguous(), reps=10,
                      pre=busy)
    log(f"DP's W-minor copy of tmp at the largest group "
        f"({src.numel() * 4} B): {copy_ms:.4f} ms")
    return dict(max_abs_err=max_err, kernel_ms=kernel_ms, cold_ms=cold_ms,
                device_ms=device_ms, device_cold_ms=device_cold_ms,
                plain_ms=plain_ms, ngroups=ngroups, load_ns=load_ns,
                miss_ns=miss_ns, rootv=a["rootv"][0], **bound)


# ---------------------------------------------------------------- phase 4
def check_candidates(c, nlevels: int, P: int, batch=None) -> None:
    """Shapes (batch, nlevels*K, ...) (batch: BATCH unless given),
    finite valid scores, and per frame valid entries first, sorted by
    score."""
    batch = BATCH if batch is None else batch
    n = nlevels * K
    want = {"score": (batch, n), "valid": (batch, n),
            "component": (batch, n), "level": (batch, n),
            "boxes": (batch, n, P, 4), "loc": (batch, n, P, 3)}
    for f, shape in want.items():
        got = tuple(getattr(c, f).shape)
        if got != shape:
            raise RuntimeError(f"{f} has shape {got}, expected {shape}")
    if not torch.isfinite(c.score[c.valid]).all():
        raise RuntimeError("non-finite score on a valid candidate")
    for b in range(batch):
        v = c.valid[b]
        nv = int(v.sum())
        if not v[:nv].all():
            raise RuntimeError(f"frame {b}: invalid entries before valid")
        s = c.score[b, :nv]
        if not (s[:-1] >= s[1:]).all():
            raise RuntimeError(f"frame {b}: scores not sorted")


def phase_main_path(det, frames, ngroups: int):
    from partsbaseddetector_tpu_torch.models import synthetic
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.ops import walk
    nlevels = len(det.plan_for(IMG).levels)
    P = det.packed.components[0].filterid.shape[0]
    walk.LAUNCHES = 0
    cands = det.detect_batch_raw(frames)
    torch.cuda.synchronize()
    launches = walk.LAUNCHES
    expected = ngroups * len(det.packed.components)
    log(f"main path: {nlevels} levels, {ngroups} dp groups; walk kernel "
        f"launches {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError(f"walk launches {launches} != {expected}")
    check_candidates(cands, nlevels, P)
    log(f"valid candidates per frame (thresh 0.0): "
        f"{cands.valid.sum(1).tolist()}")

    # with no threshold every slot a level can fill is valid: min(K,
    # h*w) per level (the top levels have fewer than K cells, e.g. 4x6)
    m_all = synthetic.person_like()
    m_all.thresh = -1e9
    det_all = Detector(m_all, k_per_level=K, device="cuda")
    all_c = det_all.detect_batch_raw(frames)
    check_candidates(all_c, nlevels, P)
    levels = det.plan_for(IMG).levels
    want = torch.tensor([min(K, lv.featsize[0] * lv.featsize[1])
                         for lv in levels], device=frames.device)
    per_level = torch.zeros((BATCH, nlevels), dtype=torch.long,
                            device=frames.device)
    per_level.scatter_add_(1, all_c.level.long(), all_c.valid.long())
    if not bool((per_level == want).all()):
        raise RuntimeError("thresh -1e9: a level's valid count is not "
                           "min(K, h*w)")
    log(f"thresh -1e9: every fillable slot valid, "
        f"{int(want.sum())} of {nlevels * K} per frame")

    # the card against the port on the CPU, small input: the
    # cross-engine contract of tests/test_native_parity.py
    g = torch.Generator().manual_seed(7)
    small = torch.randint(0, 256, (120, 160, 3), generator=g,
                          dtype=torch.uint8)
    m8 = synthetic.person_like()
    m8.thresh = -1e9
    det8 = Detector(m8, k_per_level=8, device="cuda")
    on_card = det8.detect_raw(small)
    on_cpu = Detector(m8, k_per_level=8, device="cpu").detect_raw(small)
    contract_vs_cpu(on_card, on_cpu, 8, det8.plan_for(small.shape).levels)
    return cands, launches, all_c


def contract_vs_cpu(a, b, k: int, levels,
                    what: str = "card vs CPU at 120x160",
                    same_order: bool = True) -> None:
    """The cross-engine contract of tests/test_native_parity.py between
    two frames' Candidates: per plan level (``levels``, the PyramidPlan
    levels that hold roots), the root keys (x, y) of a's top-k inside
    the level's true feature size found in b's, against min(k, h*w) of
    that size from the plan, >= 0.9; PCK(1 cell) >= 0.99 and exact
    parts >= 0.9 over the matched candidates, median score difference
    < 1e-4.  same_order: the level fields must also be equal slot for
    slot (two devices of one engine sort alike; two engines may swap
    near-equal scores)."""
    la, lb = a.loc.cpu().numpy(), b.loc.cpu().numpy()
    sa, sb = a.score.cpu().numpy(), b.score.cpu().numpy()
    lev, levb = a.level.cpu().numpy(), b.level.cpu().numpy()
    if same_order and not np.array_equal(lev, levb):
        raise RuntimeError(f"{what}: level fields differ")
    total = matched = exact = close = nparts = 0
    diffs = []

    def root_keys(loc, lv, th, tw):
        return {(int(loc[i, 0, 0]), int(loc[i, 0, 1])): i
                for i in np.nonzero(lv)[0]
                if loc[i, 0, 0] < tw and loc[i, 0, 1] < th}

    for lvl in levels:
        th, tw = lvl.featsize
        ga = root_keys(la, lev == lvl.index, th, tw)
        gb = root_keys(lb, levb == lvl.index, th, tw)
        total += min(k, th * tw)
        for key in set(ga) & set(gb):
            i, j = ga[key], gb[key]
            matched += 1
            # equal scores (both -inf on a level's unfilled slots) differ
            # by 0
            diffs.append(0.0 if sa[i] == sb[j] else
                         abs(float(sa[i]) - float(sb[j])))
            dd = np.abs(la[i, :, :2] - lb[j, :, :2])
            nparts += la.shape[1]
            exact += int(((dd == 0).all(1)
                          & (la[i, :, 2] == lb[j, :, 2])).sum())
            close += int((dd.max(1) <= 1).sum())
    med = float(np.median(diffs)) if diffs else float("inf")
    log(f"{what}: root keys {matched}/{total}, PCK "
        f"{close}/{nparts}, exact parts {exact}/{nparts}, median score "
        f"diff {med:.3g}")
    if not (matched >= 0.9 * total and close >= 0.99 * nparts
            and exact >= 0.9 * nparts and med < 1e-4):
        raise RuntimeError(f"{what}: contract not met")


# ---------------------------------------------------------------- phase 5
def phase_plain_walk_end_to_end(model, frames, cands) -> None:
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    det_plain = Detector(model, k_per_level=K, device="cuda",
                         walk_impl="torch")
    plain = det_plain.detect_batch_raw(frames)
    for f in ("score", "valid", "component", "level", "boxes", "loc"):
        if not torch.equal(getattr(cands, f), getattr(plain, f)):
            raise RuntimeError(f"kernel-walk and plain-walk Candidates "
                               f"differ in {f}")
    log("end to end: kernel-walk Candidates == plain-walk Candidates "
        "(all fields)")


# ---------------------------------------------------------------- phase 6
def phase_times(det, frames, smi: str, what: str = "") -> dict:
    """ms/frame and frames/s at B=8 (median of 7 batches, host clock to
    a synchronize), the device timeline (CUDA events around the batch),
    per-stage device ms (utils/profiling.CudaStageTimer at the
    detector's stage hook), peak memory and one batch under
    torch.profiler (utils/profiling.device_busy).  what: a prefix for
    the printed lines."""
    from partsbaseddetector_tpu_torch.utils.profiling import CudaStageTimer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        det.detect_batch_raw(frames)
    torch.cuda.synchronize()
    wall, dev = [], []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        det.detect_batch_raw(frames)
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    ms_batch = statistics.median(wall)
    log(f"{what}B={BATCH}: {ms_batch / BATCH:.3f} ms/frame, "
        f"{1e3 * BATCH / ms_batch:.2f} frames/s (median of 7 batches, "
        f"host clock to synchronize; batch ms {sorted(wall)}) "
        f"[{smi}]")
    log(f"{what}B={BATCH}: device-timeline ms/batch (CUDA events) median "
        f"{statistics.median(dev):.3f}")
    timer = CudaStageTimer()
    det.detect_batch_raw(frames, stage=timer.stage)
    stages = timer.totals_ms()
    log(f"{what}per-stage ms per batch (CUDA events at stage boundaries, "
        "launch gaps included): " + ", ".join(f"{k} {v:.3f}"
                                              for k, v in stages.items()))
    log(f"{what}peak device memory (max_memory_allocated): {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    trace = phase_device_trace(det, frames, what)
    return dict(ms_frame=ms_batch / BATCH, stages=stages, peak=peak,
                trace=trace)


def phase_device_trace(det, frames, what: str = ""):
    """One B=8 batch under torch.profiler: the share of the batch's
    device span in which some kernel runs, and the kernels that take
    the most device time.  The profiler adds host work per launch, so
    the idle share it shows is an upper bound."""
    from partsbaseddetector_tpu_torch.utils.profiling import (device_busy,
                                                              device_trace)
    torch.cuda.synchronize()
    with device_trace() as prof:
        det.detect_batch_raw(frames)
        torch.cuda.synchronize()
    got = device_busy(prof.events())
    if got is None:
        log(f"{what}device trace: not measured (the profiler recorded no "
            "device kernels)")
        return None
    log(f"{what}device trace (torch.profiler, one B={BATCH} batch): "
        f"{got['kernels']} device kernels, busy {got['busy_ms']:.3f} ms of "
        f"a {got['span_ms']:.3f} ms span, idle share "
        f"{got['idle_share']:.3f}")
    for name, ms, n in got["top"]:
        log(f"  {ms:9.3f} ms  {n:6d}x  {name[:90]}")
    return got


# ---------------------------------------------------------------- phase 7
# The slice-3 paths.  Each one that ends in the walk kernel is driven
# with the kernel's launch count set to 0 just before and read just
# after; comparison runs (plain walk, CPU) are outside those windows.

#: the small frame of the card-vs-CPU checks
SMALL = (120, 160)
FIELDS = ("score", "valid", "component", "level", "boxes", "loc")


def small_frame() -> torch.Tensor:
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, 256, SMALL + (3,), generator=g,
                         dtype=torch.uint8)


def counted(fn):
    """fn() with the walk kernel's launch count set to 0 just before and
    read just after; returns (result, launches)."""
    from partsbaseddetector_tpu_torch.ops import walk
    torch.cuda.synchronize()
    walk.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, walk.LAUNCHES


def expect_launches(what: str, got: int, expected: int) -> None:
    log(f"{what}: walk kernel launches {got} (expected {expected})")
    if got != expected:
        raise RuntimeError(f"{what}: walk launches {got} != {expected}")


def wall_ms(fn, reps: int = 3):
    """Median host ms of fn() ending in a synchronize, over reps runs
    after a warm one; the peak device memory of those runs, and the
    memory already allocated when they started."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated(), base


def report(what: str, fn, frames: int, reps: int = 3) -> None:
    ms, peak, base = wall_ms(fn, reps)
    log(f"{what}: {ms / frames:.3f} ms/frame ({ms:.3f} ms a call, median "
        f"of {reps}, host clock to synchronize); peak device memory {peak} "
        f"B ({peak / 2**30:.2f} GiB; {base} B held before the calls)")


def equal_candidates(a, b, what: str) -> None:
    for f in FIELDS:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise RuntimeError(f"{what}: Candidates differ in {f}")
    log(f"{what}: Candidates equal (all fields)")


def expected_launches(det, imshape) -> int:
    from partsbaseddetector_tpu_torch.infer.detector import _dp_groups
    plan = det.plan_for(imshape)
    return (sum(len(_dp_groups(b, det.dp_split)) for b in plan.buckets)
            * len(det.packed.components))


def aliased_person():
    """person_like() with two kinds of filter sharing within its one
    component, those of tests/test_aliasing.py: in every non-root part,
    mixtures 1-3 take mixture 0's filter id; then in the 8 parent-child
    pairs of parts 1-8, the child's mixture 0 takes its parent's
    mixture-0 id (ids as person_like() made them)."""
    from partsbaseddetector_tpu_torch.models import synthetic
    m = synthetic.person_like()
    parts = m.components[0].parts
    own = [p.filterid[0] for p in parts]
    for part in parts[1:]:
        for j in range(1, part.nmixtures):
            part.filterid[j] = part.filterid[0]
    for q in range(1, 9):
        parts[q].filterid[0] = own[parts[q].parentid]
    m.validate()
    return m


def phase_aliased(frames) -> int:
    """(a) The aliased person-26 at B=8."""
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.ops import walk
    m = aliased_person()
    m.thresh = 0.0
    det = Detector(m, k_per_level=K, device="cuda")
    if not det.packed.components[0].aliased:
        raise RuntimeError("the aliased fixture does not pack as aliased")
    cands, n = counted(lambda: det.detect_batch_raw(frames))
    expect_launches(f"aliased person-26, B={BATCH}", n,
                    expected_launches(det, IMG))
    P = det.packed.components[0].filterid.shape[0]
    check_candidates(cands, len(det.plan_for(IMG).levels), P)
    plain = Detector(m, k_per_level=K, device="cuda", walk_impl="torch")
    equal_candidates(cands, plain.detect_batch_raw(frames),
                     "aliased: kernel walk vs plain walk, end to end")
    a = walk_inputs_from_path(det, frames, 0)
    for compose in ("reference", "correct"):
        got = call_walk(walk.walk_tree, a, compose)
        ref = call_walk(walk.walk_tree_plain, a, compose)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise RuntimeError(f"aliased: walk kernel != plain ({compose})")
    log(f"aliased: walk kernel == plain walk (X, Y, Mm bit-equal) on the "
        f"aliased DP's outputs at the largest group "
        f"{tuple(a['scores'].shape)}, both compose modes")
    m8 = aliased_person()
    m8.thresh = -1e9
    stages34_card_vs_cpu(m8)
    report(f"aliased person-26, B={BATCH}",
           lambda: det.detect_batch_raw(frames), BATCH)
    return n


def stages34_card_vs_cpu(model) -> None:
    """Stages 3-4 (DP, seeds, walk, sort) on the card and on the CPU
    from the same stage-2 responses, computed on the CPU at 120x160:
    Candidates equal.  The aliased fixture needs this in place of the
    cross-engine contract: each part's four mixtures share one
    accumulation buffer, so the buffers sum four messages at every
    depth and scores grow about 4^depth (to about 5e6 at 120x160, where
    float32 steps by 0.5).  The card's own stage-1-2 responses are held
    to the CPU's: max |diff| inside the true sizes over max |CPU| at
    most 1e-5, the rounding of 5x5x32-tap float32 sums summed in
    another order (800 taps x 2^-24 = 4.8e-5 at worst); the gap between
    the i-th best scores of stages 3-4 run from each device's own
    responses is logged beside it: a rounding gap of that size in the
    responses moves these scores by a few units."""
    from partsbaseddetector_tpu_torch.infer.detector import (
        Detector, dp_backtrack_bucket, pyramid_pdfs)
    from partsbaseddetector_tpu_torch.ops import argmax
    dets = {d: Detector(model, k_per_level=8, device=d)
            for d in ("cuda", "cpu")}
    plan = dets["cpu"].plan_for(SMALL)
    frame = small_frame()[None]
    per_bucket = pyramid_pdfs(frame, dets["cpu"].packed, plan)
    own = pyramid_pdfs(frame.cuda(), dets["cuda"].packed, plan)
    rel = 0.0
    for (bucket, ref, _, _), (_, got, _, _) in zip(per_bucket, own):
        got = got.cpu()
        diff = scale = 0.0
        for j, lv in enumerate(bucket.levels):
            th, tw = lv.featsize
            r = ref[:, j, :th, :tw]
            diff = max(diff, float((got[:, j, :th, :tw] - r).abs().max()))
            scale = max(scale, float(r.abs().max()))
        rel = max(rel, diff / scale)

    def stages34(det, responses):
        cands = []
        for bucket, pdfs, ts, sc in responses:
            d = det.device
            cands.extend(dp_backtrack_bucket(
                bucket, pdfs.to(d), ts.to(d), sc.to(d), det.packed, 8,
                det.compose, det.dp_split, det.walk_impl))
        return argmax.sort_candidates(argmax.concat_candidates(cands))

    out = {d: stages34(det, per_bucket) for d, det in dets.items()}
    equal_candidates(out["cuda"].map(lambda x: x.cpu()), out["cpu"],
                     f"aliased: stages 3-4 card vs CPU on the same "
                     f"responses at 120x160 (scores up to "
                     f"{float(out['cpu'].score.max()):.4g})")
    sa = stages34(dets["cuda"], own).score.cpu()
    sb = out["cpu"].score
    fin = torch.isfinite(sa) & torch.isfinite(sb)
    log(f"aliased: stage-1-2 responses card vs CPU at 120x160, max |diff| "
        f"/ max |CPU| {rel:.3g} (limit 1e-5); from each device's own "
        f"responses, the i-th best scores differ by up to "
        f"{float((sa - sb)[fin].abs().max()):.4g}")
    if not rel <= 1e-5:
        raise RuntimeError("aliased: card responses differ from the CPU's "
                           "beyond 1e-5 relative")


def phase_depth(det, frames, cands) -> int:
    """(b) Depth pruning at B=8, on the main path's model and frames."""
    from partsbaseddetector_tpu_torch.infer.detector import (DepthPrune,
                                                             Detector)
    ddet = Detector(det.model, k_per_level=K, device="cuda",
                    depth_prune=DepthPrune(part_width_m=0.4, fx=525.0,
                                           tol=0.5))
    g = torch.Generator(device="cuda").manual_seed(3)
    # 0.5-8 m, a tenth unknown (0)
    depths = (torch.rand((BATCH,) + IMG, generator=g, device="cuda") * 7.5
              + 0.5)
    depths[torch.rand(depths.shape, generator=g, device="cuda") < 0.1] = 0.0
    pruned, n = counted(lambda: ddet.detect_batch_raw(frames,
                                                      depths=depths))
    expect_launches(f"depth, B={BATCH}", n, expected_launches(ddet, IMG))
    P = det.packed.components[0].filterid.shape[0]
    check_candidates(pruned, len(det.plan_for(IMG).levels), P)
    log(f"depth: valid candidates per frame {pruned.valid.sum(1).tolist()}"
        f" (without depth {cands.valid.sum(1).tolist()})")
    zero = ddet.detect_batch_raw(frames, depths=torch.zeros_like(depths))
    equal_candidates(zero, cands, "depth: all-zero depths vs no depth map")
    far = ddet.detect_batch_raw(frames, depths=torch.full_like(depths, 1e4))
    if far.valid.any():
        raise RuntimeError("depth: a depth implausible at every level "
                           "left a valid candidate")
    log("depth: a constant 1e4 m depth leaves no valid candidate")
    report(f"depth, B={BATCH}", lambda: ddet.detect_batch_raw(frames,
                                                      depths=depths), BATCH)
    return n


def phase_masked(det, frames) -> int:
    """(c) The masked latent search on one frame, seeded masks."""
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    plan = det.plan_for(IMG)
    P = det.packed.components[0].filterid.shape[0]
    g = torch.Generator(device="cuda").manual_seed(4)
    masks = [torch.rand((len(b.levels), P) + b.feat_pad, generator=g,
                        device="cuda") < 0.7 for b in plan.buckets]
    got, n = counted(lambda: det.detect_masked_raw(frames[0], masks))
    expect_launches("masked, one frame", n, expected_launches(det, IMG))
    check_candidates(got.map(lambda x: x[None]), len(plan.levels), P, 1)
    plain = Detector(det.model, k_per_level=K, device="cuda",
                     walk_impl="torch").detect_masked_raw(frames[0], masks)
    equal_candidates(got, plain, "masked: kernel walk vs plain walk")
    report("masked, one frame", lambda: det.detect_masked_raw(frames[0],
                                                              masks), 1)
    return n


def phase_fft(frames, cands) -> int:
    """(d) The FFT conv engine at B=8, held to the spatial engine."""
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.models import synthetic
    m = synthetic.person_like()
    m.thresh = 0.0
    fdet = Detector(m, k_per_level=K, conv_engine="fft", device="cuda")
    got, n = counted(lambda: fdet.detect_batch_raw(frames))
    expect_launches(f"fft, B={BATCH}", n, expected_launches(fdet, IMG))
    P = fdet.packed.components[0].filterid.shape[0]
    check_candidates(got, len(fdet.plan_for(IMG).levels), P)
    for b in range(BATCH):
        contract_vs_cpu(got.map(lambda x: x[b]), cands.map(lambda x: x[b]),
                        K, fdet.plan_for(IMG).levels,
                        f"fft vs spatial engine, frame {b}",
                        same_order=False)
    m8 = synthetic.person_like()
    m8.thresh = -1e9
    small = small_frame()
    fdet8 = Detector(m8, k_per_level=8, conv_engine="fft", device="cuda")
    contract_vs_cpu(
        fdet8.detect_raw(small),
        Detector(m8, k_per_level=8, conv_engine="fft",
                 device="cpu").detect_raw(small), 8,
        fdet8.plan_for(SMALL).levels, "fft: card vs CPU at 120x160")
    report(f"fft, B={BATCH}", lambda: fdet.detect_batch_raw(frames), BATCH)
    return n


def phase_features() -> None:
    """(e) pyramid_features, card against CPU at 120x160."""
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.models import synthetic
    m = synthetic.person_like()
    small = small_frame()
    a = Detector(m, device="cuda").pyramid_features(small)
    b = Detector(m, device="cpu").pyramid_features(small)
    if [x.shape for x in a] != [y.shape for y in b]:
        raise RuntimeError("pyramid_features: shapes differ")
    err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    log(f"pyramid_features: {len(a)} levels, card vs CPU at 120x160 max "
        f"|diff| {err:.3g} (atol 1e-4)")
    if not err <= 1e-4:
        raise RuntimeError("pyramid_features: card vs CPU beyond 1e-4")


def multires_person():
    """person_like() with the root one octave coarser than its 25 other
    parts: the root's children take anchor ds = 1, their descendants
    ds = 0 (the root-plus-parts-at-2x layout of Felzenszwalb et al.,
    PAMI 2010)."""
    from partsbaseddetector_tpu_torch.models import synthetic
    parents = [p.parentid for p in synthetic.person_like().components[0]
               .parts]
    m = synthetic.person_like(part_ds=[1 if q == 0 else 0
                                       for q in parents])
    if m.part_scales(0) != [0] + [1] * 25:
        raise RuntimeError(f"multires fixture scales {m.part_scales(0)}")
    return m


def phase_multires(frames) -> None:
    """(f) MultiResDetector on one 640x480 frame."""
    from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
    m = multires_person()
    m.thresh = -1e9
    mdet = MultiResDetector(m, k_per_level=K, device="cuda")
    c = mdet.detect_raw(frames[0])
    plan = mdet.plan_for(IMG)
    nroot = sum(len(b.levels) for b in plan.buckets[m.max_scale():])
    check_candidates(c.map(lambda x: x[None]), nroot, m.components[0].nparts,
                     1)
    log(f"multires: {nroot} root levels x K={K} slots, "
        f"{int(c.valid.sum())} valid; sorted, valid first")
    m8 = multires_person()
    m8.thresh = -1e9
    small = small_frame()
    mdet8 = MultiResDetector(m8, k_per_level=8, device="cuda")
    roots = [lv for b in mdet8.plan_for(SMALL).buckets[m8.max_scale():]
             for lv in b.levels]
    contract_vs_cpu(
        mdet8.detect_raw(small),
        MultiResDetector(m8, k_per_level=8, device="cpu").detect_raw(small),
        8, roots, "multires: card vs CPU at 120x160")
    report("multires, one frame", lambda: mdet.detect_raw(frames[0]), 1)


def phase_nms(all_c, rootv) -> None:
    """(g) The three NMS functions on one frame of the main path's
    thresh -1e9 Candidates, card against CPU."""
    from partsbaseddetector_tpu_torch.ops import nms
    c = all_c.map(lambda x: x[0])
    host = c.map(lambda x: x.cpu())
    for name, fn in (("paint_nms", lambda x: nms.paint_nms(x, IMG)),
                     ("part_nms", nms.part_nms)):
        got, ref = fn(c), fn(host)
        if not torch.equal(got.valid.cpu(), ref.valid):
            raise RuntimeError(f"{name}: card != CPU")
        log(f"{name} on {c.capacity} candidates ({int(c.valid.sum())} "
            f"valid): {int(got.valid.sum())} kept, card == CPU (valid)")
        report(name, lambda: fn(c), 1)
    got, ref = nms.grid_nms(rootv, 3), nms.grid_nms(rootv.cpu(), 3)
    if not torch.equal(got.cpu(), ref):
        raise RuntimeError("grid_nms: card != CPU")
    log(f"grid_nms (sz 3) on a {tuple(rootv.shape)} root score map: "
        f"{int(got.sum())} maxima, card == CPU")
    report("grid_nms", lambda: nms.grid_nms(rootv, 3), 1)


# ---------------------------------------------------------------- phase 8
# The serving path: a person-26 model file served by the port's ROS node
# and StreamingDetector.  Each path that ends in the walk kernel is
# driven with the launch count set to 0 just before and read just after.

#: frames of the serving fixture, and its micro-batch
NSERVE = 16
SERVE_BATCH = 8
#: the topics the fixture subscribes to; the overlay
#: (candidates_rect_color) needs PIL and stays unsubscribed
SERVE_TOPICS = ("mask", "bounding_box", "part_centers", "object_poses")
#: the StreamingDetector sinks behind those topics
SERVE_SINKS = ("mask", "boxes3d", "part_centers", "poses")


class FakePublisher:
    """A transport's publisher: keeps what it is given."""

    def __init__(self):
        self.subscribers = 0
        self.published = []

    def publish(self, msg):
        self.published.append(msg)

    def get_num_connections(self):
        return self.subscribers


class FakeTransport:
    """The duck-typed transport the ROS node takes
    (tests/test_frontends.py:24-45)."""

    def __init__(self):
        self.pubs = {}

    def advertise(self, topic, kind):
        self.pubs[topic] = FakePublisher()
        return self.pubs[topic]

    def pub(self, suffix):
        return next(p for t, p in self.pubs.items() if t.endswith(suffix))


def kinect_camera(shape):
    """Kinect-like intrinsics (fx = fy = 525, principal point at the
    center of 640x480), scaled to an image shape."""
    from partsbaseddetector_tpu_torch.post.depth import CameraModel
    s = shape[1] / 640.0
    return CameraModel(fx=525.0 * s, fy=525.0 * s, cx=(shape[1] - 1) / 2,
                       cy=(shape[0] - 1) / 2)


def serve_scene(n: int, shape, seed: int):
    """n seeded frames: rgb uint8 (H, W, 3); uint16 depth in mm, a plane
    at about 2 m (1.8 m at the top row, 0.5 mm farther a row) with a box
    face nearer (1.2-1.6 m, 0.5 mm farther a column; a quarter to a
    half of the frame on each side, placed at random), so that 3-D
    boxes have depth; and the organized (H, W, 3) cloud in meters
    back-projected from it with kinect_camera."""
    H, W = shape
    cam = kinect_camera(shape)
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    rgbs, depths, clouds = [], [], []
    for _ in range(n):
        rgbs.append(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        d = (1800 + ys // 2).astype(np.uint16)
        bh, bw = rng.integers(H // 4, H // 2), rng.integers(W // 4, W // 2)
        y0, x0 = rng.integers(0, H - bh), rng.integers(0, W - bw)
        d[y0:y0 + bh, x0:x0 + bw] = rng.integers(1200, 1600) \
            + xs[y0:y0 + bh, x0:x0 + bw] // 2
        z = d / 1000.0
        depths.append(d)
        clouds.append(np.stack([(xs - cam.cx) / cam.fx * z,
                                (ys - cam.cy) / cam.fy * z, z], -1))
    return rgbs, depths, clouds


def subscribe(sd):
    """The StreamingDetector sinks of the subscribed topics."""
    for sink in SERVE_SINKS:
        sd.on(sink, lambda _: None)
    return sd


def same_detections(a, b, what: str, score_tol: float) -> None:
    """Per detection: level, component, locations and part boxes equal,
    scores within score_tol."""
    if len(a) != len(b):
        raise RuntimeError(f"{what}: {len(a)} vs {len(b)} detections")
    for i, (x, y) in enumerate(zip(a, b)):
        if ((x.level, x.component) != (y.level, y.component)
                or not np.array_equal(x.locations, y.locations)
                or not np.array_equal(x.parts, y.parts)
                or not abs(x.score - y.score) <= score_tol):
            raise RuntimeError(f"{what}: detection {i} differs")


def agreeing(a, b) -> int:
    """How many leading detections of two lists agree in level,
    component and locations."""
    n = 0
    for x, y in zip(a, b):
        if ((x.level, x.component) != (y.level, y.component)
                or not np.array_equal(x.locations, y.locations)):
            break
        n += 1
    return n


def same_3d(a, b, n: int, what: str, atol: float) -> float:
    """boxes3d, part_centers and poses of two FrameResults' first n
    detections within atol (0: equal); returns the largest gap."""
    import dataclasses
    gap = 0.0
    for i in range(n):
        pa, pb = a.poses[i], b.poses[i]
        if (pa is None) != (pb is None):
            raise RuntimeError(f"{what}: pose {i} present in one only")
        pairs = [(dataclasses.astuple(a.boxes3d[i]),
                  dataclasses.astuple(b.boxes3d[i])),
                 (a.part_centers[i], b.part_centers[i])]
        if pa is not None:
            pairs += [(pa.position, pb.position),
                      (pa.orientation, pb.orientation)]
        for x, y in pairs:
            x, y = np.asarray(x, float), np.asarray(y, float)
            if x.shape != y.shape:
                raise RuntimeError(f"{what}: shapes differ at {i}")
            both = np.isnan(x) & np.isnan(y)
            d = np.where(both, 0.0, np.abs(x - y))
            gap = max(gap, float(d.max(initial=0.0)))
    if not gap <= atol:
        raise RuntimeError(f"{what}: 3-D outputs differ by {gap:.3g} "
                           f"(limit {atol})")
    return gap


def same_results(a, b, what: str) -> None:
    """Two lists of FrameResults equal: detections (scores too), masks,
    boxes3d, part_centers and poses."""
    if len(a) != len(b):
        raise RuntimeError(f"{what}: {len(a)} vs {len(b)} frames")
    for j, (x, y) in enumerate(zip(a, b)):
        same_detections(x.detections, y.detections, f"{what}, frame {j}",
                        0.0)
        if not np.array_equal(x.mask, y.mask):
            raise RuntimeError(f"{what}, frame {j}: masks differ")
        same_3d(x, y, len(x.detections), f"{what}, frame {j}", 0.0)


def post_split(cands_b, rgbs, depths_m, clouds, cam, n_clusters: int):
    """Host ms per frame of each post stage, run by hand on one batch's
    Candidates as StreamingDetector._postprocess runs them: the paint
    NMS on the card (to a synchronize), the fetch of the detections,
    compute_bounding_boxes, poses, the mask and the four messages, and
    (on the first n_clusters frames) plane removal + clustering."""
    from partsbaseddetector_tpu_torch.frontends import messages as msgs
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.infer.stream import detections_mask
    from partsbaseddetector_tpu_torch.ops.nms import paint_nms
    from partsbaseddetector_tpu_torch.post.cloud import (
        cluster_objects, compute_bounding_boxes,
        organized_multiplane_segmentation)
    from partsbaseddetector_tpu_torch.post.poses import \
        poses_from_part_centers
    acc: dict = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        acc.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    header = msgs.Header()
    for i in range(len(rgbs)):
        c = cands_b.map(lambda x: x[i])
        kept = timed("nms", lambda: (paint_nms(c, IMG, 0.1),
                                     torch.cuda.synchronize())[0])
        dets = timed("fetch", lambda: Detector.candidates_to_detections(
            kept, 32))
        boxes, centers = timed("boxes3d", lambda: compute_bounding_boxes(
            dets, IMG, depths_m[i], cam))
        timed("poses", lambda: poses_from_part_centers(centers))
        timed("messages", lambda: (
            msgs.message_mask(detections_mask(IMG, dets), rgbs[i], header),
            msgs.message_bounding_box(boxes, header, "person"),
            msgs.message_part_centers(centers, header, "person"),
            msgs.message_poses(header, centers)))
        if i < n_clusters:
            timed("clusters", lambda: cluster_objects(
                organized_multiplane_segmentation(clouds[i]), boxes))
    return {k: statistics.mean(v) for k, v in acc.items()}


def phase_serving(smi: str) -> dict:
    """8. The serving path on the card; returns the walk launches per
    dispatch of the ROS callback (B=1) and of stream (B=8)."""
    import os
    import tempfile
    from partsbaseddetector_tpu_torch.frontends.ros_node import \
        PartsBasedDetectorNode
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
    from partsbaseddetector_tpu_torch.models import (save_filestorage,
                                                     synthetic)
    from partsbaseddetector_tpu_torch.ops.nms import paint_nms

    # thresh -1e9: every frame carries detections into the NMS and the
    # 3-D stages (at 0.0 the random weights may give none)
    m = synthetic.person_like()
    m.thresh = -1e9
    rgbs, depths_mm, clouds = serve_scene(NSERVE, IMG, seed=8)
    depths = [d.astype(np.float32) / 1000.0 for d in depths_mm]
    cam = kinect_camera(IMG)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "person26.xml")
        t0 = time.perf_counter()
        save_filestorage(path, m)
        t1 = time.perf_counter()
        transport = FakeTransport()
        node = PartsBasedDetectorNode.from_params(
            transport, {"model": path, "device": "cuda"}, camera=cam)
        t2 = time.perf_counter()
        plain_transport = FakeTransport()
        plain_node = PartsBasedDetectorNode.from_params(
            plain_transport, {"model": path, "device": "cuda",
                              "walk_impl": "torch"}, camera=cam)
        size = os.path.getsize(path)
    log(f"serve: person-26 model file {size} B written in "
        f"{(t1 - t0) * 1e3:.1f} ms, read and the node built in "
        f"{(t2 - t1) * 1e3:.1f} ms (from_params, device cuda)")
    det = node.stream.detector
    if det.walk_impl != "cuda" or plain_node.stream.detector.walk_impl \
            != "torch":
        raise RuntimeError("serve: the nodes' walks are not cuda / torch")
    expected = expected_launches(det, IMG)
    for topic in SERVE_TOPICS:
        transport.pub(topic).subscribers = 1
        plain_transport.pub(topic).subscribers = 1

    # (1) launches: one ROS callback (B=1), then stream at B=8
    node.depth_image_callback(rgbs[0], depths_mm[0], clouds[0])   # warm
    _, n1 = counted(lambda: node.depth_image_callback(
        rgbs[1], depths_mm[1], clouds[1]))
    expect_launches("serve: ROS depth_image_callback, B=1", n1, expected)
    for i in range(2, NSERVE):
        node.depth_image_callback(rgbs[i], depths_mm[i], clouds[i])
    published = {t.rsplit("/", 1)[1]: len(p.published)
                 for t, p in transport.pubs.items()}
    log(f"serve: messages published per topic over {NSERVE} callbacks: "
        f"{json.dumps(published)}")
    if any(published[t] < NSERVE for t in SERVE_TOPICS) or \
            published["candidates_rect_color"] or published["cleaned_cloud"]:
        raise RuntimeError(f"serve: publishing not gated by subscribers: "
                           f"{published}")

    sd = subscribe(StreamingDetector(det, camera=cam))
    ndisp = NSERVE // SERVE_BATCH
    streamed, n8 = counted(lambda: list(sd.stream(
        rgbs, batch=SERVE_BATCH, depths=depths, clouds=clouds)))
    expect_launches(f"serve: stream, {NSERVE} frames at B={SERVE_BATCH}, "
                    f"per dispatch", n8 / ndisp, expected)
    ndet = [len(r.detections) for r in streamed]
    log(f"serve: detections per frame after paint NMS (0.1, at most 32): "
        f"{ndet}")
    if len(streamed) != NSERVE or min(ndet) == 0:
        raise RuntimeError("serve: a frame without detections")

    # (2) stream == process_batch on each group of 8
    groups = [slice(g, g + SERVE_BATCH) for g in range(0, NSERVE,
                                                        SERVE_BATCH)]
    batched = [r for g in groups for r in sd.process_batch(
        np.stack(rgbs[g]), np.stack(depths[g]), np.stack(clouds[g]))]
    for j, (a, b) in enumerate(zip(streamed, batched)):
        same_detections(a.detections, b.detections,
                        f"serve: stream vs process_batch, frame {j}", 5e-4)
    log("serve: stream == process_batch on every frame (level, component, "
        "locations exact, score within 5e-4)")

    # (3) stream == the direct path: detect, paint NMS, detections
    raw = []
    for g in groups:
        c = det.detect_batch_raw(np.stack(rgbs[g]))
        raw.append(c)
        for i in range(SERVE_BATCH):
            direct = Detector.candidates_to_detections(
                paint_nms(c.map(lambda x: x[i]), IMG, 0.1), 32)
            j = g.start + i
            same_detections(streamed[j].detections, direct,
                            f"serve: stream vs direct path, frame {j}", 0.0)
    log("serve: stream == detect_batch_raw -> paint_nms(0.1) -> "
        "candidates_to_detections(32) on every frame (exact)")

    # (4) kernel walk == plain walk through the whole serving path: the
    # two nodes' callbacks, and stream on their detectors
    same_results(
        [node.depth_image_callback(rgbs[i], depths_mm[i], clouds[i])
         for i in (0, 1)],
        [plain_node.depth_image_callback(rgbs[i], depths_mm[i], clouds[i])
         for i in (0, 1)], "serve: kernel-walk vs plain-walk callbacks")
    sd_plain = subscribe(StreamingDetector(plain_node.stream.detector,
                                           camera=cam))
    same_results(streamed, list(sd_plain.stream(
        rgbs, batch=SERVE_BATCH, depths=depths, clouds=clouds)),
        "serve: kernel-walk vs plain-walk stream")
    log("serve: kernel-walk == plain-walk FrameResults (detections, mask, "
        "boxes3d, part_centers, poses): 2 ROS callbacks and all "
        f"{NSERVE} frames of stream")

    # (5) card vs CPU at 120x160 through StreamingDetector
    serve_card_vs_cpu()

    # (6) clusters: the cleaned_cloud topic, planes removed, 2 frames;
    # a prebuilt detector and no name
    ct = FakeTransport()
    cnode = PartsBasedDetectorNode(det, ct, camera=cam, remove_planes=True)
    ct.pub("cleaned_cloud").subscribers = 1
    t0 = time.perf_counter()
    for i in range(2):
        res = cnode.depth_image_callback(rgbs[i], depths_mm[i], clouds[i])
    ms = (time.perf_counter() - t0) * 1e3 / 2
    pts = [len(c) for c in res.clusters]
    nclouds = len(ct.pub("cleaned_cloud").published)
    log(f"serve: cleaned_cloud (remove_planes, node named {cnode.name!r} "
        f"from its prebuilt detector): {nclouds} clouds published, cluster "
        f"sizes of the 2nd frame {pts}; {ms:.1f} ms a callback")
    if nclouds != 2:
        raise RuntimeError("serve: cleaned_cloud not published per frame")

    # the post stage, split by hand on the first batch
    split = post_split(raw[0], rgbs[:SERVE_BATCH], depths, clouds, cam, 2)
    log("serve: post stage, host ms per frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + " (clusters: 2 frames)")

    # times: median of 3 after a warm call, host clock to a synchronize,
    # and the peak device memory of those calls
    first = slice(0, SERVE_BATCH)
    runs = (
        ("process (B=1)", 1,
         lambda: sd.process(rgbs[0], depths[0], clouds[0])),
        (f"process_batch (B={SERVE_BATCH})", SERVE_BATCH,
         lambda: sd.process_batch(np.stack(rgbs[first]),
                                  np.stack(depths[first]),
                                  np.stack(clouds[first]))),
        (f"stream ({NSERVE} frames, batch {SERVE_BATCH})", NSERVE,
         lambda: list(sd.stream(rgbs, batch=SERVE_BATCH, depths=depths,
                                clouds=clouds))))
    for what, nframes, fn in runs:
        ms, peak, base = wall_ms(fn)
        log(f"serve: {what} {ms / nframes:.3f} ms/frame, "
            f"{1e3 * nframes / ms:.2f} frames/s (median of 3 after a warm "
            f"call, host clock to synchronize); peak device memory {peak} "
            f"B ({peak / 2**30:.2f} GiB; {base} B held before the calls) "
            f"[{smi}]")
    return {"serve": n8 // ndisp, "serve_single": n1}


def serve_card_vs_cpu() -> None:
    """(5) person-26 at 120x160 through a StreamingDetector on the card
    and one on the CPU: the raw Candidates under the cross-engine
    contract, then, where the detections agree, equal masks and
    boxes3d, part_centers and poses within 1e-5.  The paint NMS keeps
    overlaps up to 0.9 here: a person-26 hull spans most of a 120x160
    frame, so the node's 0.1 keeps one detection there (0.9: five)."""
    from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
    from partsbaseddetector_tpu_torch.models import synthetic
    m = synthetic.person_like()
    m.thresh = -1e9
    (rgb,), (depth_mm,), (cloud,) = serve_scene(1, SMALL, seed=9)
    depth = depth_mm.astype(np.float32) / 1000.0
    sds = {d: subscribe(StreamingDetector(
        m, camera=kinect_camera(SMALL), max_overlap=0.9, k_per_level=8,
        device=d)) for d in ("cuda", "cpu")}
    contract_vs_cpu(sds["cuda"]._detect_single(rgb),
                    sds["cpu"]._detect_single(rgb), 8,
                    sds["cpu"].detector.plan_for(SMALL).levels,
                    "serve: card vs CPU at 120x160 (raw)")
    a, b = (sds[d].process(rgb, depth, cloud) for d in ("cuda", "cpu"))
    n = agreeing(a.detections, b.detections)
    if n == 0:
        raise RuntimeError("serve: card vs CPU: no detection agrees")
    whole = n == len(a.detections) == len(b.detections)
    if whole and not np.array_equal(a.mask, b.mask):
        raise RuntimeError("serve: card vs CPU: masks differ")
    gap = same_3d(a, b, n, "serve: card vs CPU", 1e-5)
    log(f"serve: card vs CPU at 120x160 through StreamingDetector: {n} of "
        f"{len(a.detections)}/{len(b.detections)} detections agree"
        f"{', masks equal' if whole else ''}; boxes3d, part_centers, poses "
        f"within {gap:.3g} (limit 1e-5)")


# ---------------------------------------------------------------- phase 9
# Training on the card.  The trainer's detects, its feature fetches and
# the host QP are timed from here (TrainClock wraps them on their
# classes); the package carries no timer.

#: the prune-and-continue config of tests/test_train.py:202-227
SMALL_TRAIN = dict(nmix=1, binsize=4, interval=3, latent_iters=1, nmax=24,
                   k_per_level=8, neg_per_image=4, C=0.05, overlap=0.35)
#: the person-26 gate of tests/test_accuracy_gate.py:89-160: 26 parts x
#: 4 mixtures, 10 training positives (20 with their mirror images), 4
#: held out, 3 negative images
P26_TRAIN = dict(nmix=4, binsize=4, interval=3, latent_iters=2, nmax=1200,
                 k_per_level=8, neg_per_image=8, C=0.05, overlap=0.35)
P26_NTRAIN = 10
P26_NNEG = 3


class TrainClock:
    """Inside ``with clock:``, host timers around Detector.detect_raw,
    Detector.detect_masked_raw, Detector.pyramid_features, QPCache.optimize
    and trainer._train_filter_svm (restored on exit), and the trainer's
    log lines stamped with their time (and echoed).  Each timed call ends
    in a synchronize on the card.  On a walk_impl="cuda" detector every
    detect must launch the walk kernel once per dp group and component,
    or the call raises."""

    def __init__(self, device: str):
        self.device = device
        self.lines = []      # (s since start, log line)
        self.calls = []      # (kind, start s, seconds, walk launches)
        self.launches = 0
        self._buf = ""
        self._restore = []
        self.t0 = 0.0

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter() - self.t0, line))
            self._stdout.write(line + "\n")
        return len(s)

    def flush(self) -> None:
        self._stdout.flush()

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _wrap(self, owner, name: str, kind: str) -> None:
        from partsbaseddetector_tpu_torch.ops import walk
        orig = getattr(owner, name)
        clock = self

        def timed(*a, **kw):
            n0 = walk.LAUNCHES
            t = time.perf_counter()
            out = orig(*a, **kw)
            clock._sync()
            dt = time.perf_counter() - t
            n = walk.LAUNCHES - n0
            if kind == "detect" and a[0].walk_impl == "cuda":
                want = expected_launches(a[0], tuple(a[1].shape[:2]))
                if n != want:
                    raise RuntimeError(f"train: a detect launched the walk "
                                       f"kernel {n} times, expected {want}")
            if kind == "detect":
                clock.launches += n
            clock.calls.append((kind, t - clock.t0, dt, n))
            return out
        setattr(owner, name, timed)
        self._restore.append((owner, name, orig))

    def __enter__(self):
        from partsbaseddetector_tpu_torch.infer.detector import Detector
        from partsbaseddetector_tpu_torch.train import trainer
        from partsbaseddetector_tpu_torch.train.qp import QPCache
        for owner, name, kind in (
                (Detector, "detect_raw", "detect"),
                (Detector, "detect_masked_raw", "detect"),
                (Detector, "pyramid_features", "features"),
                (QPCache, "optimize", "qp"),
                (trainer, "_train_filter_svm", "svm")):
            self._wrap(owner, name, kind)
        self._stdout = sys.stdout
        sys.stdout = self
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sys.stdout = self._stdout
        for owner, name, orig in reversed(self._restore):
            setattr(owner, name, orig)
        return False

    def counts(self) -> dict:
        """The decisions the log records: latent positives, cache size
        after mining and prune-and-continue passes per round, and the
        round at which the cache saturated, if any."""
        import re
        out = {"latent_positives": [], "cache_after_mining": [],
               "prune_passes": [], "saturated": []}
        for _, line in self.lines:
            m = re.search(r"iter (\d+): (\d+) latent positives", line)
            if m:
                out["latent_positives"].append(int(m.group(2)))
            m = re.search(r"iter (\d+): cache (\d+)/\d+ after mining "
                          r"\((\d+) prune", line)
            if m:
                out["cache_after_mining"].append(int(m.group(2)))
                out["prune_passes"].append(int(m.group(3)))
            m = re.search(r"iter (\d+): cache saturated .* image (\d+)/",
                          line)
            if m:
                out["saturated"].append((int(m.group(1)), int(m.group(2))))
        return out

    def segments(self, total: float):
        """(name, start s, end s) of the run's stages, cut at the log
        lines that end them."""
        import re
        ends = (("latent positives", "build + latent search"),
                ("after mining", "QP on positives + mining"),
                ("LB=", "final QP + threshold"))
        cuts = []
        for t, line in self.lines:
            part = re.search(r"stage 1: part (\d+)/(\d+)", line)
            it = re.search(r"iter (\d+): ", line)
            if "mixtures/part" in line:
                cuts.append(("stage 0: clustering", t))
            elif part and part.group(1) == part.group(2):
                cuts.append(("stage 1: part SVMs", t))
            elif it:
                cuts.extend((f"round {it.group(1)}: {name}", t)
                            for key, name in ends if key in line)
        out, start = [], 0.0
        for name, end in cuts:
            out.append((name, start, end))
            start = end
        if total > start:
            out.append(("after the last log line", start, total))
        return out

    def split(self, kind: str, lo: float = 0.0, hi: float = float("inf")):
        """(seconds, calls) of the timed calls of one kind starting in
        [lo, hi)."""
        sel = [c for c in self.calls if c[0] == kind and lo <= c[1] < hi]
        return sum(c[2] for c in sel), len(sel)


def train_timed(name, pos, neg, parents, cfg: dict, device: str,
                mirror_map=None):
    """The port's train_parts_model on ``device`` under a TrainClock;
    returns (model, clock, wall seconds)."""
    from partsbaseddetector_tpu_torch.train.trainer import (TrainConfig,
                                                           train_parts_model)
    clock = TrainClock(device)
    t0 = time.perf_counter()
    with clock:
        model = train_parts_model(
            name, [s.image for s in pos], np.stack([s.points for s in pos]),
            neg, parents, TrainConfig(**cfg), cache_dir=None, verbose=True,
            mirror_map=mirror_map, device=device)
        clock._sync()
    return model, clock, time.perf_counter() - t0


def cost_report(what: str, clock: TrainClock, total: float,
                where: str) -> None:
    """The training run's time split, by stage and by kind of call."""
    log(f"{what}: {total:.3f} s wall on {where} (host clock; every timed "
        f"call ends in a synchronize)")
    for name, lo, hi in clock.segments(total):
        parts = []
        for kind in ("detect", "features", "qp"):
            s, n = clock.split(kind, lo, hi)
            parts.append(f"{kind} {s:.3f} s/{n}")
        extra = ""
        if name.startswith("stage 1"):
            s, n = clock.split("svm", lo, hi)
            extra = f"; {n} SVMs, {s / max(n, 1):.3f} s per SVM"
        log(f"  {name}: {hi - lo:.3f} s ({', '.join(parts)}{extra})")
    shares, rest = [], total
    for kind in ("detect", "features", "qp"):
        s, n = clock.split(kind)
        rest -= s
        shares.append(f"{kind} {s:.3f} s in {n} calls "
                      f"({100 * s / total:.1f} %)")
    log(f"  whole run: {'; '.join(shares)}; other {rest:.3f} s")


def person26_gate(model, held, device: str):
    """Held-out mean PCK@0.5 and mean APK of tests/test_accuracy_gate.py:
    Detector(model, k_per_level=8) + part_nms(., 0.3), thresh -1e9."""
    import dataclasses
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.ops.nms import part_nms
    from partsbaseddetector_tpu_torch.utils.eval import (KeypointDetection,
                                                         KeypointGT, apk,
                                                         pck)
    m = dataclasses.replace(model)
    m.thresh = -1e9
    det = Detector(m, k_per_level=8, device=device)
    P = m.components[0].nparts
    pred, gts, scales, all_dets = [], [], [], []
    for s in held:
        dets = det.candidates_to_detections(
            part_nms(det.detect_raw(s.image), 0.3))
        if not dets:
            raise RuntimeError("train: no detection on a held-out positive")
        all_dets.append(dets)
        d = dets[0]
        pred.append(np.stack([(d.parts[:, 0] + d.parts[:, 2]) / 2,
                              (d.parts[:, 1] + d.parts[:, 3]) / 2], 1))
        gts.append(s.points)
        scales.append(s.scale)
    pck_pp = pck(pred, gts, scales, thresh=0.5)
    apks = []
    for p in range(P):
        dps, gps = [], []
        for i, s in enumerate(held):
            gps.append(KeypointGT(points=s.points[p:p + 1], scale=s.scale))
            for d in all_dets[i][:4]:
                c = np.array([(d.parts[p, 0] + d.parts[p, 2]) / 2,
                              (d.parts[p, 1] + d.parts[p, 3]) / 2])
                dps.append(KeypointDetection(i, d.score, c))
        apks.append(apk(dps, gps, thresh=0.5)[0])
    return float(pck_pp.mean()), float(np.mean(apks))


def train_person26(device: str, where: str):
    """Step 2: person-26 (26 parts x 4 mixtures) trained end to end on
    ``device`` and gated on held-out PCK and APK >= 0.9; the cost split
    printed.  Returns (model, train positives, negatives, held)."""
    from partsbaseddetector_tpu_torch.ops import walk
    from partsbaseddetector_tpu_torch.tools.datasets import (
        PERSON26_MIRROR, PERSON26_PARENTS, synthetic_skeletons)
    pos, neg = synthetic_skeletons(n=14, seed=7)
    train, held = pos[:P26_NTRAIN], pos[P26_NTRAIN:]
    neg = neg[:P26_NNEG]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    walk.LAUNCHES = 0
    model, clock, total = train_timed(
        "person26", train, neg, PERSON26_PARENTS, P26_TRAIN, device,
        mirror_map=PERSON26_MIRROR)
    launches = walk.LAUNCHES
    P, nmix = model.components[0].nparts, P26_TRAIN["nmix"]
    if P != 26 or model.nfilters != P * nmix:
        raise RuntimeError(f"train: person-26 gave {P} parts, "
                           f"{model.nfilters} filters")
    cost_report(f"train person-26 ({P} parts x {nmix} mixtures, "
                f"{model.nfilters} filters, {2 * len(train)} positives "
                f"with mirrors, {len(neg)} negative images)", clock, total,
                where)
    if device == "cuda":
        log(f"  peak device memory {torch.cuda.max_memory_allocated()} B "
            f"during training; walk kernel launches {launches} in "
            f"{clock.split('detect')[1]} detects, each as many as its dp "
            f"groups x components")
        if launches == 0 or launches != clock.launches:
            raise RuntimeError(f"train: walk launches {launches}, "
                               f"{clock.launches} in the detects")
    c = clock.counts()
    log(f"  decisions: {json.dumps(c)}; thresh {model.thresh!r}")
    mean_pck, mean_apk = person26_gate(model, held, device)
    log(f"train person-26 gate: held-out mean PCK@0.5 {mean_pck:.4f}, mean "
        f"APK {mean_apk:.4f} (gate 0.9 each) on {len(held)} held-out "
        f"positives")
    if not (mean_pck >= 0.9 and mean_apk >= 0.9):
        raise RuntimeError("train: person-26 below the accuracy gate")
    return model, train, neg, held


def phase_train_small() -> None:
    """9 (1). The small config trained on the card and on the CPU: equal
    decisions, weights within 1e-4 of max|w|, equal held-out root."""
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.tools.datasets import synthetic_figures
    from partsbaseddetector_tpu_torch.train.vectorize import (BlockLayout,
                                                             model_to_vec)
    pos, neg = synthetic_figures(n=8, imsize=(64, 64), nparts=2, seed=3)
    runs = {d: train_timed("small", pos, neg[:3], [-1, 0], SMALL_TRAIN, d)
            for d in ("cuda", "cpu")}
    counts = {d: r[1].counts() for d, r in runs.items()}
    w = {d: model_to_vec(r[0], BlockLayout.for_model(r[0]))[0]
         for d, r in runs.items()}
    gap = float(np.abs(w["cuda"] - w["cpu"]).max() / np.abs(w["cpu"]).max())
    thresh = {d: r[0].thresh for d, r in runs.items()}
    roots = {}
    for d, (m, _, _) in runs.items():
        m.thresh = -1e9
        det = Detector(m, k_per_level=4, device=d)
        roots[d] = det.candidates_to_detections(
            det.detect_raw(pos[0].image), 1)[0].locations[0].tolist()
    log(f"train small: card {json.dumps(counts['cuda'])} in "
        f"{runs['cuda'][2]:.3f} s, CPU {json.dumps(counts['cpu'])} in "
        f"{runs['cpu'][2]:.3f} s; weights card vs CPU max |diff| / max|w| "
        f"{gap:.3g} (limit 1e-4); thresh {thresh['cuda']!r} vs "
        f"{thresh['cpu']!r}; root on pos[0] {roots['cuda']} vs "
        f"{roots['cpu']}")
    if counts["cuda"] != counts["cpu"]:
        raise RuntimeError("train small: card and CPU decisions differ")
    if not gap <= 1e-4:
        raise RuntimeError("train small: weights differ beyond 1e-4")
    if roots["cuda"] != roots["cpu"]:
        raise RuntimeError("train small: held-out root differs")


def phase_train_paths(model, train, neg) -> dict:
    """9 (3). Kernel walk == plain walk on the three detects of training,
    with the trained person-26: the latent search on a training positive
    under its overlap masks, a mining detect (interval 2, thresh -1.0)
    and the stage-1 single-filter model (P = 1, M = 1, interval 2) on a
    negative.  Returns the walk launches of one call of each."""
    import dataclasses
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.tools.datasets import (
        PERSON26_MIRROR, PERSON26_PARENTS)
    from partsbaseddetector_tpu_torch.train import features
    from partsbaseddetector_tpu_torch.train.cluster import point_to_box
    from partsbaseddetector_tpu_torch.train.trainer import (
        _single_filter_model, flip_positives)
    k = P26_TRAIN["k_per_level"]
    images, points = flip_positives([s.image for s in train],
                                    np.stack([s.points for s in train]),
                                    PERSON26_MIRROR)
    boxes = point_to_box(points, PERSON26_PARENTS)
    search = dataclasses.replace(model)
    search.thresh = -1e9
    mining = dataclasses.replace(model)
    mining.interval, mining.thresh = 2, -1.0
    stage1 = _single_filter_model(model.filters[0], model.biasw[0],
                                  model.binsize, model.norient, model.flen,
                                  -1.0)
    im = images[0]
    plan = Detector(search, k_per_level=k, compose="correct",
                    device="cuda").plan_for(im.shape[:2])
    by_level = features.part_overlap_masks(search, 0, plan, boxes[0],
                                           P26_TRAIN["overlap"])
    masks, li = [], 0
    for bucket in plan.buckets:
        masks.append(np.stack(by_level[li:li + len(bucket.levels)]))
        li += len(bucket.levels)
    cases = (("train_latent", search, im,
              lambda d: d.detect_masked_raw(im, masks),
              "latent search (masked, compose correct) on a training "
              "positive"),
             ("train_mine", mining, neg[0], lambda d: d.detect_raw(neg[0]),
              "mining detect (interval 2, thresh -1.0) on a negative"),
             ("train_stage1", stage1, neg[0], lambda d: d.detect_raw(neg[0]),
              "stage-1 single-filter detect (P=1, M=1, interval 2) on a "
              "negative"))
    out = {}
    for key, m, image, call, what in cases:
        dets = {impl: Detector(m, k_per_level=k, compose="correct",
                               device="cuda", walk_impl=impl)
                for impl in ("cuda", "torch")}
        got, n = counted(lambda: call(dets["cuda"]))
        expect_launches(f"train: {what}", n,
                        expected_launches(dets["cuda"], image.shape[:2]))
        if n == 0:
            raise RuntimeError(f"train: {what} left the walk kernel")
        equal_candidates(got, call(dets["torch"]),
                         f"train: {what}: kernel walk vs plain walk "
                         f"({int(got.valid.sum())} valid)")
        out[key] = n
    return out


def phase_train_invariant(model, held) -> None:
    """9 (4). |w . detection_feature - score| < 5e-3 on the held-out
    detections of the trained person-26 on the card (compose correct,
    the trainer's detector; tests/test_train.py:72-91)."""
    import dataclasses
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.train.features import detection_feature
    from partsbaseddetector_tpu_torch.train.vectorize import (BlockLayout,
                                                             model_to_vec)
    m = dataclasses.replace(model)
    m.thresh = -1e9
    layout = BlockLayout.for_model(m)
    w = model_to_vec(m, layout)[0]
    det = Detector(m, k_per_level=8, compose="correct", device="cuda")
    worst, n = 0.0, 0
    for s in held:
        feats = det.pyramid_features(s.image)
        for d in det.detect(s.image, max_detections=10):
            worst = max(worst, abs(float(w @ detection_feature(
                m, layout, d, feats)) - d.score))
            n += 1
    log(f"train: feature invariant on {n} held-out detections of the "
        f"trained person-26: max |w . x - score| {worst:.3g} (limit 5e-3)")
    if n == 0 or not worst < 5e-3:
        raise RuntimeError("train: w . detection_feature != score")


def phase_train(smi: str) -> dict:
    """9. Training on the card; returns the walk launches per call of
    each training detect."""
    phase_train_small()
    model, train, neg, held = train_person26("cuda", smi)
    paths = phase_train_paths(model, train, neg)
    phase_train_invariant(model, held)
    return paths


# ---------------------------------------------------------------- phase 10
def phase_face68(frames, smi: str) -> int:
    """10. Face-68 at full width: synthetic.face_like() (68 parts x 4
    mixtures, 272 filters, interval 5, so dp_split 3), thresh 0.0, on the
    main path's 8 frames (640x480 uint8, B=8, spatial conv, compose
    "reference", K=64): walk launches (one per dp group and component),
    shapes and order, kernel walk == plain walk end to end (the twin of
    phase 5), card vs CPU at 120x160 under the cross-engine contract,
    and the times of phase 6.  Returns the launches per dispatch."""
    from partsbaseddetector_tpu_torch.infer.detector import (Detector,
                                                             _dp_groups)
    from partsbaseddetector_tpu_torch.models import synthetic
    model = synthetic.face_like()
    model.thresh = 0.0
    det = Detector(model, k_per_level=K, device="cuda")
    plan = det.plan_for(IMG)
    ngroups = sum(len(_dp_groups(b, det.dp_split)) for b in plan.buckets)
    P = model.components[0].nparts
    log(f"face-68: {P} parts x {det.packed.components[0].maxmix} "
        f"mixtures, {model.nfilters} filters, interval {model.interval}, "
        f"dp_split {det.dp_split}; {len(plan.levels)} levels in "
        f"{len(plan.buckets)} buckets, {ngroups} dp groups")
    cands, n = counted(lambda: det.detect_batch_raw(frames))
    expect_launches(f"face-68, B={BATCH} ({ngroups} dp groups x "
                    f"{len(det.packed.components)} component)", n,
                    expected_launches(det, IMG))
    check_candidates(cands, len(plan.levels), P)
    log(f"face-68: valid candidates per frame (thresh 0.0): "
        f"{cands.valid.sum(1).tolist()}")
    plain = Detector(model, k_per_level=K, device="cuda", walk_impl="torch")
    equal_candidates(cands, plain.detect_batch_raw(frames),
                     "face-68: kernel walk vs plain walk, end to end")
    del plain
    m8 = synthetic.face_like()
    m8.thresh = -1e9
    det8 = Detector(m8, k_per_level=8, device="cuda")
    small = small_frame()
    contract_vs_cpu(det8.detect_raw(small),
                    Detector(m8, k_per_level=8, device="cpu").detect_raw(
                        small), 8, det8.plan_for(SMALL).levels,
                    what="face-68: card vs CPU at 120x160")
    phase_times(det, frames, smi, "face-68: ")
    return n


# ---------------------------------------------------------------- phase 11
def phase_parallel(model, frames, cands) -> dict:
    """11. parallel/ at world size 1 on person-26 (thresh 0.0),
    640x480: BatchDetector on a (1, 1) mesh at B=8 == the main path's
    Candidates; ScaleShardedDetector on a (1, 1) mesh on frame 0 ==
    Detector(dp_split=1); PipelinedDetector with front = back = cuda:0
    streaming frames 0-1 == Detector.detect_raw of each; then
    phase_scale_multires.  Each with the walk's launch count set to 0
    just before and read just after.  Returns the launches of each."""
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.parallel import (BatchDetector,
                                                       make_mesh)
    from partsbaseddetector_tpu_torch.parallel.pipeline import \
        PipelinedDetector
    from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
        ScaleShardedDetector, make_scale_mesh)
    out = {}
    bdet = BatchDetector(model, make_mesh(), k_per_level=K)
    got, n = counted(lambda: bdet.detect_batch(frames))
    expect_launches(f"BatchDetector (1, 1), B={BATCH}", n,
                    expected_launches(bdet, IMG))
    equal_candidates(got, cands,
                     f"BatchDetector (1, 1) vs Detector, B={BATCH}")
    out["batch_sharded"] = n
    report(f"BatchDetector (1, 1), B={BATCH}",
           lambda: bdet.detect_batch(frames), BATCH)

    sdet = ScaleShardedDetector(model, make_scale_mesh(), k_per_level=K)
    one = frames[0]
    got, n = counted(lambda: sdet.detect_raw(one))
    expect_launches("ScaleShardedDetector (1, 1), one frame", n,
                    len(sdet.plan_for(IMG).buckets)
                    * len(sdet.packed.components))
    ref = Detector(model, k_per_level=K, dp_split=1, device="cuda")
    equal_candidates(got, ref.detect_raw(one),
                     "ScaleShardedDetector (1, 1) vs Detector(dp_split=1)")
    out["scale_sharded"] = n
    report("ScaleShardedDetector (1, 1), one frame",
           lambda: sdet.detect_raw(one), 1)

    pdet = PipelinedDetector(model, "cuda:0", "cuda:0", k_per_level=K)
    two = [frames[0], frames[1]]
    got, n = counted(lambda: list(pdet.stream(two)))
    single = Detector(model, k_per_level=K, device="cuda")
    expect_launches("PipelinedDetector (cuda:0, cuda:0), stream of 2", n,
                    2 * expected_launches(single, IMG))
    for i, f in enumerate(two):
        equal_candidates(got[i], single.detect_raw(f),
                         f"PipelinedDetector vs Detector, frame {i}")
    out["pipelined"] = n // 2
    report("PipelinedDetector (cuda:0, cuda:0), stream of 2",
           lambda: list(pdet.stream(two)), 2)
    report("Detector.detect_raw, 2 frames (the pipeline's baseline)",
           lambda: [single.detect_raw(f) for f in two], 2)
    out["scale_sharded_multires"] = phase_scale_multires(frames)
    return out


def phase_scale_multires(frames) -> int:
    """11, multi-resolution: ScaleShardedDetector on a (1, 1) scale mesh
    with multires_person() (thresh -1e9, K = 64) on frame 0 == the
    card's MultiResDetector.detect_raw on all fields, with the walk's
    launch count (0: the multires walk is plain torch) read around it;
    then the ms/frame and peak memory of both, in turns.  Returns the
    launches."""
    from partsbaseddetector_tpu_torch.infer.multires import MultiResDetector
    from partsbaseddetector_tpu_torch.parallel.scale_sharded import (
        ScaleShardedDetector, make_scale_mesh)
    m = multires_person()
    m.thresh = -1e9
    sdet = ScaleShardedDetector(m, make_scale_mesh(), k_per_level=K)
    mdet = MultiResDetector(m, k_per_level=K, device="cuda")
    one = frames[0]
    what = "ScaleShardedDetector (1, 1), multires person, one frame"
    got, n = counted(lambda: sdet.detect_raw(one))
    expect_launches(what, n, 0)
    equal_candidates(got, mdet.detect_raw(one),
                     f"{what} vs MultiResDetector")
    log(f"{what}: slots {sdet.local_slot_range(IMG)} of buckets "
        f"{[len(b.levels) for b in sdet.plan_for(IMG).buckets]}, "
        f"capacity {got.capacity}")
    for name, fn in ((what, sdet.detect_raw),
                     ("MultiResDetector, one frame", mdet.detect_raw),
                     ("MultiResDetector, one frame", mdet.detect_raw),
                     (what, sdet.detect_raw)):
        report(name, lambda: fn(one), 1)
    return n


# ---------------------------------------------------------------- phase 12
def phase_stream_mesh(model, frames) -> dict:
    """12. StreamingDetector(mesh=make_mesh()) at world size 1, person-26
    (thresh 0.0), the main path's 8 frames: process_batch and stream
    (batch 8) give the detections of the StreamingDetector without a
    mesh; process (one frame, replicated over the data axis) too.
    Returns the launches per dispatch."""
    from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
    from partsbaseddetector_tpu_torch.parallel import make_mesh
    rgbs = frames.cpu().numpy()
    plain = StreamingDetector(model, k_per_level=K, device="cuda")
    meshed = StreamingDetector(model, mesh=make_mesh(), k_per_level=K)
    got, n = counted(lambda: meshed.process_batch(rgbs))
    expect_launches(f"StreamingDetector(mesh=(1, 1)).process_batch, "
                    f"B={BATCH}", n, expected_launches(meshed.detector, IMG))
    ref = plain.process_batch(rgbs)
    streamed = list(meshed.stream(list(rgbs), batch=BATCH))
    ndet = 0
    for j in range(BATCH):
        same_detections(got[j].detections, ref[j].detections,
                        f"mesh process_batch, frame {j}", 0.0)
        same_detections(streamed[j].detections, ref[j].detections,
                        f"mesh stream, frame {j}", 0.0)
        ndet += len(ref[j].detections)
    same_detections(meshed.process(rgbs[0]).detections,
                    plain.process(rgbs[0]).detections, "mesh process", 0.0)
    log(f"StreamingDetector(mesh=(1, 1)): process_batch == stream == "
        f"without a mesh on {BATCH} frames ({ndet} detections), process "
        f"too")
    return {"stream_mesh": n}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card", file=sys.stderr)
        return 2
    from partsbaseddetector_tpu_torch.infer.detector import Detector
    from partsbaseddetector_tpu_torch.models import synthetic

    smi = phase_environment()
    phase_build()
    model = synthetic.person_like()
    model.thresh = 0.0                 # as bench.py's flagship workload
    det = Detector(model, k_per_level=K, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(0, 256, (BATCH,) + IMG + (3,), generator=g,
                           device="cuda", dtype=torch.uint8)
    kern = phase_kernel_vs_plain(det, frames)
    cands, launches, all_c = phase_main_path(det, frames, kern["ngroups"])
    phase_plain_walk_end_to_end(model, frames, cands)
    phase_times(det, frames, smi)
    paths = {"main": launches}
    paths["aliased"] = phase_aliased(frames)
    paths["depth"] = phase_depth(det, frames, cands)
    paths["masked"] = phase_masked(det, frames)
    paths["fft"] = phase_fft(frames, cands)
    phase_features()
    phase_multires(frames)
    phase_nms(all_c, kern["rootv"])
    paths.update(phase_serving(smi))
    paths.update(phase_train(smi))
    paths["face68"] = phase_face68(frames, smi)
    paths.update(phase_parallel(model, frames, cands))
    paths.update(phase_stream_mesh(model, frames))
    log(json.dumps({"kernels": [{
        "name": "walk_tree", "route": "cuda",
        "source": "partsbaseddetector_tpu_torch/csrc/walk.cu",
        "replaces": "partsbaseddetector_tpu/ops/walk_pallas.py:184",
        "tpu_kernel": "walk_tree_pallas",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "equal": kern["max_abs_err"] == 0,
        "ms": kern["kernel_ms"], "kernel_ms": kern["kernel_ms"],
        "ms_cold": kern["cold_ms"], "device_ms": kern["device_ms"],
        "device_ms_cold": kern["device_cold_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "depth": kern["depth"], "latency_ms": kern["latency_ms"],
        "latency_cold_ms": kern["latency_cold_ms"],
        "load_ns": kern["load_ns"], "miss_ns": kern["miss_ns"],
        "library_ms": None, "launches_per_path": paths}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
