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
     device ms (CUDA events at stage boundaries), peak device memory,
     and one batch under torch.profiler: the device's busy and idle
     share and the kernels that take the most device time;
  7. the kernels line (JSON), the card line, then the last line
     {"ok": true, "device": {...}}.

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
    return walk_args(res.scores, res.tmp, xs, ys, mv, comp,
                     packed.parent_static[0])


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
                miss_ns=miss_ns, **bound)


# ---------------------------------------------------------------- phase 4
def check_candidates(c, nlevels: int, P: int) -> None:
    n = nlevels * K
    want = {"score": (BATCH, n), "valid": (BATCH, n),
            "component": (BATCH, n), "level": (BATCH, n),
            "boxes": (BATCH, n, P, 4), "loc": (BATCH, n, P, 3)}
    for f, shape in want.items():
        got = tuple(getattr(c, f).shape)
        if got != shape:
            raise RuntimeError(f"{f} has shape {got}, expected {shape}")
    if not torch.isfinite(c.score[c.valid]).all():
        raise RuntimeError("non-finite score on a valid candidate")
    for b in range(BATCH):
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
    on_card = Detector(m8, k_per_level=8, device="cuda").detect_raw(small)
    on_cpu = Detector(m8, k_per_level=8, device="cpu").detect_raw(small)
    contract_vs_cpu(on_card, on_cpu, 8)
    return cands, launches


def contract_vs_cpu(a, b, k: int) -> None:
    la, lb = a.loc.cpu().numpy(), b.loc.cpu().numpy()
    sa, sb = a.score.cpu().numpy(), b.score.cpu().numpy()
    lev = a.level.cpu().numpy()
    if not np.array_equal(lev, b.level.cpu().numpy()):
        raise RuntimeError("card vs CPU: level fields differ")
    total = matched = exact = close = nparts = 0
    diffs = []
    for lv in np.unique(lev):
        sel = np.nonzero(lev == lv)[0]
        ga = {(int(la[i, 0, 0]), int(la[i, 0, 1])): i for i in sel}
        gb = {(int(lb[i, 0, 0]), int(lb[i, 0, 1])): i for i in sel}
        total += k
        for key in set(ga) & set(gb):
            i, j = ga[key], gb[key]
            matched += 1
            diffs.append(abs(float(sa[i]) - float(sb[j])))
            dd = np.abs(la[i, :, :2] - lb[j, :, :2])
            nparts += la.shape[1]
            exact += int(((dd == 0).all(1)
                          & (la[i, :, 2] == lb[j, :, 2])).sum())
            close += int((dd.max(1) <= 1).sum())
    med = float(np.median(diffs))
    log(f"card vs CPU at 120x160: root keys {matched}/{total}, PCK "
        f"{close}/{nparts}, exact parts {exact}/{nparts}, median score "
        f"diff {med:.3g}")
    if not (matched >= 0.9 * total and close >= 0.99 * nparts
            and exact >= 0.9 * nparts and med < 1e-4):
        raise RuntimeError("card vs CPU: contract not met")


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
def phase_times(det, frames, smi: str) -> None:
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
    log(f"B={BATCH}: {ms_batch / BATCH:.3f} ms/frame, "
        f"{1e3 * BATCH / ms_batch:.2f} frames/s (median of 7 batches, "
        f"host clock to synchronize; batch ms {sorted(wall)}) "
        f"[{smi}]")
    log(f"B={BATCH}: device-timeline ms/batch (CUDA events) median "
        f"{statistics.median(dev):.3f}")

    stages: dict = {}
    pending = []

    class Stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.a = torch.cuda.Event(enable_timing=True)
            self.a.record()

        def __exit__(self, *exc):
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            pending.append((self.name, self.a, b))
            return False

    det.detect_batch_raw(frames, stage=Stage)
    torch.cuda.synchronize()
    for name, a, b in pending:
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    log("per-stage ms per batch (CUDA events at stage boundaries, launch "
        "gaps included): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in stages.items()))
    log(f"peak device memory (max_memory_allocated): {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    phase_device_trace(det, frames)


def phase_device_trace(det, frames) -> None:
    """One B=8 batch under torch.profiler: the share of the batch's
    device span in which some kernel runs, and the kernels that take
    the most device time.  The profiler adds host work per launch, so
    the idle share it shows is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        det.detect_batch_raw(frames)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        log("device trace: not measured (the profiler recorded no "
            "device kernels)")
        return
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = max(e for _, e in spans) - spans[0][0]
    log(f"device trace (torch.profiler, one B={BATCH} batch): "
        f"{len(spans)} device kernels, busy {busy / 1e3:.3f} ms of a "
        f"{span / 1e3:.3f} ms span, idle share {1 - busy / span:.3f}")
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            d = per_name.setdefault(e.name, [0.0, 0])
            d[0] += e.time_range.end - e.time_range.start
            d[1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {name[:90]}")


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
    cands, launches = phase_main_path(det, frames, kern["ngroups"])
    phase_plain_walk_end_to_end(model, frames, cands)
    phase_times(det, frames, smi)
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
        "library_ms": None}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
