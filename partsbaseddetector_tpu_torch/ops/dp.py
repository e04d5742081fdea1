"""Min-sum dynamic program over the part tree, levels as a batch axis.

Port of partsbaseddetector_tpu/ops/dp.py: the DP keyed by part slot,
and the filter-keyed DP for components with shared filter ids
(``_dp_min_aliased``).  The reference's per-(scale, component) loop
(reference: src/DynamicProgram.cpp:66-173) becomes a loop over parts in
reverse topological order, P-1 down to 1 — the order of the JAX
package's ``lax.scan`` — with every level of a group as one batch axis.
Parts are stored root-first with parent < child, so the loop visits
children before parents.

A part step is the DT of the part's scores (x pass, then y pass), the
child->parent mixture-pair bias, the max over child mixtures and the
add into the parent's scores.  On CUDA tensors every part step of a
(group, component) runs in the hand-written kernel ``csrc/dp.cu``
(``dp_tree``: one C call, two launches a depth of the tree); on CPU
tensors in the plain eager chain (``dp_min_levels_plain``, the
kernel's reference).  The two are bit-identical: the kernel rounds each
operation of the penalty and the candidate as eager PyTorch does, a max
is exact, and sibling messages are added in the loop's order.

As in the JAX package, the forward pass computes only maxima:
  scores[p] — each part's fully accumulated DT input, and
  tmp[p]    — the x-pass row maxima,
and backtracking recomputes the argmaxes at the K visited positions
(``walk_children`` below; the fused form is the CUDA kernel in
ops/walk.py).  Padded mixture slots carry NEG so they never win.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from partsbaseddetector_tpu_torch.models.part_tree import PackedComponent
from partsbaseddetector_tpu_torch.ops import _build
from partsbaseddetector_tpu_torch.ops.common import NEG, check_tensor
from partsbaseddetector_tpu_torch.ops.dt import dt_max_x, dt_max_y
from partsbaseddetector_tpu_torch.utils import profiling

#: mixtures per part the DP kernel takes (csrc/dp.cu's kMaxM)
KERNEL_MAX_MIXTURES = 16

#: a launch schedule: layers in launch order, each a tuple of groups
#: (parent, children in descending order); parent -1 sends the message
#: to a buffer instead of the parent's scores
Schedule = Tuple[Tuple[Tuple[int, Tuple[int, ...]], ...], ...]


class DPResult(NamedTuple):
    rootv: torch.Tensor    # (L, H, W) root score map (bias added, maxed)
    rooti: torch.Tensor    # (L, H, W) int32 best root mixture
    scores: torch.Tensor   # (L, P, M, H, W) accumulated DT inputs per part
    tmp: torch.Tensor      # (L, P, M, H, W) x-pass maxima (part 0: zero),
    #                        stored W-minor: tmp.transpose(-1, -2) is
    #                        contiguous


def _inbounds(H: int, W: int, true_size: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool: True inside each (h, w) valid extent;
    true_size (..., 2)."""
    dev = true_size.device
    h = true_size[..., 0, None, None]
    w = true_size[..., 1, None, None]
    return ((torch.arange(H, device=dev)[:, None] < h)
            & (torch.arange(W, device=dev)[None, :] < w))


def dp_min_levels(pdfs: torch.Tensor, comp: PackedComponent,
                  compose: str = "reference", part_masks=None,
                  true_sizes=None) -> DPResult:
    """The DP for one component over a batch of levels.

    pdfs: (L, H, W, F) filter responses for ALL model filters (the
    output of ops.conv.conv_bank), keyed by filter id like the reference
    (include/Parts.hpp:165-168).  true_sizes: optional (L, 2) valid
    (h, w) extents; cells beyond them are masked to NEG in the scores0
    construction, value-identical to pre-masked pdfs.  part_masks:
    optional (L, P, H, W) bool allowed part placements (the masked
    latent search; the reference's overlap masking,
    matlab/detection/detect.m:60-101): every other placement is NEG.
    Components with shared filter ids run the filter-keyed DP
    (``_dp_min_aliased``).  On CUDA the part steps run in the kernel
    (``dp_tree``), on the CPU in the plain chain; any other device
    raises."""
    if pdfs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dp_min_levels runs on CUDA or the CPU, not "
                         f"{pdfs.device}")
    return _dp_min_levels(pdfs, comp, compose, part_masks, true_sizes,
                          pdfs.device.type == "cuda")


def dp_min_levels_plain(pdfs: torch.Tensor, comp: PackedComponent,
                        compose: str = "reference", part_masks=None,
                        true_sizes=None) -> DPResult:
    """dp_min_levels with every part step in the plain eager chain, on
    any device: the kernel's reference (chip_smoke.py holds the kernel
    to it on the card)."""
    return _dp_min_levels(pdfs, comp, compose, part_masks, true_sizes,
                          False)


def _dp_min_levels(pdfs, comp, compose, part_masks, true_sizes,
                   kernel: bool) -> DPResult:
    if compose not in ("reference", "correct"):
        raise ValueError(compose)
    H, W = pdfs.shape[1:3]
    pdfs_f = pdfs.movedim(-1, 1)                       # (L, F, H, W)
    # where a cell may hold a part placement, per (level, part)
    allowed = None
    if true_sizes is not None:
        ts = torch.as_tensor(true_sizes, dtype=torch.int32,
                             device=pdfs.device)
        allowed = _inbounds(H, W, ts)[:, None]         # (L, 1, H, W)
    if part_masks is not None:
        pm = torch.as_tensor(part_masks, dtype=torch.bool,
                             device=pdfs.device)
        allowed = pm if allowed is None else allowed & pm
    if comp.aliased:
        scores, tmp, root_s = _dp_min_aliased(pdfs_f, comp, allowed, kernel)
        # as the JAX package's aliased scan: the root bias added to every
        # root slot, padded ones included
        rootw = root_s + comp.root_bias
    else:
        scores, tmp = _dp_min_part_keyed(pdfs_f, comp, allowed, kernel)
        # root: add the scalar root bias to every root mixture and max
        # (reference: src/DynamicProgram.cpp:162-171)
        rootw = scores[:, 0] + comp.root_bias          # (L, M, H, W)
        rootw = torch.where(comp.mix_valid[0][:, None, None], rootw, NEG)
    return DPResult(rootw.amax(dim=1), _argmax_first(rootw, 1), scores, tmp)


def _x_pass_buffer(scores: torch.Tensor) -> torch.Tensor:
    """tmp for scores (L, P, M, H, W), stored W-minor so that a column
    tmp[l, p, m, :, x] is contiguous for the y pass and the walk
    kernel; part 0 has no x pass and holds zeros."""
    L, P, M, H, W = scores.shape
    tmp = torch.empty((L, P, M, W, H), dtype=scores.dtype,
                      device=scores.device).transpose(-1, -2)
    tmp[:, 0].zero_()
    return tmp


def _dp_min_part_keyed(pdfs_f: torch.Tensor, comp: PackedComponent,
                       allowed, kernel: bool):
    """The DP keyed by part slot, for components whose filter ids are
    all distinct.  pdfs_f (L, F, H, W); allowed: None or a bool mask
    broadcasting to (L, P, H, W).  Returns (scores, tmp), each
    (L, P, M, H, W), tmp stored W-minor."""
    P = comp.filterid.shape[0]
    scores = pdfs_f[:, comp.filterid.long()]           # (L, P, M, H, W)
    # invalid mixture slots must never win any max
    keep = comp.mix_valid[None, :, :, None, None]
    if allowed is not None:
        keep = keep & allowed[:, :, None]
    scores = torch.where(keep, scores, NEG)
    tmp = _x_pass_buffer(scores)
    if kernel:
        dp_tree(scores, tmp, comp, dp_schedule(comp.parent_static))
        return scores, tmp
    parent = comp.parent.long()
    for p in range(P - 1, 0, -1):
        maxv = _part_message(scores[:, p], comp, p, tmp[:, p])
        scores.index_add_(1, parent[p:p + 1], maxv[:, None])
    return scores, tmp


def _part_message(s: torch.Tensor, comp: PackedComponent, p: int,
                  tmp_p: torch.Tensor) -> torch.Tensor:
    """Part p's message to its parent in the plain chain, shared by both
    DP branches: the DT of its scores s (L, M, H, W), x pass written
    into tmp_p, plus the child->parent mixture-pair bias, maxed over
    child mixtures.  Returns (L, Mp, H, W)."""
    w = comp.defw[p]                                   # (M, 4)
    anc = comp.anchor[p]                               # (M, 2)
    dt_max_x(s, w[:, 0], w[:, 1], anc[:, 0], out=tmp_p)
    sdt = dt_max_y(tmp_p, w[:, 2], w[:, 3], anc[:, 1])
    weighted = sdt[:, None] + comp.bias[p].T[None, :, :, None, None]
    return weighted.amax(dim=2)


def _dp_min_aliased(pdfs_f: torch.Tensor, comp: PackedComponent, allowed,
                    kernel: bool):
    """The DP for components with shared filter ids (port of
    partsbaseddetector_tpu/ops/dp.py:_dp_min_aliased).

    The reference keys its scratch scores by FILTER ID (``ncscores``,
    src/DynamicProgram.cpp:93 with reads and writes at :115-118 and
    :152-155 through include/Parts.hpp:165-168), so (part, mixture)
    slots that share an id share one accumulation buffer.  A
    per-filter accumulator ``acc`` (L, F, H, W) reproduces it: part p
    reads pdf[fid] + acc[fid] when it is visited, and writes
    acc[fid[parent][mp]] += maxv[mp].  Each part's scores are its
    visit-time values, so the walk recomputes argmaxes against what the
    forward pass used.  Part by part, in the loop's order: with
    ``kernel`` each message comes from one dp_tree call into a buffer.
    Returns (scores, tmp, root scores (L, M, H, W))."""
    P, M = comp.filterid.shape
    L, F, H, W = pdfs_f.shape
    fid = comp.filterid.long()
    acc = torch.zeros_like(pdfs_f, memory_format=torch.contiguous_format)
    keep = comp.mix_valid[None, :, :, None, None]      # (1, P, M, 1, 1)
    if allowed is not None:
        keep = keep & allowed[:, :, None]              # (L, P|1, M, H, W)

    scores = torch.empty((L, P, M, H, W), dtype=pdfs_f.dtype,
                         device=pdfs_f.device)

    def read(p):
        """Part p's visit-time scores, written to scores[:, p]."""
        s = pdfs_f[:, fid[p]] + acc[:, fid[p]]         # (L, M, H, W)
        scores[:, p] = torch.where(keep[:, p], s, NEG)
        return scores[:, p]

    tmp = _x_pass_buffer(scores)
    msg = torch.empty((L, M, H, W), dtype=scores.dtype,
                      device=scores.device) if kernel else None
    for p in range(P - 1, 0, -1):
        s = read(p)
        if kernel:
            dp_tree(scores, tmp, comp, (((-1, (p,)),),), msg)
            maxv = msg
        else:
            maxv = _part_message(s, comp, p, tmp[:, p])
        # one add per valid parent mixture, in mixture order, as the JAX
        # package's scatter-add applies shared ids; padded parent
        # mixtures repeat mixture 0's id and hold garbage: they are left
        # out, which equals the JAX package's add of zeros (acc starts at
        # +0.0 and never becomes -0.0)
        for mp, f in enumerate(comp.message_fids[p]):
            acc[:, f] += maxv[:, mp]
    return scores, tmp, read(0)


# ---------------------------------------------------------------------
# the DP kernel (csrc/dp.cu): its schedule, argument checks and launch
# ---------------------------------------------------------------------

def depth_layers(parent: Union[Sequence[int], torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parts of a tree in depth order (the walk kernel's schedule,
    and the DP kernel's in reverse).

    parent: (P,) with parent[p] < p for p > 0 (parent[0], the root's, is
    ignored).  Returns (order (P,), offsets (depth + 2,)), int32 on the
    CPU: layer d is order[offsets[d]:offsets[d + 1]], its parts
    ascending; layer 0 is the root alone."""
    par = parent.tolist() if isinstance(parent, torch.Tensor) else parent
    depth = [0] * len(par)
    for p in range(1, len(par)):
        if not 0 <= par[p] < p:
            raise ValueError(f"parent[{p}] = {par[p]}: a part's parent "
                             f"must precede it")
        depth[p] = depth[par[p]] + 1
    order = sorted(range(len(par)), key=lambda p: (depth[p], p))
    counts = [0] * (max(depth, default=0) + 1)
    for d in depth:
        counts[d] += 1
    offsets = [0]
    for n in counts:
        offsets.append(offsets[-1] + n)
    return (torch.tensor(order, dtype=torch.int32),
            torch.tensor(offsets, dtype=torch.int32))


@functools.lru_cache(maxsize=64)
def dp_schedule(parent: Tuple[int, ...]) -> Schedule:
    """The DP kernel's launch schedule for a tree (parent[p] < p): the
    depths from the deepest to 1, each a tuple of groups (parent q, the
    children of q in descending order), q ascending.  Every part of a
    depth depends only on deeper ones, so a depth is one launch of each
    pass; a group's messages are added to q in descending child order,
    as the plain loop over P-1 ... 1 adds them."""
    order, offsets = depth_layers(parent)
    order, offsets = order.tolist(), offsets.tolist()
    layers = []
    for d in range(len(offsets) - 2, 0, -1):
        groups = {}
        for p in reversed(order[offsets[d]:offsets[d + 1]]):
            groups.setdefault(parent[p], []).append(p)
        layers.append(tuple((q, tuple(c)) for q, c in sorted(groups.items())))
    return tuple(layers)


@functools.lru_cache(maxsize=512)
def _schedule_table(layers: Schedule, device: torch.device):
    """(host, on_device, top): the schedule as csrc/dp.cu reads it,
    int32, on the host and on ``device`` — nlayers, ngroups, nparts; per
    layer its parts' and its groups' ranges (part_lo, part_hi, group_lo,
    group_hi); per group (parent, lo, hi), its children parts[lo:hi];
    then the parts — and the largest part index it names."""
    lay, grp, parts = [], [], []
    for layer in layers:
        lay += [len(parts), len(parts) + sum(len(c) for _, c in layer),
                len(grp) // 3, len(grp) // 3 + len(layer)]
        for q, children in layer:
            grp += [q, len(parts), len(parts) + len(children)]
            parts += children
    host = torch.tensor([len(layers), len(grp) // 3, len(parts)]
                        + lay + grp + parts, dtype=torch.int32)
    return host, host.to(device), max(parts + grp[::3], default=0)


def check_dp_args(scores, tmp, defw, anchor, bias, msg=None) -> None:
    """Raise unless the arguments are what the DP kernel takes: float32
    scores (L, P, M, H, W), contiguous; tmp of that shape stored W-minor
    (tmp.transpose(-1, -2) contiguous); defw (P, M, 4) float32, anchor
    (P, M, 2) int32 and bias (P, M, M) float32, contiguous; msg, if
    given, (L, M, H, W) float32 contiguous; all on scores' device,
    4-byte aligned; at most KERNEL_MAX_MIXTURES mixtures."""
    if scores.dim() != 5:
        raise ValueError(f"scores has shape {tuple(scores.shape)}, "
                         f"expected (L, P, M, H, W)")
    L, P, M, H, W = scores.shape
    dev = scores.device
    f32 = torch.float32
    args = [("scores", scores, f32, (L, P, M, H, W)),
            ("tmp", tmp, f32, (L, P, M, H, W)),
            ("defw", defw, f32, (P, M, 4)),
            ("anchor", anchor, torch.int32, (P, M, 2)),
            ("bias", bias, f32, (P, M, M))]
    if msg is not None:
        args.append(("msg", msg, f32, (L, M, H, W)))
    for name, t, dtype, shape in args:
        check_tensor(name, t, dtype, shape, dev)
        if name == "tmp":
            if not t.transpose(-1, -2).is_contiguous():
                raise ValueError(
                    "tmp is not stored W-minor: the kernel writes "
                    "tmp.transpose(-1, -2) as a contiguous (L, P, M, W, H) "
                    "tensor")
        elif not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} is not 4-byte aligned")
    if M > KERNEL_MAX_MIXTURES:
        raise ValueError(f"{M} mixtures: the DP kernel takes at most "
                         f"{KERNEL_MAX_MIXTURES}")


def dp_tree(scores: torch.Tensor, tmp: torch.Tensor, comp: PackedComponent,
            layers: Schedule, msg: Optional[torch.Tensor] = None) -> None:
    """The part steps of ``layers`` (a dp_schedule, or one part with
    parent -1) in the kernel, on CUDA tensors: one C call that launches
    the x pass and the y pass of each layer, in place.

    The x pass of part p writes tmp[:, p]; the y pass adds the message
    (the DT, the pair bias, the max over child mixtures) into
    scores[:, q] for a group's parent q, children in the group's order,
    or, for parent -1, writes it to msg (L, M, H, W).  Each call counts
    its launches, two a layer, in the tracer's ``dp.launches``."""
    if scores.device.type != "cuda":
        raise ValueError(f"dp_tree runs on CUDA, not {scores.device}")
    check_dp_args(scores, tmp, comp.defw, comp.anchor, comp.bias, msg)
    L, P, M, H, W = scores.shape
    if not layers or L == 0:
        return
    host, table, top = _schedule_table(layers, scores.device)
    if top >= P:
        raise ValueError(f"the schedule names part {top} of {P}")
    lib = _build.load_library()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = lib.pbd_dp_tree(
            comp.defw.data_ptr(), comp.anchor.data_ptr(),
            comp.bias.data_ptr(), host.data_ptr(), table.data_ptr(),
            scores.data_ptr(), tmp.data_ptr(),
            None if msg is None else msg.data_ptr(), L, P, M, H, W, stream)
    if rc != 0:
        raise RuntimeError(f"DP kernel launch failed: CUDA error {rc}")
    profiling.count("dp.launches", 2 * len(layers))


def dp_min(pdfs: torch.Tensor, comp: PackedComponent,
           compose: str = "reference", part_mask=None,
           true_size=None) -> DPResult:
    """The DP for one component on one (H, W, F) response map; fields
    come back without the level axis."""
    res = dp_min_levels(
        pdfs[None], comp, compose,
        None if part_mask is None else part_mask[None],
        None if true_size is None else
        torch.as_tensor(true_size, device=pdfs.device).reshape(1, 2))
    return DPResult(*(f[0] for f in res))


# ---------------------------------------------------------------------
# candidate-position argmax recomputation (used by ops/argmax.py and
# ops/walk.py's plain version)
# ---------------------------------------------------------------------

def _argmax_first(vals: torch.Tensor, dim: int) -> torch.Tensor:
    """First-index argmax (ties -> smallest index, like numpy)."""
    return torch.argmax(vals, dim=dim).to(torch.int32)


def _dt_vals_at(line: torch.Tensor, w2, w3, pos, off):
    """max/argmax over the last axis of line[c] - w2*d^2 - w3*d with
    d = pos + off - c.  line: (..., N); w2/w3/pos/off: line.shape[:-1]
    (or broadcastable).  Returns (max, argmax)."""
    n = line.shape[-1]
    c = torch.arange(n, dtype=torch.float32, device=line.device)
    d = (pos + off)[..., None] - c
    w2b = torch.as_tensor(w2, dtype=torch.float32)[..., None]
    w3b = torch.as_tensor(w3, dtype=torch.float32)[..., None]
    vals = line + (-w2b) * d * d + (-w3b) * d
    return vals.amax(dim=-1), _argmax_first(vals, -1)


def walk_children(scores_p: torch.Tensor, tmp_p: torch.Tensor,
                  w: torch.Tensor, anc: torch.Tensor, bias_p: torch.Tensor,
                  mp: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                  compose: str):
    """Backtracking step for one part p over a batch of levels: the
    child (x, y, mixture) given the parent's (mixture mp, y, x).

    Part p's slices are passed in: scores_p/tmp_p (L, M, H, W) are
    DPResult.scores[:, p] and .tmp[:, p]; w (M, 4), anc (M, 2) float and
    bias_p (Mc, Mp) are the component's defw[p], anchor[p] and bias[p];
    mp/py/px (L, K) int32.  Returns ((L, K) x, y, mc), int32.

    Recomputes, at the K positions only, the argmaxes the reference
    stored as full tables (src/DynamicProgram.cpp:110-151 +
    include/DistanceTransform.hpp:233-244): the child mixture, then the
    two 1-D DT argmaxes in the order of the compose mode."""
    L, K = px.shape
    M, H = tmp_p.shape[1:3]
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    li = torch.arange(L, device=px.device)[:, None]

    # -- winning child mixture: sdt(mc, py, px) for all mc.
    # tmp column at px: (L, M, H, K) -> (L, M, K, H)
    idx = px.long()[:, None, None, :].expand(L, M, H, K)
    line = torch.gather(tmp_p, 3, idx).transpose(-1, -2)
    sdt_at, _ = _dt_vals_at(
        line, w[:, 2][None, :, None], w[:, 3][None, :, None],
        pyf[:, None, :], anc[:, 1][None, :, None])     # (L, M, K)
    weighted = sdt_at + bias_p[:, mp.long()].permute(1, 0, 2)
    mc = _argmax_first(weighted, 1)                    # (L, K)
    mcl = mc.long()
    wm = w[mcl]                                        # (L, K, 4)
    am = anc[mcl]                                      # (L, K, 2)

    if compose == "reference":
        # x from the accumulated-score row at PARENT y (the reference's
        # DT compose quirk, include/DistanceTransform.hpp:233-244)
        row = scores_p[li, mcl, py.long()]             # (L, K, W)
        _, x = _dt_vals_at(row, wm[..., 0], wm[..., 1], pxf, am[..., 0])
        # y from the x-pass column at the composed x
        col = tmp_p[li, mcl, :, x.long()]              # (L, K, H)
        _, y = _dt_vals_at(col, wm[..., 2], wm[..., 3], pyf, am[..., 1])
    else:
        # y from the x-pass column at px, then x from the row at that y
        col = tmp_p[li, mcl, :, px.long()]
        _, y = _dt_vals_at(col, wm[..., 2], wm[..., 3], pyf, am[..., 1])
        row = scores_p[li, mcl, y.long()]
        _, x = _dt_vals_at(row, wm[..., 0], wm[..., 1], pxf, am[..., 0])
    return x, y, mc


def composed_tables(res: DPResult, comp: PackedComponent,
                    compose: str = "reference"):
    """Full (P, M, H, W) int32 Ix/Iy/Ik tables for one level's DPResult
    (dp_min's, fields without the level axis): for every part p > 0,
    parent mixture m and parent cell (y, x), the child's x, y and
    mixture as walk_children recomputes them (the port of
    partsbaseddetector_tpu/ops/dp.py:326-344; a test and debug helper,
    the reference a DP kernel's argmaxes are held to — no hot path
    builds these).  Part 0's rows stay zero."""
    P, M = comp.filterid.shape
    H, W = res.rootv.shape
    dev = res.rootv.device
    yy = torch.arange(H, dtype=torch.int32,
                      device=dev).repeat_interleave(W)[None]
    xx = torch.arange(W, dtype=torch.int32, device=dev).repeat(H)[None]
    anchor = comp.anchor.to(torch.float32)
    tables = torch.zeros((3, P, M, H, W), dtype=torch.int32, device=dev)
    for p in range(1, P):
        for m in range(M):
            x, y, mc = walk_children(
                res.scores[p][None], res.tmp[p][None], comp.defw[p],
                anchor[p], comp.bias[p], torch.full_like(yy, m), yy, xx,
                compose)
            for t, v in enumerate((x, y, mc)):
                tables[t, p, m] = v.reshape(H, W)
    return tables[0], tables[1], tables[2]
