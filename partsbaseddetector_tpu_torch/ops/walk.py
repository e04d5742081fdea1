"""The fused backtracking walk: the CUDA kernel and its plain version.

``walk_tree`` replaces partsbaseddetector_tpu/ops/walk_pallas.py:
walk_tree_pallas, with its signature: the whole root-to-leaf walk of
one (bucket, dp group, component), for every level and every root
seed, in one launch of ``csrc/walk.cu``.  For CUDA tensors it launches
the kernel or raises; for CPU tensors it runs ``walk_tree_plain``, the
root-to-leaf loop over ops/dp.walk_children (argmax.backtrack's walk).
The two are bit-identical: the kernel rounds every operation of the
candidate expression as eager PyTorch does, and its argmaxes are
first-wins.

The kernel walks the tree one depth at a time (``depth_layers``) and
reads ``tmp`` stored W-minor, so that a column is contiguous:
ops/dp.dp_min_levels returns it so, and ``walk_tree`` refuses any other
storage on CUDA rather than copy it.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import torch

from partsbaseddetector_tpu_torch.ops import _build
from partsbaseddetector_tpu_torch.ops.dp import walk_children

#: kernel launches since import (or since a caller reset it to 0); the
#: plain version does not count
LAUNCHES = 0

_COMPOSE = {"reference": 0, "correct": 1}


def walk_tree_plain(scores, tmp, xs, ys, mv, defw, anchor, bias, parent,
                    compose: str = "reference"):
    """Plain PyTorch walk; same arguments and results as walk_tree."""
    if compose not in _COMPOSE:
        raise ValueError(compose)
    xv, yv, mvv = [xs], [ys], [mv]
    for p, q in enumerate(parent.tolist()[1:], start=1):
        # parents precede children, so part q's row is already walked
        x, y, m = walk_children(scores[:, p], tmp[:, p], defw[p],
                                anchor[p], bias[p], mvv[q], yv[q], xv[q],
                                compose)
        xv.append(x)
        yv.append(y)
        mvv.append(m)
    return (torch.stack(xv, dim=1), torch.stack(yv, dim=1),
            torch.stack(mvv, dim=1))


def depth_layers(parent: Union[Sequence[int], torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parts of a tree in depth order, the kernel's schedule.

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
def _layer_table(parent: Tuple[int, ...], device: torch.device):
    """(table, nlayers) for the kernel: table is parent, then
    depth_layers' offsets, then its order, int32 on ``device``."""
    order, offsets = depth_layers(parent)
    table = torch.cat([torch.tensor(parent, dtype=torch.int32), offsets,
                       order]).to(device)
    return table, offsets.numel() - 1


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def check_walk_args(scores, tmp, xs, ys, mv, defw, anchor, bias, parent):
    """Raise unless the arguments are what the kernel takes: devices,
    dtypes and shapes as walk_tree documents them; every tensor
    contiguous except tmp, which must be stored W-minor
    (tmp.transpose(-1, -2) contiguous); the maps 8-byte aligned; parent
    on the CPU or on the maps' device."""
    L, P, M, H, W = scores.shape
    K = xs.shape[-1]
    dev = scores.device
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
            ("scores", scores, f32, (L, P, M, H, W)),
            ("tmp", tmp, f32, (L, P, M, H, W)),
            ("xs", xs, i32, (L, K)), ("ys", ys, i32, (L, K)),
            ("mv", mv, i32, (L, K)), ("defw", defw, f32, (P, M, 4)),
            ("anchor", anchor, f32, (P, M, 2)),
            ("bias", bias, f32, (P, M, M))):
        _check(name, t, dtype, shape, dev)
        if name == "tmp":
            if not t.transpose(-1, -2).is_contiguous():
                raise ValueError(
                    "tmp is not stored W-minor: the kernel reads "
                    "tmp.transpose(-1, -2) as a contiguous (L, P, M, W, H) "
                    "tensor (ops/dp.dp_min_levels returns tmp so)")
        elif not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if name in ("scores", "tmp") and t.data_ptr() % 8:
            raise ValueError(f"{name} is not 8-byte aligned")
    _check("parent", parent, i32, (P,),
           parent.device if parent.device.type == "cpu" else dev)


def walk_tree(scores: torch.Tensor, tmp: torch.Tensor, xs: torch.Tensor,
              ys: torch.Tensor, mv: torch.Tensor, defw: torch.Tensor,
              anchor: torch.Tensor, bias: torch.Tensor,
              parent: torch.Tensor, compose: str = "reference"):
    """Fused walk for one (bucket, group, component).

    scores/tmp: (L, P, M, H, W) f32 (DPResult fields; on CUDA tmp stored
    W-minor, as dp_min_levels returns it); xs/ys/mv: (L, K) int32 root
    seeds; defw (P, M, 4) f32; anchor (P, M, 2) f32; bias (P, M, M) f32;
    parent (P,) int32, parent[p] < p, on the CPU (the kernel's layer
    table is built from it on the host, once per tree and device) or on
    the maps' device (then read back, which waits for the device).
    Returns (X, Y, Mm) each (L, P, K) int32 (part 0 = the seeds)."""
    global LAUNCHES
    if scores.device.type == "cpu":
        return walk_tree_plain(scores, tmp, xs, ys, mv, defw, anchor, bias,
                               parent, compose)
    if scores.device.type != "cuda":
        raise ValueError(f"walk_tree runs on CUDA or the CPU, not "
                         f"{scores.device}")
    if compose not in _COMPOSE:
        raise ValueError(compose)
    check_walk_args(scores, tmp, xs, ys, mv, defw, anchor, bias, parent)
    L, P, M, H, W = scores.shape
    K = xs.shape[-1]
    dev = scores.device
    table, nlayers = _layer_table(tuple(parent.tolist()), dev)
    lib = _build.load_library()
    X = torch.empty((L, P, K), dtype=torch.int32, device=dev)
    Y = torch.empty_like(X)
    Mm = torch.empty_like(X)
    if L == 0 or K == 0:
        return X, Y, Mm
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pbd_walk_tree(
            scores.data_ptr(), tmp.data_ptr(), xs.data_ptr(),
            ys.data_ptr(), mv.data_ptr(), defw.data_ptr(),
            anchor.data_ptr(), bias.data_ptr(), table.data_ptr(),
            table.data_ptr() + 4 * P, X.data_ptr(), Y.data_ptr(),
            Mm.data_ptr(), L, P, M, H, W, K, nlayers, _COMPOSE[compose],
            stream)
    if rc != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return X, Y, Mm
