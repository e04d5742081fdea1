"""A configuration's weights from the seed.

The arithmetic of the port's synthetic models
(partsbaseddetector_tpu_torch/models/synthetic.make_model, frozen here):
a random tree in which a part hangs from the previous one or, with
probability ``branching``, from any earlier part; filters N(0, 0.05)
with the truncation channel -|.| / 2; deformations w0, w2 in [0.01,
0.12), w1, w3 in [-0.05, 0.05); anchors in [-4, 4]; biases in [-0.2,
0.2).  The root's deformation and anchor are zero.  Drawn on the device
in a few calls, in float32, the type the port serves them in.

A configuration is one part tree (the keys ``nparts``, ``nmixtures``,
``root_nmixtures``, ``branching``) or a list of them under
``components`` (the views of a multi-view model), each with those keys
and optionally ``parent``, a published tree, in place of the seeded one.
Filter, deformation and bias ids run component by component, part by
part, mixture by mixture.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port.core.seeds import torch_gen


def components(cfg: Dict) -> List[Dict]:
    """The configuration's part trees: its ``components``, each taking
    the top-level keys it does not set, or the one top-level tree."""
    keys = ("nparts", "nmixtures", "root_nmixtures", "branching")
    top = {k: cfg[k] for k in keys if k in cfg}
    return [dict(top, **c) for c in cfg.get("components", [{}])]


def _tree(comp: Dict, u: List[List[float]]) -> List[int]:
    P = comp["nparts"]
    if "parent" in comp:
        parent = list(comp["parent"])
        if (len(parent) != P or parent[0] != -1
                or any(not 0 <= parent[p] < p for p in range(1, P))):
            raise ValueError(f"parent {parent}: the root first, each "
                             "part after its parent")
        return parent
    parent = [-1]
    for p in range(1, P):
        if p == 1 or u[0][p] > comp["branching"]:
            parent.append(p - 1)
        else:
            parent.append(min(int(u[1][p] * p), p - 1))
    return parent


def model_arrays(cfg: Dict, seed: int, device) -> Dict:
    """{"trees": [(parent [P], nmix [P]) per component], "filters" (F,
    fs, fs, C), "defw" (F, 4), "anchors" (F, 2) int64, "biasw" (nb,)}
    on device."""
    g = torch_gen(seed, "weights", device)
    comps = components(cfg)
    trees = []
    for c in comps:
        P, K, K0 = c["nparts"], c["nmixtures"], c["root_nmixtures"]
        u = torch.rand((2, P), generator=g, device=device).cpu().tolist()
        trees.append((_tree(c, u), [K0] + [K] * (P - 1)))
    fs, C = cfg["filter_size"], cfg["flen"]
    nf = sum(sum(nmix) for _, nmix in trees)
    nb = sum(nmix[0] + sum(nmix[p] * nmix[parent[p]]
                           for p in range(1, len(parent)))
             for parent, nmix in trees)
    filters = torch.randn((nf, fs, fs, C), generator=g,
                          device=device) * 0.05
    filters[..., C - 1] = -filters[..., C - 1].abs() * 0.5
    lo = torch.tensor([0.01, -0.05, 0.01, -0.05], device=device)
    hi = torch.tensor([0.12, 0.05, 0.12, 0.05], device=device)
    defw = lo + (hi - lo) * torch.rand((nf, 4), generator=g, device=device)
    anchors = torch.randint(-4, 5, (nf, 2), generator=g, device=device)
    f = 0
    for _, nmix in trees:
        defw[f:f + nmix[0]] = 0.0
        anchors[f:f + nmix[0]] = 0
        f += sum(nmix)
    biasw = torch.rand(nb, generator=g, device=device) * 0.4 - 0.2
    return dict(trees=trees, filters=filters, defw=defw, anchors=anchors,
                biasw=biasw)
