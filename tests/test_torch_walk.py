"""The walk's plain version vs the JAX walks, fed the same DPResult
arrays: the Pallas kernel in interpret mode (walk_tree_pallas,
interpret=True) and the XLA gather walk (backtrack_levels,
walk_impl="xla").  All results exact: the plain version is the
reference the CUDA kernel is held to on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.models import part_tree as tree_jax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.ops import argmax as argmax_jax
from partsbaseddetector_tpu.ops.dp import DPResult as DPResultJax
from partsbaseddetector_tpu.ops.walk_pallas import walk_tree_pallas
from partsbaseddetector_tpu_torch.ops import argmax as argmax_t
from partsbaseddetector_tpu_torch.ops import walk as walk_t
from partsbaseddetector_tpu_torch.ops.dp import DPResult
from partsbaseddetector_tpu_torch.utils import profiling
from test_torch_models import port_packed

torch.set_num_threads(1)

FIELDS = ("score", "valid", "component", "level", "boxes", "loc")


def _case(maker, L, H, W, K, seed, ties=False):
    """Random DPResult-shaped arrays and seeds for a model's component
    0; with ties=True the deformation weights are zero and the maps take
    a handful of values, so every argmax meets equal candidates."""
    jp = tree_jax.pack_model(getattr(syn_jax, maker)(seed=seed))
    pt = port_packed(jp)
    comp = jp.components[0]
    P, M = comp.filterid.shape
    rng = np.random.default_rng(seed)
    if ties:
        scores = rng.integers(0, 3, (L, P, M, H, W)).astype(np.float32)
        tmp = rng.integers(0, 3, (L, P, M, H, W)).astype(np.float32)
    else:
        scores = rng.standard_normal((L, P, M, H, W)).astype(np.float32)
        tmp = rng.standard_normal((L, P, M, H, W)).astype(np.float32)
    defw = np.array(comp.defw)
    bias = np.array(comp.bias)
    if ties:
        defw = np.zeros_like(defw)
        bias = np.where(bias > -1e29, 0.0, bias).astype(np.float32)
    nroot = int(np.asarray(comp.nmix)[0])
    seeds = dict(xs=rng.integers(0, W, (L, K)).astype(np.int32),
                 ys=rng.integers(0, H, (L, K)).astype(np.int32),
                 mv=rng.integers(0, nroot, (L, K)).astype(np.int32))
    arrays = dict(scores=scores, tmp=tmp, defw=defw,
                  anchor=np.array(comp.anchor, np.float32),
                  bias=bias,
                  parent=np.array(jp.parent_static[0], np.int32))
    return jp, pt, arrays, seeds


CASES = [("tiny", 3, 7, 9, 8, 0, False),
         ("person_like", 2, 9, 12, 16, 1, False),
         ("person_like", 2, 6, 8, 12, 5, True),
         ("tiny", 2, 5, 6, 10, 4, True)]


def _case_id(c):
    return f"{c[0]}-{'ties' if c[6] else 'rand'}"


# w_minor: tmp stored as the DP stores it for the kernel, (L, P, M, W, H)
# contiguous, seen through its (L, P, M, H, W) transpose
WALK_CASES = [(c, False) for c in CASES] + [(c, True) for c in CASES]


@pytest.mark.parametrize("compose", ["reference", "correct"])
@pytest.mark.parametrize("case,w_minor", WALK_CASES,
                         ids=[_case_id(c) + ("-wminor" if w else "")
                              for c, w in WALK_CASES])
def test_walk_plain_matches_pallas_interpret(case, w_minor, compose):
    _, _, a, s = _case(*case)
    ref = walk_tree_pallas(
        jnp.asarray(a["scores"]), jnp.asarray(a["tmp"]),
        jnp.asarray(s["xs"]), jnp.asarray(s["ys"]), jnp.asarray(s["mv"]),
        jnp.asarray(a["defw"]), jnp.asarray(a["anchor"]),
        jnp.asarray(a["bias"]), jnp.asarray(a["parent"]),
        compose=compose, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in {**a, **s}.items()}
    if w_minor:
        t["tmp"] = torch.from_numpy(np.ascontiguousarray(
            a["tmp"].swapaxes(-1, -2))).transpose(-1, -2)
        assert t["tmp"].transpose(-1, -2).is_contiguous()
        assert torch.equal(t["tmp"], torch.from_numpy(a["tmp"]))
    args = (t["scores"], t["tmp"], t["xs"], t["ys"], t["mv"], t["defw"],
            t["anchor"], t["bias"], t["parent"], compose)
    with profiling.tracing() as tracer:
        got = walk_t.walk_tree_plain(*args)
        wrapped = walk_t.walk_tree(*args)  # CPU tensors: the plain version
    assert "walk.launches" not in tracer.counters  # no kernel on the CPU
    for name, r, g, w in zip("XYM", ref, got, wrapped):
        assert g.dtype == torch.int32 and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
        assert torch.equal(g, w)


# the XLA walk unrolls over parts: each person-shaped case compiles for
# seconds, so those two take one compose mode each
XLA_CASES = [(CASES[0], "reference"), (CASES[0], "correct"),
             (CASES[1], "reference"), (CASES[2], "correct")]


@pytest.mark.parametrize("case,compose", XLA_CASES,
                         ids=[f"{_case_id(c)}-{m}" for c, m in XLA_CASES])
def test_backtrack_levels_matches_xla_walk(case, compose):
    maker, L, H, W, K, seed, ties = case
    jp, pt, a, _ = _case(*case)
    rng = np.random.default_rng(seed + 100)
    nroot = int(np.asarray(jp.components[0].nmix)[0])
    rootv = rng.standard_normal((L, H, W)).astype(np.float32)
    if ties:
        rootv = np.round(rootv).astype(np.float32)   # equal root scores
    rooti = rng.integers(0, nroot, (L, H, W)).astype(np.int32)
    sizes = np.array([(H, W)] + [(H - 1, W - 2)] * (L - 1), np.int32)
    scales = np.linspace(4.0, 7.3, L).astype(np.float32)
    thresh = np.float32(-0.5)
    ref = argmax_jax.backtrack_levels(
        DPResultJax(jnp.asarray(rootv), jnp.asarray(rooti),
                    jnp.asarray(a["scores"]), jnp.asarray(a["tmp"])),
        jp.components[0], jp.parent_static[0], jnp.asarray(thresh),
        jnp.asarray(scales), K, true_sizes=jnp.asarray(sizes),
        level_offset=3, compose=compose, walk_impl="xla")
    res = DPResult(torch.from_numpy(rootv), torch.from_numpy(rooti),
                   torch.from_numpy(a["scores"]),
                   torch.from_numpy(a["tmp"]))
    for impl in ("torch", "cuda", "auto"):
        got = argmax_t.backtrack_levels(
            res, pt.components[0], pt.parent_static[0],
            torch.tensor(thresh), torch.from_numpy(scales), K,
            true_sizes=torch.from_numpy(sizes), level_offset=3,
            compose=compose, walk_impl=impl)
        for f in FIELDS:
            g, r = getattr(got, f), np.asarray(getattr(ref, f))
            assert g.shape == r.shape, f
            np.testing.assert_array_equal(g.numpy(), r, err_msg=f)
    if maker == "tiny":
        # one level without the level axis: backtrack
        one = argmax_t.backtrack(
            DPResult(*(f[1] for f in res)), pt.components[0],
            pt.parent_static[0], torch.tensor(thresh), float(scales[1]), K,
            true_size=torch.from_numpy(sizes[1]), level_index=4,
            compose=compose)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(one, f).numpy(),
                np.asarray(getattr(ref, f))[K:2 * K], err_msg=f)


def test_root_seed_ties_lower_index_first():
    """lax.top_k lists the lower flat index first among equal values
    (torch.topk need not), and ranks +0.0 above -0.0."""
    rootv = torch.tensor([[[1.0, 3.0, 3.0, -0.0], [2.0, 3.0, 0.0, -0.0]]])
    rooti = torch.arange(8, dtype=torch.int32).reshape(1, 2, 4)
    topv, valid, xs, ys, mv = argmax_t._root_seeds(rootv, rooti, 1.5, 7)
    ref = argmax_jax._root_seeds(jnp.asarray(rootv.numpy()[0]),
                                 jnp.asarray(rooti.numpy()[0]), 1.5, 7)
    for g, r in zip((topv, valid, xs, ys, mv), ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    assert mv[0].tolist() == [1, 2, 5, 4, 0, 6, 3]


def test_sort_candidates_stable_and_batched():
    c = argmax_t.Candidates(
        score=torch.tensor([[1.0, 2.0, 2.0, 5.0], [0.0, 0.0, 1.0, 1.0]]),
        valid=torch.tensor([[True, True, True, False],
                            [True, True, True, True]]),
        component=torch.zeros((2, 4), dtype=torch.int32),
        level=torch.arange(8, dtype=torch.int32).reshape(2, 4),
        boxes=torch.zeros((2, 4, 1, 4)),
        loc=torch.arange(24, dtype=torch.int32).reshape(2, 4, 1, 3))
    out = argmax_t.sort_candidates(c)
    assert out.level.tolist() == [[1, 2, 0, 3], [6, 7, 4, 5]]
    ref = argmax_jax.sort_candidates(argmax_jax.Candidates(
        **{f: jnp.asarray(getattr(c, f)[0].numpy()) for f in FIELDS}))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f)[0].numpy(),
                                      np.asarray(getattr(ref, f)))


def _random_parent(seed):
    rng = np.random.default_rng(seed)
    P = int(rng.integers(1, 80))
    return [0] + [int(rng.integers(0, p)) for p in range(1, P)]


TREES = ([("tiny", None), ("person_like", None), ("face_like", None)]
         + [("random", seed) for seed in range(20)])


@pytest.mark.parametrize("maker,seed", TREES,
                         ids=[m if s is None else f"{m}-{s}"
                              for m, s in TREES])
def test_depth_layers(maker, seed):
    """The kernel's schedule: every part once, each in the layer after
    its parent's, parts ascending within a layer, depth + 1 layers."""
    if seed is None:
        jp = tree_jax.pack_model(getattr(syn_jax, maker)())
        parent = list(jp.parent_static[0])
    else:
        parent = _random_parent(seed)
    P = len(parent)
    depth = [0] * P
    for p in range(1, P):
        depth[p] = depth[parent[p]] + 1
    order, offsets = walk_t.depth_layers(torch.tensor(parent,
                                                      dtype=torch.int32))
    assert order.dtype == offsets.dtype == torch.int32
    order, offsets = order.tolist(), offsets.tolist()
    assert sorted(order) == list(range(P))
    assert len(offsets) - 1 == max(depth) + 1
    assert offsets[0] == 0 and offsets[-1] == P
    assert order[offsets[0]:offsets[1]] == [0]
    layer_of = {}
    for d in range(len(offsets) - 1):
        layer = order[offsets[d]:offsets[d + 1]]
        assert layer and layer == sorted(layer)
        layer_of.update({p: d for p in layer})
    for p in range(1, P):
        assert layer_of[p] == layer_of[parent[p]] + 1
    table, nlayers = walk_t._layer_table(tuple(parent),
                                         torch.device("cpu"))
    assert nlayers == max(depth) + 1
    assert table.tolist() == parent + offsets + order
    if maker == "person_like":
        assert [offsets[d + 1] - offsets[d] for d in range(nlayers)] == \
            [1, 4, 5, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1]


def test_depth_layers_refuses_a_child_before_its_parent():
    with pytest.raises(ValueError, match="precede"):
        walk_t.depth_layers([0, 2, 0])


def test_check_walk_args_wants_w_minor_tmp():
    """The kernel's argument check (walk_tree runs it on CUDA): tmp
    stored W-minor passes, any other storage raises, nothing is
    copied."""
    _, _, a, s = _case("tiny", 2, 5, 6, 4, 3)
    t = {k: torch.from_numpy(v) for k, v in {**a, **s}.items()}
    tmp_c = t.pop("tmp")
    tmp_w = tmp_c.transpose(-1, -2).contiguous().transpose(-1, -2)

    def check(tmp, **over):
        kw = {**t, **over}
        walk_t.check_walk_args(kw["scores"], tmp, kw["xs"], kw["ys"],
                               kw["mv"], kw["defw"], kw["anchor"],
                               kw["bias"], kw["parent"])

    check(tmp_w)
    with pytest.raises(ValueError, match="W-minor"):
        check(tmp_c)
    # a view into a wider W-minor buffer: columns contiguous, planes not
    wide = torch.zeros(tmp_c.shape[:3] + (tmp_c.shape[4] + 1,
                                          tmp_c.shape[3]))
    with pytest.raises(ValueError, match="W-minor"):
        check(wide.transpose(-1, -2)[..., :tmp_c.shape[4]])
    with pytest.raises(ValueError, match="scores is not contiguous"):
        check(tmp_w, scores=t["scores"].transpose(-1, -2).contiguous()
              .transpose(-1, -2))
    with pytest.raises(TypeError, match="parent"):
        check(tmp_w, parent=t["parent"].long())


@pytest.mark.parametrize("compose", ["reference", "correct"])
def test_walk_plain_on_aliased_dp_matches_pallas_interpret(compose):
    """The walk over the filter-keyed DP's outputs (visit-time scores,
    tests/test_aliasing.py's aliased_chain), seeded by the port's top-K:
    the plain walk equals the Pallas kernel in interpret mode bit for
    bit."""
    from partsbaseddetector_tpu_torch.ops import dp as dp_t
    from test_aliasing import aliased_chain
    jp = tree_jax.pack_model(aliased_chain(13))
    comp = port_packed(jp).components[0]
    assert comp.aliased
    rng = np.random.default_rng(8)
    pdfs = rng.standard_normal((3, 9, 12, jp.bank.shape[3])).astype(
        np.float32)
    res = dp_t.dp_min_levels(torch.from_numpy(pdfs), comp, compose)
    _, _, xs, ys, mv = argmax_t._root_seeds(res.rootv, res.rooti, -1e9, 16)
    anchor = comp.anchor.to(torch.float32)
    parent = torch.tensor(jp.parent_static[0], dtype=torch.int32)
    ref = walk_tree_pallas(
        *(jnp.asarray(t.numpy()) for t in (
            res.scores, res.tmp, xs, ys, mv, comp.defw, anchor, comp.bias,
            parent)), compose=compose, interpret=True)
    got = walk_t.walk_tree(res.scores, res.tmp, xs, ys, mv, comp.defw,
                           anchor, comp.bias, parent, compose)
    for name, r, g in zip("XYM", ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
