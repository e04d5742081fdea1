"""Port vs JAX: the max-only distance transform passes and the part-tree
DP over a batch of levels, fed the same responses and parameters.

Tolerance: ``rooti`` exact; ``rootv``, ``scores``, ``tmp`` and the DT
passes rtol 1e-6, atol 1e-5 (the penalty expression is evaluated in the
same order on both sides, so in practice they agree bit for bit; the
margin covers a compiler contracting a multiply-add on the JAX side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.models import part_tree as tree_jax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.ops import dp as dp_jax
from partsbaseddetector_tpu.ops import dt as dt_jax
from partsbaseddetector_tpu_torch.ops import dp as dp_t
from partsbaseddetector_tpu_torch.ops import dt as dt_t
from test_aliasing import aliased_chain
from test_torch_models import port_packed
from test_torch_walk import _random_parent

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-5)


def _weights(rng, M):
    w = np.stack([rng.uniform(0.01, 0.12, M), rng.uniform(-0.05, 0.05, M),
                  rng.uniform(0.01, 0.12, M), rng.uniform(-0.05, 0.05, M)],
                 axis=1).astype(np.float32)
    anc = rng.integers(-4, 5, size=(M, 2)).astype(np.int32)
    return w, anc


@pytest.mark.parametrize("shape", [(3, 9, 13), (4, 17, 11)])
def test_dt_passes(shape):
    rng = np.random.default_rng(shape[1])
    src = rng.standard_normal((2,) + shape).astype(np.float32)
    w, anc = _weights(rng, shape[0])
    ref_x = jax.vmap(jax.vmap(lambda s, wm, am: dt_jax.dt_max_x(
        s, wm[0], wm[1], am[0]), (0, 0, 0)), (0, None, None))(
            jnp.asarray(src), jnp.asarray(w), jnp.asarray(anc))
    ref_y = jax.vmap(jax.vmap(lambda s, wm, am: dt_jax.dt_max_y(
        s, wm[2], wm[3], am[1]), (0, 0, 0)), (0, None, None))(
            jnp.asarray(src), jnp.asarray(w), jnp.asarray(anc))
    s_t = torch.from_numpy(src)
    w_t, a_t = torch.from_numpy(w), torch.from_numpy(anc)
    got_x = dt_t.dt_max_x(s_t, w_t[:, 0], w_t[:, 1], a_t[:, 0])
    got_y = dt_t.dt_max_y(s_t, w_t[:, 2], w_t[:, 3], a_t[:, 1])
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), **TOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), **TOL)
    # scalar parameters
    np.testing.assert_allclose(
        dt_t.dt_max_x(s_t[0, 0], 0.05, -0.01, 2).numpy(),
        np.asarray(dt_jax.dt_max_x(jnp.asarray(src[0, 0]), 0.05, -0.01, 2)),
        **TOL)


@pytest.mark.parametrize("shape", [(3, 9, 13), (4, 17, 11)])
def test_dt_max_x_out(shape):
    """The x pass into out= (a part's slice of a buffer, as the DP writes
    tmp): the same floats as the returned map, the rest of the buffer
    untouched."""
    rng = np.random.default_rng(shape[2])
    src = rng.standard_normal((2,) + shape).astype(np.float32)
    w, anc = _weights(rng, shape[0])
    s_t = torch.from_numpy(src)
    w_t, a_t = torch.from_numpy(w), torch.from_numpy(anc)
    buf = torch.full((2, 3) + shape, float("nan"))
    got = dt_t.dt_max_x(s_t, w_t[:, 0], w_t[:, 1], a_t[:, 0], out=buf[:, 1])
    assert got.data_ptr() == buf[:, 1].data_ptr()
    assert torch.equal(buf[:, 1], dt_t.dt_max_x(s_t, w_t[:, 0], w_t[:, 1],
                                                a_t[:, 0]))
    assert torch.isnan(buf[:, 0]).all() and torch.isnan(buf[:, 2]).all()


@pytest.mark.parametrize("compose", ["reference", "correct"])
@pytest.mark.parametrize("maker,hw", [("tiny", (10, 13)),
                                      ("person_like", (12, 16))])
def test_dp_min_levels(maker, hw, compose):
    jp = tree_jax.pack_model(getattr(syn_jax, maker)(seed=2))
    pt = port_packed(jp)
    rng = np.random.default_rng(11)
    L, F = 3, jp.bank.shape[3]
    pdfs = rng.standard_normal((L,) + hw + (F,)).astype(np.float32)
    sizes = np.array([hw, (hw[0] - 2, hw[1] - 3), (hw[0] - 5, hw[1] - 4)],
                     np.int32)
    ref = dp_jax.dp_min_levels(jnp.asarray(pdfs), jp.components[0],
                               compose, true_sizes=jnp.asarray(sizes))
    got = dp_t.dp_min_levels(torch.from_numpy(pdfs), pt.components[0],
                             compose, true_sizes=torch.from_numpy(sizes))
    assert got.rooti.dtype == torch.int32
    # tmp is stored W-minor for the walk kernel (a column contiguous)
    assert got.tmp.transpose(-1, -2).is_contiguous()
    np.testing.assert_array_equal(got.rooti.numpy(), np.asarray(ref.rooti))
    for f in ("rootv", "scores", "tmp"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, err_msg=f, **TOL)
    # one level, no true size: dp_min drops the level axis
    one = dp_t.dp_min(torch.from_numpy(pdfs[0]), pt.components[0], compose)
    ref1 = dp_jax.dp_min(jnp.asarray(pdfs[0]), jp.components[0], compose)
    np.testing.assert_array_equal(one.rooti.numpy(), np.asarray(ref1.rooti))
    np.testing.assert_allclose(one.rootv.numpy(), np.asarray(ref1.rootv),
                               **TOL)


def _masks(rng, L, P, hw):
    """Random part placement masks with every (level, part) allowed
    somewhere."""
    m = rng.random((L, P) + hw) < 0.6
    m[..., 0, 0] = True
    return m


@pytest.mark.parametrize("compose", ["reference", "correct"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_dp_min_levels_aliased(compose, masked):
    """The filter-keyed DP on tests/test_aliasing.py's aliased_chain
    (parent/child and within-part filter sharing): rootv, scores (the
    visit-time values) and tmp within 1e-6, rooti exact."""
    jp = tree_jax.pack_model(aliased_chain(13))
    pt = port_packed(jp)
    assert jp.components[0].aliased and pt.components[0].aliased
    rng = np.random.default_rng(4)
    L, hw, F = 3, (9, 12), jp.bank.shape[3]
    P = jp.components[0].filterid.shape[0]
    pdfs = rng.standard_normal((L,) + hw + (F,)).astype(np.float32)
    sizes = np.array([hw, (7, 10), (5, 6)], np.int32)
    masks = _masks(rng, L, P, hw) if masked else None
    ref = dp_jax.dp_min_levels(
        jnp.asarray(pdfs), jp.components[0], compose,
        part_masks=None if masks is None else jnp.asarray(masks),
        true_sizes=jnp.asarray(sizes))
    got = dp_t.dp_min_levels(
        torch.from_numpy(pdfs), pt.components[0], compose,
        None if masks is None else torch.from_numpy(masks),
        true_sizes=torch.from_numpy(sizes))
    assert got.tmp.transpose(-1, -2).is_contiguous()
    np.testing.assert_array_equal(got.rooti.numpy(), np.asarray(ref.rooti))
    for f in ("rootv", "scores", "tmp"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("maker,hw", [("tiny", (10, 13)),
                                      ("person_like", (8, 11))])
def test_dp_min_levels_part_masks(maker, hw):
    """part_masks on the DP keyed by part slot, with and without true
    sizes; rooti exact, the maps to the module's tolerance."""
    jp = tree_jax.pack_model(getattr(syn_jax, maker)(seed=2))
    pt = port_packed(jp)
    rng = np.random.default_rng(12)
    L, F = 2, jp.bank.shape[3]
    P = jp.components[0].filterid.shape[0]
    pdfs = rng.standard_normal((L,) + hw + (F,)).astype(np.float32)
    masks = _masks(rng, L, P, hw)
    for sizes in (None, np.array([hw, (hw[0] - 3, hw[1] - 2)], np.int32)):
        ref = dp_jax.dp_min_levels(
            jnp.asarray(pdfs), jp.components[0], part_masks=jnp.asarray(masks),
            true_sizes=None if sizes is None else jnp.asarray(sizes))
        got = dp_t.dp_min_levels(
            torch.from_numpy(pdfs), pt.components[0],
            part_masks=torch.from_numpy(masks),
            true_sizes=None if sizes is None else torch.from_numpy(sizes))
        np.testing.assert_array_equal(got.rooti.numpy(),
                                      np.asarray(ref.rooti))
        for f in ("rootv", "scores", "tmp"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       err_msg=f, **TOL)


# ---------------------------------------------------------------------
# the DT/DP argmax tables (ops/dt.distance_transform*, ops/dp.
# composed_tables): integer tables exact, maxima to the module's TOL,
# on the shapes and anchors of tests/test_ops_vs_oracle.py:139-157


@pytest.mark.parametrize("shape,anchor,compose", [
    ((13, 13), (0, 0), "reference"), ((9, 14), (2, -3), "reference"),
    ((20, 7), (-5, 4), "reference"), ((12, 12), (1, 1), "correct"),
    ((9, 14), (2, -3), "correct"),
])
def test_distance_transform_tables(shape, anchor, compose):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    score = rng.standard_normal(shape).astype(np.float32) * 3
    w = np.array([0.1, -0.02, 0.07, 0.01], np.float32)
    args_j = (jnp.asarray(score), jnp.asarray(w),
              jnp.asarray(anchor, jnp.int32))
    args_t = (torch.from_numpy(score), torch.from_numpy(w),
              torch.tensor(anchor, dtype=torch.int32))
    for name, ref, got in (
            ("composed", dt_jax.distance_transform(*args_j, compose),
             dt_t.distance_transform(*args_t, compose)),
            ("raw", dt_jax.distance_transform_raw(*args_j),
             dt_t.distance_transform_raw(*args_t))):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   err_msg=name, **TOL)
        for a, b in zip(got[1:], ref[1:]):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    np.testing.assert_allclose(
        dt_t.dt_max_1d_last(args_t[0], 0.1, -0.02, anchor[0]).numpy(),
        np.asarray(dt_jax.dt_max_1d_last(args_j[0], 0.1, -0.02,
                                         anchor[0])), **TOL)


def test_dt_mixtures_raw():
    rng = np.random.default_rng(8)
    scores = rng.standard_normal((3, 9, 11)).astype(np.float32)
    w, anc = _weights(rng, 3)
    ref = dt_jax.dt_mixtures_raw(jnp.asarray(scores), jnp.asarray(w),
                                 jnp.asarray(anc))
    got = dt_t.dt_mixtures_raw(torch.from_numpy(scores), torch.from_numpy(w),
                               torch.from_numpy(anc))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("compose", ["reference", "correct"])
@pytest.mark.parametrize("maker,hw", [("tiny", (14, 17)),
                                      ("person_like", (8, 11))])
def test_composed_tables(maker, hw, compose):
    """The full Ix/Iy/Ik tables, built on each package's walk from the
    same DP inputs, equal."""
    jp = tree_jax.pack_model(getattr(syn_jax, maker)(seed=5))
    pt = port_packed(jp)
    rng = np.random.default_rng(5)
    pdfs = rng.standard_normal(hw + (jp.bank.shape[3],)).astype(np.float32)
    ref = dp_jax.composed_tables(
        dp_jax.dp_min(jnp.asarray(pdfs), jp.components[0], compose),
        jp.components[0], compose)
    got = dp_t.composed_tables(
        dp_t.dp_min(torch.from_numpy(pdfs), pt.components[0], compose),
        pt.components[0], compose)
    for name, a, b in zip(("Ix", "Iy", "Ik"), got, ref):
        assert a.dtype == torch.int32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


# ---------------------------------------------------------------------
# the DP kernel's host side (ops/dp.py: dp_schedule, its table, the
# argument check, the device dispatch); the kernel itself runs on the
# card only, where chip_smoke.py holds it to dp_min_levels_plain

def _dp_inputs(maker, seed, masked):
    """Seeded responses, true sizes and (optionally) part masks for one
    group of 3 levels at 9x12; maker "aliased" is test_aliasing's
    aliased_chain (the filter-keyed DP)."""
    model = (aliased_chain(13) if maker == "aliased"
             else getattr(syn_jax, maker)(seed=2))
    comp = port_packed(tree_jax.pack_model(model)).components[0]
    rng = np.random.default_rng(seed)
    L, hw = 3, (9, 12)
    F = int(comp.filterid.max()) + 1
    pdfs = rng.standard_normal((L,) + hw + (F,)).astype(np.float32)
    sizes = np.array([hw, (7, 10), (5, 6)], np.int32)
    masks = _masks(rng, L, comp.nparts, hw) if masked else None
    return comp, torch.from_numpy(pdfs), torch.from_numpy(sizes), (
        None if masks is None else torch.from_numpy(masks))


def _digest(res) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in res:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


#: sha256 (first 16 hex digits) of rootv, rooti, scores and tmp, as the
#: eager chain computed them before the DP kernel (ops/dp.py with the x
#: pass stored H-minor, then one permuted copy), on _dp_inputs
BEFORE_KERNEL = {
    ("person_like", False): "fc15008a507a7c84",
    ("person_like", True): "3bee1146980cb2e7",
    ("aliased", False): "60b72d6ec6de3501",
    ("aliased", True): "675c57ae6595d332",
}


@pytest.mark.parametrize("maker,masked", list(BEFORE_KERNEL))
def test_dp_min_levels_cpu_is_the_plain_chain(maker, masked):
    """On CPU tensors dp_min_levels runs the plain chain: bit for bit the
    results of the eager chain before the kernel, on the part-keyed and
    the filter-keyed branches, with and without part masks; tmp comes
    back stored W-minor."""
    comp, pdfs, sizes, masks = _dp_inputs(maker, 21, masked)
    assert comp.aliased == (maker == "aliased")
    got = dp_t.dp_min_levels(pdfs, comp, "reference", masks, sizes)
    plain = dp_t.dp_min_levels_plain(pdfs, comp, "reference", masks, sizes)
    for f, a, b in zip(got._fields, got, plain):
        assert torch.equal(a, b), f
    assert got.tmp.transpose(-1, -2).is_contiguous()
    assert _digest(got) == BEFORE_KERNEL[maker, masked]


def _tree(maker, seed):
    if seed is None:
        return tuple(tree_jax.pack_model(
            getattr(syn_jax, maker)()).parent_static[0])
    return tuple(_random_parent(seed))


DP_TREES = ([("tiny", None), ("person_like", None), ("face_like", None)]
            + [("random", seed) for seed in range(12)])


@pytest.mark.parametrize("maker,seed", DP_TREES,
                         ids=[m if s is None else f"{m}-{s}"
                              for m, s in DP_TREES])
def test_dp_schedule_against_a_tree_walk(maker, seed):
    """The kernel's launch schedule: the depths from the deepest to 1,
    every non-root part once, in the layer of its depth; a layer's
    groups are its parents ascending, each with all its children,
    descending; the table csrc/dp.cu reads decodes to the same."""
    parent = _tree(maker, seed)
    P = len(parent)
    depth, children = [0] * P, {}
    for p in range(1, P):                  # a walk down the tree
        depth[p] = depth[parent[p]] + 1
        children.setdefault(parent[p], []).append(p)
    layers = dp_t.dp_schedule(parent)
    assert len(layers) == max(depth)
    seen = []
    for i, layer in enumerate(layers):
        d = max(depth) - i
        parents = [q for q, _ in layer]
        assert parents == sorted(parents)
        assert set(parents) == {parent[p] for p in range(1, P)
                                if depth[p] == d}
        for q, kids in layer:
            assert list(kids) == sorted(children[q], reverse=True)
            assert all(depth[c] == d for c in kids)
            seen += kids
    assert sorted(seen) == list(range(1, P))
    host, dev, top = dp_t._schedule_table(layers, torch.device("cpu"))
    assert top == P - 1
    t = host.tolist()
    assert torch.equal(host, dev) and host.dtype == torch.int32
    nl, ng, npart = t[:3]
    lay, grp = t[3:3 + 4 * nl], t[3 + 4 * nl:3 + 4 * nl + 3 * ng]
    parts = t[3 + 4 * nl + 3 * ng:]
    assert (nl, npart, len(parts)) == (len(layers), P - 1, P - 1)
    decoded = []
    for i in range(nl):
        plo, phi, glo, ghi = lay[4 * i:4 * i + 4]
        groups = tuple((grp[3 * g], tuple(parts[grp[3 * g + 1]:
                                                 grp[3 * g + 2]]))
                       for g in range(glo, ghi))
        assert parts[plo:phi] == [c for _, kids in groups for c in kids]
        decoded.append(groups)
    assert tuple(decoded) == layers
    if maker == "person_like":
        assert [sum(len(k) for _, k in layer) for layer in layers] == \
            [1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 5, 4]


@pytest.mark.parametrize("maker", ["tiny", "person_like", "face_like"])
def test_dp_schedule_order_is_the_plain_loop(maker):
    """The part steps taken in the kernel's order (a depth's x passes,
    then each group's messages added in its order) give the plain loop's
    scores and tmp bit for bit: the order the kernel relies on."""
    comp, pdfs, sizes, _ = _dp_inputs(maker, 22, False)
    ref = dp_t.dp_min_levels(pdfs, comp, "reference", true_sizes=sizes)
    P = comp.nparts
    scores = torch.where(
        comp.mix_valid[None, :, :, None, None]
        & dp_t._inbounds(9, 12, sizes)[:, None, None],
        pdfs.movedim(-1, 1)[:, comp.filterid.long()], dp_t.NEG)
    tmp = torch.zeros_like(scores)
    w, anc = comp.defw, comp.anchor
    for layer in dp_t.dp_schedule(comp.parent_static):
        for _, kids in layer:
            for c in kids:
                tmp[:, c] = dt_t.dt_max_x(scores[:, c], w[c, :, 0],
                                          w[c, :, 1], anc[c, :, 0])
        for q, kids in layer:
            for c in kids:
                sdt = dt_t.dt_max_y(tmp[:, c], w[c, :, 2], w[c, :, 3],
                                    anc[c, :, 1])
                scores[:, q] += (sdt[:, None] + comp.bias[c].T[
                    None, :, :, None, None]).amax(dim=2)
    assert torch.equal(scores, ref.scores) and torch.equal(tmp, ref.tmp)
    assert P > 1


def _kernel_args(L=2, P=3, M=4, H=5, W=7):
    """Arguments check_dp_args accepts: scores contiguous, tmp W-minor."""
    return dict(
        scores=torch.zeros((L, P, M, H, W)),
        tmp=torch.zeros((L, P, M, W, H)).transpose(-1, -2),
        defw=torch.zeros((P, M, 4)),
        anchor=torch.zeros((P, M, 2), dtype=torch.int32),
        bias=torch.zeros((P, M, M)),
        msg=torch.zeros((L, M, H, W)))


REFUSALS = {
    "scores float64": (dict(scores=torch.zeros((2, 3, 4, 5, 7),
                                               dtype=torch.float64)),
                       TypeError, "scores has dtype"),
    "anchor float32": (dict(anchor=torch.zeros((3, 4, 2))), TypeError,
                       "anchor has dtype"),
    "bias shape": (dict(bias=torch.zeros((3, 4, 3))), ValueError,
                   "bias has shape"),
    "scores rank": (dict(scores=torch.zeros((2, 3, 4, 5))), ValueError,
                    "scores has shape"),
    "msg shape": (dict(msg=torch.zeros((2, 3, 5, 7))), ValueError,
                  "msg has shape"),
    "scores not contiguous": (
        dict(scores=torch.zeros((2, 3, 4, 7, 5)).transpose(-1, -2)),
        ValueError, "scores is not contiguous"),
    "tmp H-minor": (dict(tmp=torch.zeros((2, 3, 4, 5, 7))), ValueError,
                    "W-minor"),
    "defw on another device": (dict(defw=torch.zeros((3, 4, 4),
                                                     device="meta")),
                               ValueError, "defw is on meta"),
    "17 mixtures": (dict(_M=17), ValueError, "at most 16"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_check_dp_args_refuses(case):
    """The kernel wrapper's check, once a call: dtype, shape, storage,
    device and the mixture count; the arguments it is handed otherwise
    pass."""
    change, exc, match = REFUSALS[case]
    dp_t.check_dp_args(**_kernel_args())
    args = _kernel_args(M=change["_M"]) if "_M" in change else \
        {**_kernel_args(), **change}
    with pytest.raises(exc, match=match):
        dp_t.check_dp_args(**args)


def test_dp_refuses_other_devices():
    """dp_min_levels runs on CUDA (the kernel) or the CPU (the plain
    chain) and raises for any other device; dp_tree, the kernel's
    wrapper, takes CUDA tensors only."""
    comp, pdfs, sizes, _ = _dp_inputs("tiny", 23, False)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        dp_t.dp_min_levels(pdfs.to("meta"), comp, "reference")
    a = _kernel_args(P=comp.nparts, M=comp.maxmix)
    with pytest.raises(ValueError, match="runs on CUDA"):
        dp_t.dp_tree(a["scores"], a["tmp"], comp,
                     dp_t.dp_schedule(comp.parent_static))
