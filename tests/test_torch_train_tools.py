"""Port vs JAX: the training tools on the CPU — datasets, evaluation
metrics, the foreign-format converters, the train / evaluate /
model_transfer / annotate CLIs and the training views of utils/viz.

Everything here is numpy on the host except the two CLIs that detect
(run with --device cpu): datasets, metrics, converted models, written
files and rendered views are equal bit for bit; the training CLI's model
is held to the JAX CLI's within the trainer's end-to-end tolerance
(tests/test_torch_train.py); the evaluation CLI prints the same JSON."""

import json
import os

import numpy as np
import pytest
import scipy.io
import torch

from partsbaseddetector_tpu.models import matio as matio_jax
from partsbaseddetector_tpu.models import npzio as npzio_jax
from partsbaseddetector_tpu.models import synthetic as syn_jax
from partsbaseddetector_tpu.models import transfer_formats as tf_jax
from partsbaseddetector_tpu.tools import annotate as annotate_jax
from partsbaseddetector_tpu.tools import datasets as ds_jax
from partsbaseddetector_tpu.tools import evaluate as evaluate_jax
from partsbaseddetector_tpu.tools import model_transfer as transfer_jax
from partsbaseddetector_tpu.tools import train as train_cli_jax
from partsbaseddetector_tpu.train import cluster as cluster_jax
from partsbaseddetector_tpu.utils import eval as eval_jax
from partsbaseddetector_tpu.utils import viz as viz_jax
from partsbaseddetector_tpu_torch.models import npzio as npzio_t
from partsbaseddetector_tpu_torch.models import synthetic as syn_t
from partsbaseddetector_tpu_torch.models import transfer_formats as tf_t
from partsbaseddetector_tpu_torch.tools import annotate as annotate_t
from partsbaseddetector_tpu_torch.tools import datasets as ds_t
from partsbaseddetector_tpu_torch.tools import evaluate as evaluate_t
from partsbaseddetector_tpu_torch.tools import model_transfer as transfer_t
from partsbaseddetector_tpu_torch.tools import train as train_cli_t
from partsbaseddetector_tpu_torch.train import cluster as cluster_t
from partsbaseddetector_tpu_torch.utils import eval as eval_t
from partsbaseddetector_tpu_torch.utils import viz as viz_t
from test_model_io import _save_face_fixture
from test_torch_model_io import assert_same_model
from test_torch_train import assert_close_weights

torch.set_num_threads(1)

DATASETS = {"jax": ds_jax, "port": ds_t}


def assert_same_samples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.image.dtype == y.image.dtype
        assert np.array_equal(x.image, y.image)
        assert np.array_equal(x.points, y.points)
        assert x.scale == y.scale


# -------------------------------------------------------------- datasets

@pytest.mark.parametrize("gen,kw", [
    ("synthetic_figures", dict(n=5, imsize=(64, 64), nparts=3, seed=2)),
    ("synthetic_skeletons", dict(n=4, seed=7))])
def test_synthetic_generators_equal(gen, kw):
    pt, nt = getattr(ds_t, gen)(**kw)
    pj, nj = getattr(ds_jax, gen)(**kw)
    assert_same_samples(pt, pj)
    assert len(nt) == len(nj)
    for a, b in zip(nt, nj):
        assert np.array_equal(a, b)
    assert ds_t.PERSON26_PARENTS == ds_jax.PERSON26_PARENTS
    assert ds_t.PERSON26_MIRROR == ds_jax.PERSON26_MIRROR


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_files_cross_packages(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    pos, _ = ds_t.synthetic_figures(n=3, imsize=(48, 40), nparts=2, seed=1)
    path = str(tmp_path / "ds.npz")
    DATASETS[writer].save_dataset(path, pos)
    got = DATASETS[reader].load_dataset(path)
    assert_same_samples(got, DATASETS[writer].load_dataset(path))
    assert_same_samples(got, pos)


def test_parse_directory_loads_alike(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(3)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
                        ).save(tmp_path / f"im{i}.png")
    scipy.io.savemat(str(tmp_path / "labels.mat"),
                     {"ptsAll": rng.uniform(2, 28, (4, 2, 2))})
    got = ds_t.load_dataset(str(tmp_path))
    assert len(got) == 2 and got[0].points.shape == (4, 2)
    assert_same_samples(got, ds_jax.load_dataset(str(tmp_path)))


# --------------------------------------------------------------- metrics

def test_metrics_equal():
    rng = np.random.default_rng(4)
    n, P = 6, 5
    pred = [rng.uniform(0, 50, (P, 2)) for _ in range(n)]
    gt = [p + rng.normal(0, 8, (P, 2)) for p in pred]
    scales = rng.uniform(10, 30, n)
    got = eval_t.pck(pred, gt, scales, 0.5)
    assert np.array_equal(got, eval_jax.pck(pred, gt, scales, 0.5))
    rec = np.sort(rng.uniform(0, 1, 9))
    prec = rng.uniform(0, 1, 9)
    assert eval_t.voc_ap(rec, prec) == eval_jax.voc_ap(rec, prec)
    for p in range(P):
        scores = rng.normal(size=(n, 2))
        dets = {m: [m.KeypointDetection(i, float(s), pred[i][p])
                    for i in range(n) for s in scores[i]]
                for m in (eval_t, eval_jax)}
        gts = {m: [m.KeypointGT(points=gt[i][p:p + 1], scale=scales[i])
                   for i in range(n)] for m in (eval_t, eval_jax)}
        a = eval_t.apk(dets[eval_t], gts[eval_t], 0.5)
        b = eval_jax.apk(dets[eval_jax], gts[eval_jax], 0.5)
        assert a[0] == b[0]
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])


# ------------------------------------------------------------ converters

def _struct(**fields):
    return _structs([fields])


def _structs(rows):
    dt = np.dtype([(k, object) for k in rows[0]])
    out = np.empty((1, len(rows)), dtype=dt)
    for i, r in enumerate(rows):
        for k, v in r.items():
            out[0, i][k] = v
    return out


def _save_voc_fixture(path):
    """Minimal VOC-release-style grammar model: two components (each
    followed by its mirror, which the converter skips), roots and parts
    reached through deformation rules onto terminal filter symbols."""
    rng = np.random.default_rng(1)
    nf = 5
    filters = _structs([{"w": rng.standard_normal((4, 4, 32))}
                        for _ in range(nf)])
    # symbols, 1-based: 1 = start, 2f+2 = filter f's deformation rule,
    # 2f+3 = filter f's terminal
    sym = [{"type": "N", "filter": np.zeros((0, 0))}]
    for f in range(nf):
        sym.append({"type": "N", "filter": np.zeros((0, 0))})
        sym.append({"type": "T", "filter": np.array([[float(f + 1)]])})
    rules = np.empty((1, len(sym)), dtype=object)
    for i in range(len(sym)):
        rules[0, i] = np.zeros((0, 0))
    for f in range(nf):
        s = 2 + 2 * f
        rules[0, s - 1] = _structs([{
            "def": _struct(w=rng.normal(0, 0.05, (1, 4))),
            "rhs": np.array([[float(s + 1)]])}])

    def start_rule(bias, syms, anchors):
        cell = np.empty((1, len(anchors)), dtype=object)
        for i, a in enumerate(anchors):
            cell[0, i] = np.array([a], float)
        return {"offset": _struct(w=np.array([[bias]])),
                "rhs": np.array([syms], float), "anchor": cell}

    c0 = start_rule(0.5, [2, 4, 6], [[0, 0, 0], [1, 2, 0], [3, 1, 0]])
    c1 = start_rule(-0.2, [8, 10], [[0, 0, 0], [2, 2, 0]])
    rules[0, 0] = _structs([c0, c0, c1, c1])
    scipy.io.savemat(path, {"model": _struct(
        sbin=np.array([[8.0]]), interval=np.array([[10.0]]),
        start=np.array([[1.0]]), rules=rules, symbols=_structs(sym),
        filters=filters)})


FOREIGN = {"voc": _save_voc_fixture, "face": _save_face_fixture}


@pytest.mark.parametrize("fmt", ["voc", "face"])
def test_load_foreign_equal(tmp_path, fmt):
    path = str(tmp_path / f"{fmt}.mat")
    FOREIGN[fmt](path)
    got = tf_t.load_foreign(path, fmt, "conv")
    assert type(got).__module__.startswith("partsbaseddetector_tpu_torch")
    assert got.ncomponents == 2
    assert_same_model(got, tf_jax.load_foreign(path, fmt, "conv"))


@pytest.mark.parametrize("src,extra", [
    ("model.mat", []), ("voc.mat", ["--from-format", "voc"]),
    ("face.mat", ["--from-format", "face", "--name", "f"])])
def test_model_transfer_writes_the_same_file(tmp_path, capsys, src, extra):
    path = str(tmp_path / src)
    if src == "model.mat":
        matio_jax.save_mat(path, syn_jax.tiny(seed=2))
    else:
        FOREIGN[src.split(".")[0]](path)
    outs = {}
    for name, cli in (("port", transfer_t), ("jax", transfer_jax)):
        out = str(tmp_path / f"{name}.xml")
        assert cli.main([path, out] + extra) == 0
        with open(out, "rb") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(" -> ")[1].split(" ", 1)[1] == \
        lines[1].split(" -> ")[1].split(" ", 1)[1]


# ------------------------------------------------------------------ CLIs

TRAIN_ARGS = ["synthetic:4", "--parents", "0,1", "--iters", "1",
              "--nmix", "1", "--interval", "3", "--overlap", "0.35",
              "--C", "0.05", "--name", "cli"]


@pytest.fixture(scope="module")
def cli_models(tmp_path_factory):
    """The training CLI of each package on the same arguments, once."""
    d = tmp_path_factory.mktemp("cli")
    paths = {"port": str(d / "port.npz"), "jax": str(d / "jax.npz")}
    assert train_cli_t.main([TRAIN_ARGS[0], paths["port"]] + TRAIN_ARGS[1:]
                            + ["--device", "cpu"]) == 0
    assert train_cli_jax.main([TRAIN_ARGS[0], paths["jax"]]
                              + TRAIN_ARGS[1:]) == 0
    return paths


def test_train_cli_matches_jax(cli_models):
    mt = npzio_t.load_npz(cli_models["port"])
    mj = npzio_jax.load_npz(cli_models["jax"])
    assert mt.components[0].nparts == 2 and mt.name == "cli"
    assert_close_weights(mt, mj)


def test_evaluate_cli_prints_the_same_json(cli_models, tmp_path, capsys):
    pos, _ = ds_t.synthetic_figures(n=3, nparts=2, seed=9)
    data = str(tmp_path / "eval.npz")
    ds_t.save_dataset(data, pos)
    args = [cli_models["jax"], data, "--apk", "--thresh=-1e9",
            "--k-per-level", "8"]
    assert evaluate_t.main(args + ["--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert evaluate_jax.main(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port == ref
    assert port["nimages"] == 3 and len(port["apk_per_part"]) == 2


def test_clis_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_cli_t.main(["synthetic:2", str(tmp_path / "m.npz"),
                          "--parents", "0,1"])
    model = str(tmp_path / "m.npz")
    npzio_t.save_npz(model, syn_t.tiny(seed=1))
    data = str(tmp_path / "d.npz")
    ds_t.save_dataset(data, ds_t.synthetic_figures(n=2, nparts=4)[0])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluate_t.main([model, data])


# ----------------------------------------------------------------- views

def _cluster_views(viz, cluster, ds, out_dir):
    pos, _ = ds.synthetic_figures(n=8, imsize=(64, 64), nparts=2, seed=4)
    points = np.stack([s.points for s in pos])
    boxes = cluster.point_to_box(points, [-1, 0])
    idx = cluster.cluster_parts(cluster.data_def(points, boxes, (5, 5)),
                                [2, 2], [-1, 0], restarts=5, seed=0)
    out = viz.show_part_clusters([s.image for s in pos], boxes, idx,
                                 patch_size=24, out_dir=out_dir)
    files = {}
    for root, _, names in os.walk(out_dir):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                files[os.path.relpath(os.path.join(root, n), out_dir)] = \
                    f.read()
    return out, files


W = np.random.default_rng(0).standard_normal((3, 4, 32))
VIEWS = {
    "fold_hog": lambda v, s: v.fold_hog(W),
    "hog_picture": lambda v, s: v.hog_picture(
        np.abs(v.fold_hog(W)), bs=10),
    "visualize_filter": lambda v, s: v.visualize_filter(W, bs=12),
    "visualize_model": lambda v, s: v.visualize_model(
        s.person_like(seed=3), bs=8, mixture=1),
    "visualize_hog_weights": lambda v, s: v.visualize_hog_weights(
        W, bs=10),
    "visualize_skeleton": lambda v, s: v.visualize_skeleton(
        s.person_like(seed=3)),
}


@pytest.mark.parametrize("view", sorted(VIEWS) + ["show_part_clusters"])
def test_training_views_equal(tmp_path, view):
    if view == "show_part_clusters":
        got, files_t = _cluster_views(viz_t, cluster_t, ds_t,
                                      str(tmp_path / "port"))
        ref, files_j = _cluster_views(viz_jax, cluster_jax, ds_jax,
                                      str(tmp_path / "jax"))
        assert sorted(got) == sorted(ref) and files_t == files_j
        assert any(k.endswith(".png") for k in files_t)
        for key in got:
            assert np.array_equal(got[key], ref[key])
        return
    got = VIEWS[view](viz_t, syn_t)
    ref = VIEWS[view](viz_jax, syn_jax)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


# -------------------------------------------------------------- annotate

def test_annotate_empty_directory_fails_alike(tmp_path, capsys):
    codes = []
    for cli in (annotate_t, annotate_jax):
        with pytest.raises(SystemExit) as ei:
            cli.main([str(tmp_path), str(tmp_path / "out.npz"),
                      "--parts", "2"])
        codes.append(ei.value.code)
    err = capsys.readouterr().err
    assert codes == [2, 2] and err.count("no images in") == 2


def _annotate(mod, paths, monkeypatch):
    """annotate_images under matplotlib's Agg backend, the clicks and
    keys of a user fed to each figure when it is shown: two parts
    clicked and one undone on the first image, then 'n'; a click and
    'q' on the second."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backend_bases import KeyEvent, MouseEvent
    script = [[(5.0, 6.0), (12.0, 9.0), "u", (14.0, 3.0), "n"],
              [(3.0, 3.0), "q"]]
    shown = []

    def show():
        fig = plt.gcf()
        ax = fig.axes[0]
        fig.canvas.draw()
        for step in script[len(shown)]:
            if isinstance(step, str):
                ev = KeyEvent("key_press_event", fig.canvas, step)
            else:
                x, y = ax.transData.transform(step)
                ev = MouseEvent("button_press_event", fig.canvas, x, y, 1)
            fig.canvas.callbacks.process(ev.name, ev)
        shown.append(ax.get_title())

    monkeypatch.setattr(plt, "show", show)
    samples = mod.annotate_images(paths, 2, names=["head", "foot"])
    plt.close("all")
    return samples, shown


def test_annotate_images_under_agg(tmp_path, monkeypatch):
    from PIL import Image
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    got, titles_t = _annotate(annotate_t, paths, monkeypatch)
    ref, titles_j = _annotate(annotate_jax, paths, monkeypatch)
    # the 'q' on the second image stops before the third
    assert len(titles_t) == 2 and titles_t == titles_j
    assert len(got) == 1 and got[0].points.shape == (2, 2)
    np.testing.assert_allclose(got[0].points, [[5.0, 6.0], [14.0, 3.0]],
                               atol=1e-6)
    assert_same_samples(got, ref)
