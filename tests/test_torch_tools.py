"""The port's last CLIs and tools against the JAX package's, on the CPU:
``cli.sample_images``, ``cli.checkpoint_tools``, ``cli.preprocess_vg``,
``utils.vis`` and ``run_model``'s ``--draw_scene_graphs``,
``--deprocess_device``, ``--dense_precision`` and ``--noise_impl``.

Checkpoints are the port's own (``tests/test_train.py``'s ``TINY``
generator from the port's seeded init, at ``layout_noise_dim`` 0, so that
neither package draws noise), written in the reference layout or as a
checkpoint directory of the port's Trainer.  The dataset is
``tests/test_data.py``'s synthetic COCO; batches of 3 over 4 images leave a
partial last batch.  Both CLIs build the dataset without a seed, as
upstream does, so its heuristic triples come from Python's global
``random``: each run starts from ``random.seed(0)``.

Bars: PNGs within 1 u8 level (the deprocess rounds a float32 image whose
convolutions sum in another order), ``data.npz`` arrays within 1e-5; the
checkpoint tools' dicts, the preprocess outputs and the layout drawings
equal.
"""

import dataclasses
import json
import os
import random

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sg2im_tpu.ckpt.torch_convert import (
    convert_checkpoint,
    convert_generator_state,
)
from sg2im_tpu.cli import checkpoint_tools as jax_tools
from sg2im_tpu.cli import preprocess_vg as jax_pre
from sg2im_tpu.cli import run_model as jax_run_model
from sg2im_tpu.cli import sample_images as jax_sample
from sg2im_tpu.utils import vis as jax_vis
from sg2im_tpu_torch.ckpt import export_reference_checkpoint
from sg2im_tpu_torch.cli import checkpoint_tools as tools
from sg2im_tpu_torch.cli import preprocess_vg as pre
from sg2im_tpu_torch.cli import run_model
from sg2im_tpu_torch.cli import sample_images
from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.trainer import Trainer
from sg2im_tpu_torch.utils import vis
from test_data import _fake_coco
from test_preprocess_vg import _fake_raw_vg, _flags
from test_train import TINY, VOCAB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = TrainConfig(**dict(TINY, layout_noise_dim=0))


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,ref,extra", [
    (sample_images, jax_sample, {"device"}),
    (run_model, jax_run_model, {"device"}),
    (pre, jax_pre, set()),
])
def test_parsers_have_every_jax_flag(port, ref, extra):
    a, b = _actions(port.build_parser()), _actions(ref.build_parser())
    assert set(a) - set(b) == extra and set(b) <= set(a)
    for dest, r in b.items():
        assert a[dest].option_strings == r.option_strings, dest
        assert a[dest].choices == r.choices, dest
        if dest != "splits_json":  # the port reads its own copy
            assert a[dest].default == r.default, dest
    if port is pre:
        with open(a["splits_json"].default) as f1, open(os.path.join(
                REPO, "sg2im_tpu", "data", "vg_splits.json")) as f2:
            assert json.load(f1) == json.load(f2)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """The synthetic COCO, the generator for its vocabulary as a
    reference-layout .pt, and a checkpoint directory of the port's
    Trainer holding the same generator."""
    from sg2im_tpu_torch.data.coco import CocoSceneGraphDataset

    root = str(tmp_path_factory.mktemp("coco"))
    img_dir, inst, stuff = _fake_coco(root)
    vocab = CocoSceneGraphDataset(image_dir=img_dir, instances_json=inst,
                                  stuff_json=stuff, image_size=(16, 16),
                                  mask_size=4).vocab
    trainer = Trainer(CONFIG, vocab, device="cpu")
    state = trainer.init_state(seed=0)
    pt = os.path.join(root, "gen.pt")
    export_reference_checkpoint(pt, state.g, CONFIG.generator_kwargs(),
                                vocab, args=dataclasses.asdict(CONFIG))
    native = os.path.join(root, "native")
    trainer.save_checkpoint(state, native)
    flags = ["--dataset", "coco", "--coco_image_dir", img_dir,
             "--instances_json", inst, "--stuff_json", stuff,
             "--image_size", "16,16", "--batch_size", "3",
             "--num_samples", "4", "--loader_num_workers", "1",
             "--save_gt_imgs", "1"]
    return {"root": root, "pt": pt, "native": native, "flags": flags,
            "state": state, "vocab": vocab}


def _pngs(d):
    names = sorted(os.listdir(d))
    return names, np.stack([np.asarray(Image.open(os.path.join(d, n)))
                            for n in names])


def _sample(mod, flags):
    random.seed(0)
    return mod.main(flags)


def _compare_dirs(port_dir, jax_dir):
    """Same PNG names everywhere, images within 1 u8, data.npz within
    1e-5."""
    for sub in ("img", "gt_img"):
        (n1, a), (n2, b) = (_pngs(os.path.join(d, sub))
                            for d in (port_dir, jax_dir))
        assert n1 == n2
        assert np.abs(a.astype(int) - b).max() <= 1, sub
    with np.load(os.path.join(port_dir, "data.npz")) as p, \
            np.load(os.path.join(jax_dir, "data.npz")) as j:
        assert set(p.files) == set(j.files)
        for k in j.files:
            assert p[k].shape == j[k].shape, k
            np.testing.assert_allclose(p[k], j[k], atol=1e-5, err_msg=k)
        return {k: p[k] for k in p.files}


@pytest.mark.parametrize("mode", [[], ["--model_mode", "train",
                                       "--use_gt_boxes", "1",
                                       "--use_gt_masks", "1"]])
def test_sample_images_matches_jax(coco, tmp_path, mode):
    flags = coco["flags"] + mode + ["--checkpoint", coco["pt"]]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _sample(sample_images, flags + ["--device", "cpu",
                                           "--output_dir", port]) == 0
    assert _sample(jax_sample, flags + ["--output_dir", ref]) == 0
    data = _compare_dirs(port, ref)
    assert len(os.listdir(os.path.join(port, "img"))) == 4
    assert data["boxes_pred"].shape[0] == 4  # truncated to the images
    assert {"masks_pred", "masks_gt", "objs"} <= set(data)


def test_sample_images_noise_matches_jax(coco, tmp_path):
    """A generator that takes layout noise: both CLIs draw it as
    ``split(PRNGKey(--seed))`` per batch, the port on its device through
    the threefry kernel's wrapper, so the images agree as without noise
    (the last batch padded, and a seed that is not 0)."""
    config = TrainConfig(**dict(TINY, layout_noise_dim=4))
    state = Trainer(config, coco["vocab"], device="cpu").init_state(seed=1)
    pt = str(tmp_path / "noisy.pt")
    export_reference_checkpoint(pt, state.g, config.generator_kwargs(),
                                coco["vocab"], args=dataclasses.asdict(config))
    flags = coco["flags"] + ["--checkpoint", pt, "--seed", "3"]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _sample(sample_images, flags + ["--device", "cpu",
                                           "--output_dir", port]) == 0
    assert _sample(jax_sample, flags + ["--output_dir", ref]) == 0
    _compare_dirs(port, ref)
    other = str(tmp_path / "other")
    assert _sample(sample_images, coco["flags"] + [
        "--checkpoint", pt, "--seed", "4", "--device", "cpu",
        "--output_dir", other]) == 0
    assert not np.array_equal(_pngs(os.path.join(port, "img"))[1],
                              _pngs(os.path.join(other, "img"))[1])


def test_sample_images_checkpoint_list_and_native_store(coco, tmp_path):
    """A snapshot directory (two snapshots) and a .pt in one list, against
    the JAX CLI; the port's native checkpoint directory gives the bytes
    its exported .pt gives."""
    snaps = tmp_path / "snaps"
    snaps.mkdir()
    for tag in ("0000002", "0000004"):
        os.link(coco["pt"], snaps / f"snapshot_{tag}.pt")
    lst = tmp_path / "list.txt"
    lst.write_text(f"{snaps}\n{coco['pt']}\n")
    flags = coco["flags"] + ["--checkpoint_list", str(lst)]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _sample(sample_images, flags + ["--device", "cpu",
                                           "--output_dir", port]) == 0
    assert _sample(jax_sample, flags + ["--output_dir", ref]) == 0
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref)) == [
        "result000_0000002", "result000_0000004", "result001"]
    for n in names:
        _compare_dirs(os.path.join(port, n), os.path.join(ref, n))
    nat = str(tmp_path / "native")
    assert _sample(sample_images, coco["flags"] + [
        "--checkpoint", coco["native"], "--device", "cpu",
        "--output_dir", nat]) == 0
    for sub in ("img", "gt_img"):
        a = _pngs(os.path.join(nat, sub))
        # The list's first run started from the same random state.
        b = _pngs(os.path.join(port, "result000_0000002", sub))
        assert a[0] == b[0] and np.array_equal(a[1], b[1])


# -- checkpoint_tools ---------------------------------------------------------

def _pt_with_deprecated(coco, tmp_path):
    ck = torch.load(coco["pt"], weights_only=True)
    ck["model_kwargs"] = dict(ck["model_kwargs"], vec_noise_dim=0,
                              gconv_mode="feedforward")
    ck["d_obj_state"] = {"w": torch.ones(2)}
    ck["d_obj_kwargs"] = {"arch": "C3-8-2"}
    ck["losses"] = {"total_loss": [1.0, 2.0]}
    path = str(tmp_path / "full.pt")
    torch.save(ck, path)
    return path


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, dict)
                                  and isinstance(b, dict))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("cmd", ["print_args", "strip", "strip_no_d",
                                 "clean"])
def test_checkpoint_tools_match_jax(coco, tmp_path, capsys, cmd):
    src = _pt_with_deprecated(coco, tmp_path)
    if cmd == "print_args":
        assert tools.main(["print_args", src]) == 0
        mine = capsys.readouterr().out
        assert jax_tools.main(["print_args", src]) == 0
        assert mine == capsys.readouterr().out and "mask_size: 4" in mine
        assert tools.main(["print_args", coco["native"]]) == 0
        assert "mask_size: 4" in capsys.readouterr().out
        return
    sub = "clean" if cmd == "clean" else "strip"
    extra = ["--keep_discriminators", "0"] if cmd == "strip_no_d" else []
    mine, ref = str(tmp_path / "mine.pt"), str(tmp_path / "ref.pt")
    assert tools.main([sub, src, mine] + extra) == 0
    assert jax_tools.main([sub, src, ref] + extra) == 0
    _same(torch.load(mine, weights_only=True),
          torch.load(ref, weights_only=False))
    # Both refuse a native directory.
    assert tools.main([sub, coco["native"], mine]) == 1


def test_checkpoint_tools_export_reads_in_the_jax_converter(coco, tmp_path):
    out = str(tmp_path / "exported.pt")
    assert tools.main(["export", coco["native"], out]) == 0
    bundle = convert_checkpoint(out)
    want = convert_generator_state({k: v for k, v in coco["state"].g.items()})
    got_leaves = jax.tree_util.tree_leaves_with_path(bundle["generator"])
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in got_leaves:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(want_leaves[path]))
    assert bundle["vocab"] == coco["vocab"]
    assert bundle["model_kwargs"]["mask_size"] == 4
    assert bundle["args"]["gconv_dim"] == CONFIG.gconv_dim
    assert tools.main(["export", str(tmp_path), out]) == 1  # no state.pt


# -- preprocess_vg ------------------------------------------------------------

def test_preprocess_vg_matches_jax(tmp_path):
    paths = _fake_raw_vg(str(tmp_path))
    outs = {}
    for name, mod in (("port", pre), ("jax", jax_pre)):
        d = str(tmp_path / name)
        os.makedirs(d)
        assert mod.main(_flags(paths, d)) == 0
        outs[name] = d
    with open(os.path.join(outs["port"], "vocab.json")) as f1, \
            open(os.path.join(outs["jax"], "vocab.json")) as f2:
        assert json.load(f1) == json.load(f2)
    for split in ("train", "val", "test"):
        with h5py.File(os.path.join(outs["port"], f"{split}.h5")) as a, \
                h5py.File(os.path.join(outs["jax"], f"{split}.h5")) as b:
            assert set(a) == set(b)
            for k in b:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# -- vis ----------------------------------------------------------------------

def _render(mod, *args, **kw):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(2, 2), dpi=50)
    mod.draw_layout(*args, **kw)
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def test_vis_matches_jax():
    rng = np.random.RandomState(0)
    objs = np.array([1, 2, 3, 0])
    lo = rng.uniform(0, 0.5, (4, 2))
    boxes = np.concatenate([lo, lo + 0.3], 1)
    masks = rng.rand(4, 8, 8)
    for kw in ({}, {"masks": masks, "show_boxes": True},
               {"masks": masks, "bgcolor": "white"}):
        a = _render(vis, VOCAB, objs, boxes, **kw)
        b = _render(jax_vis, VOCAB, objs, boxes, **kw)
        assert a.shape == b.shape and np.array_equal(a, b), kw
    names = ["cat", "dog", "sky", "__image__"]
    assert np.array_equal(vis.draw_layout_array(boxes, names, 40, 30),
                          jax_vis.draw_layout_array(boxes, names, 40, 30))
    assert vis.have_graphviz() == jax_vis.have_graphviz()


# -- run_model's new flags ----------------------------------------------------

CKPT = os.path.join(REPO, "artifacts", "trained_coco64.pt")
GRAPHS = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")


def _run(tmp_path, name, *flags):
    out = str(tmp_path / name)
    rc = run_model.main(["--checkpoint", CKPT, "--scene_graphs_json",
                         GRAPHS, "--output_dir", out, "--device", "cpu",
                         "--noise", "zeros"] + list(flags))
    return rc, out


def test_run_model_jax_flags(tmp_path, capsys):
    rc, plain = _run(tmp_path, "plain")
    assert rc == 0
    rc, dev = _run(tmp_path, "dev", "--deprocess_device", "1",
                   "--dense_precision", "highest", "--draw_scene_graphs",
                   "1")
    assert rc == 0
    out = capsys.readouterr().out
    a, b = _pngs(plain), _pngs(dev)
    assert np.array_equal(a[1], b[1][:len(a[0])])
    sgs = [n for n in os.listdir(dev) if n.startswith("sg")]
    if vis.have_graphviz():
        assert len(sgs) == len(a[0])
    else:
        assert "WARNING: graphviz 'dot' not found" in out and not sgs
    assert _run(tmp_path, "high", "--dense_precision", "high")[0] == 1
    assert "true float32" in capsys.readouterr().out
    assert _run(tmp_path, "rbg", "--noise_impl", "rbg")[0] == 1
    assert "no single reference" in capsys.readouterr().out
    rc, tf = _run(tmp_path, "threefry", "--noise_impl", "threefry")
    assert rc == 0 and np.array_equal(_pngs(tf)[1], a[1])
