"""The port's benchmark tool (``sg2im_tpu_torch.tools.bench``) held against
the JAX package's ``bench.py`` on the CPU.  ``bench.py`` is loaded by path;
the tool itself imports no JAX.

- its inputs equal ``bench.py``'s bit for bit: ``flagship_setup``'s objs,
  triples and both masks (``_measure.bench_inputs``) and every key of
  ``train_step_setup``'s batch (``profile_train.coco64``);
- its float32 forward on the CPU matches ``bench.py``'s JAX ``fwd`` at the
  full vg128 width on the same weights and noise;
- the PSNR proxy's boxes have positive extent for every live object;
- ``main`` on ``--device cpu --config tiny`` prints a last line with every
  key of ``bench.py``'s (``BENCH_r05.json``'s ``parsed``), strict JSON,
  and writes ``bench.json``, in both modes; with ``--device cuda`` and no
  card it exits 1 and runs nothing.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

from sg2im_tpu_torch.ckpt import state_dict_from_jax
from sg2im_tpu_torch.inference import InferenceEngine
from sg2im_tpu_torch.tools import _measure as M
from sg2im_tpu_torch.tools import bench as B

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The forward's bar: tests/test_torch_generator.py's for convolution
# outputs (1e-4 abs), whose sums run in another order in XLA and in
# PyTorch; at the full vg128 width the error is 1.9e-6 on images of
# magnitude up to 1.9.
FWD_BAR = 1e-4
F32_ENV = {"BENCH_BF16": "0", "BENCH_CRN_MODE": "legacy",
           "BENCH_DENSE_PRECISION": "highest"}
TINY = ["--device", "cpu", "--config", "tiny", "--iters", "1", "--repeats",
        "1"]


@pytest.fixture(scope="module")
def bench_py():
    """``bench.py`` as a module.  Its import points JAX's persistent
    compilation cache into the repo; the process's settings are put back,
    so that nothing is written there."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "bench_reference", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _f32(monkeypatch):
    """bench.py's float32 parity mode.  The inputs do not depend on the
    mode; both flagship tests take it, so that JAX compiles the eager
    init's operations once."""
    for k, v in F32_ENV.items():
        monkeypatch.setenv(k, v)


def test_flagship_forward_matches_bench_py_in_f32(bench_py, monkeypatch):
    _f32(monkeypatch)
    fwd, args = bench_py.flagship_setup(1)
    want = np.asarray(fwd(*args))
    vocab, kwargs = B.flagship_config(bf16=False, crn_mode="legacy")
    engine = InferenceEngine(vocab, kwargs, state_dict_from_jax(args[0]),
                             device="cpu")
    pfwd, pargs = B.flagship_setup(1, "cpu", engine)
    noise = torch.from_numpy(np.array(args[5])).permute(0, 3, 1, 2)
    got = pfwd(*pargs[:4], noise).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 128, 128, 3)
    err = np.abs(got - want).max()
    assert err <= FWD_BAR, err
    assert np.abs(want).max() > 100 * FWD_BAR  # not a blank image


def test_inputs_equal_bench_py(bench_py, monkeypatch):
    _f32(monkeypatch)
    _, want = bench_py.flagship_setup(2)
    _, got = B.flagship_setup(2, "cpu")
    gb = M.bench_inputs(2, B.flagship_config()[0])
    for name, w, g, host in zip(
            ("objs", "triples", "obj_mask", "triple_mask"), want[1:5],
            got[:4], (gb.objs, gb.triples, gb.obj_mask, gb.triple_mask)):
        w = np.asarray(w)
        assert host.dtype == w.dtype and np.array_equal(host, w), name
        assert np.array_equal(g.numpy(), w), name
    assert got[4].shape == (2, 32, 128, 128)
    # The JAX Trainer's eager init (half a minute here) plays no part in
    # the batch.
    from sg2im_tpu.train.trainer import Trainer as JaxTrainer

    monkeypatch.setattr(JaxTrainer, "init_state", lambda self, seed: None)
    _, _, want_b = bench_py.train_step_setup(2)
    trainer, state, got_b = B.train_step_setup(2, "cpu")
    assert trainer.config.batch_size == 2 and state is not None
    assert sorted(got_b) == sorted(want_b)
    for k, w in want_b.items():
        assert got_b[k].dtype == w.dtype and np.array_equal(got_b[k], w), k


@pytest.mark.parametrize("config", ["tiny", "vg128"])
def test_proxy_boxes_have_positive_extent(config):
    vocab, kwargs, state, graphs = B.build_proxy(config)
    engine = InferenceEngine(vocab, kwargs, state, device="cpu")
    _, boxes = B._images(engine, graphs)
    B.check_boxes(engine, graphs, boxes)
    # The check bites: a box head that outputs 0 fails it.
    head = [k for k in state if k.startswith("box_net")][-2:]
    assert [k.rsplit(".", 1)[1] for k in head] == ["weight", "bias"]
    dead = dict(state, **{k: torch.zeros_like(state[k]) for k in head})
    engine = InferenceEngine(vocab, kwargs, dead, device="cpu")
    with pytest.raises(B.BenchFailure, match="degenerate"):
        B.check_boxes(engine, graphs, B._images(engine, graphs)[1])


def _strict(text):
    def refuse(name):
        raise ValueError(f"non-finite {name} in the line")

    return json.loads(text, parse_constant=refuse)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = B.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_host_run_prints_bench_py_line(tmp_path):
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        keys = set(json.load(f)["parsed"])
    rc, out = _run(TINY + ["--out", str(tmp_path / "infer")])
    assert rc == 0 and out[0] == "cpu"
    line = _strict(out[-1])
    assert keys <= set(line), keys - set(line)
    assert line["psnr_reference"] == B.PSNR_REFERENCE
    assert line["card"] == "cpu" and line["batch"] == 128
    assert len(line["value_runs"]) == 1 and line["psnr_n_images"] == 4
    # The CPU against itself: bit-equal images, no infinity.
    assert line["psnr_db_vs_reference_f32"] is None
    assert np.isfinite(line["psnr_u8_db_vs_reference"])
    assert line["trained_gate_pass"] is True
    with open(tmp_path / "infer" / "bench.json") as f:
        assert json.load(f) == line

    rc, out = _run(TINY + ["--mode", "train", "--out",
                           str(tmp_path / "train")])
    assert rc == 0
    line = _strict(out[-1])
    assert line["metric"] == "coco64_gan_train_step"
    assert line["batch"] == 32 and len(line["value_runs"]) == 1
    assert {"value", "unit", "vs_baseline"} <= set(line)
    with open(tmp_path / "train" / "bench.json") as f:
        assert json.load(f) == line


def test_no_card_exits_1(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this holds the no-card exit")
    assert B.main(["--config", "tiny", "--out", str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert "no CUDA card" in captured.err and "{" not in captured.out
    assert not os.listdir(tmp_path)
