"""Port parity: the int8 turbo serving tier of sg2im_tpu_torch against the
JAX package's (sg2im_tpu/nn/crn.py _conv_int8 and friends,
sg2im_tpu/inference.py calibration), on the CPU.

* The primitives are bit-identical: int8 weights and their scales, the
  activation quantization (ties round half to even), the int8 conv.
* The JAX tier tests of tests/test_quant.py, ported, with the same model.
* The two engines share tag sets and calibration files, and with the
  same weights, scales and explicit noise give images that agree.  Where
  the frameworks round an upstream value differently, quantization moves
  an int8 activation by an LSB or more; measured on the CPU (torch
  2.13.0, numpy-seeded inputs): float32 'legacy' compute, 0 flipped
  activations on the small model and at most 0.34% per tensor on the
  learned checkpoint (61.0 dB u8); bf16 / 'split' compute, 6-21% on the
  small model (49.1 dB) and 4-14% on the learned checkpoint (44.2 dB),
  from the two frameworks' different bf16 convolutions.  Bars: float32,
  at most 1% flipped per tensor and 55 dB; bf16 / 'split', 40 dB (the JAX
  package's gate).
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import core as flax_core
from flax import traverse_util

from sg2im_tpu.ckpt.torch_convert import convert_checkpoint
from sg2im_tpu.inference import InferenceEngine as JaxEngine
from sg2im_tpu.models import Sg2ImGenerator as JaxGenerator
from sg2im_tpu.nn import crn as jcrn
from sg2im_tpu.nn import layers as jlayers
from sg2im_tpu_torch.ckpt import calibration_from_jax, state_dict_from_jax
from sg2im_tpu_torch.inference import InferenceEngine
from sg2im_tpu_torch.models import Sg2ImGenerator
from sg2im_tpu_torch.nn import crn as tcrn
from sg2im_tpu_torch.nn import layers as tlayers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "trained_coco64.pt")
GRAPHS = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")

# The model of tests/test_quant.py: CRN stages at 16 / 32 / 64 px, two in
# the default band.
VOCAB = {
    "object_idx_to_name": ["__image__", "a", "b", "c"],
    "object_name_to_idx": {"__image__": 0, "a": 1, "b": 2, "c": 3},
    "pred_idx_to_name": ["__in_image__", "by", "above"],
    "pred_name_to_idx": {"__in_image__": 0, "by": 1, "above": 2},
}
MODEL_KWARGS = dict(image_size=(64, 64), embedding_dim=16, gconv_dim=24,
                    gconv_hidden_dim=32, gconv_num_layers=2,
                    refinement_dims=(32, 16, 8), normalization="batch",
                    activation="leakyrelu-0.2", mask_size=4,
                    layout_noise_dim=6)
SG = [{"objects": ["a", "b"], "relationships": [[0, "by", 1]]},
      {"objects": ["c"], "relationships": []}]
BF16 = dict(compute_dtype=torch.bfloat16, crn_mode="split")
TURBO = dict(BF16, quantize="int8")
PSNR_BF16 = 40.0
PSNR_F32 = 55.0
FLIP_SHARE_F32 = 0.01


def psnr_u8(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def jax_variables(**overrides):
    kw = dict(MODEL_KWARGS, **overrides)
    gen = JaxGenerator(vocab=VOCAB, **kw)
    H, W = kw["image_size"]
    noise = (jnp.zeros((1, H, W, kw["layout_noise_dim"]), jnp.float32)
             if kw["layout_noise_dim"] else None)
    return gen.init({"params": jax.random.PRNGKey(0)},
                    jnp.zeros((1, 4), jnp.int32),
                    jnp.zeros((1, 3, 3), jnp.int32),
                    jnp.ones((1, 4), jnp.float32),
                    jnp.ones((1, 3), jnp.float32), train=False,
                    layout_noise=noise)


@pytest.fixture(scope="module")
def variables():
    return jax_variables()


@pytest.fixture(scope="module")
def state(variables):
    return state_dict_from_jax(variables)


def engine(state, kwargs=MODEL_KWARGS, **kw):
    return InferenceEngine(VOCAB, kwargs, state, device="cpu", **kw)


def imgs(out):
    return out["imgs"].float().numpy()


def jax_tags(jax_engine):
    return sorted(traverse_util.flatten_dict(
        flax_core.unfreeze(jax_engine._expected_quant_tree()), sep="/"))


# -- primitives ---------------------------------------------------------------

def test_quant_weight_int8_is_bit_identical():
    rng = np.random.RandomState(0)
    k = (rng.randn(3, 3, 20, 7) * 0.1).astype(np.float32)
    k[..., 3] = 0.0  # a zero channel: the 1e-30 floor
    kq_j, sw_j = jcrn._quant_weight_int8(jnp.asarray(k))
    kq_t, sw_t = tcrn._quant_weight_int8(
        torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))))
    assert kq_t.dtype == torch.int8
    np.testing.assert_array_equal(kq_t.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(kq_j))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))


def test_quant_act_is_bit_identical_with_ties():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 6, 4) * 3).astype(np.float32)
    for s in (np.float32(0.25), np.float32(np.abs(x).max() / 127.0),
              np.float32(0.0123)):
        want = np.asarray(jcrn._quant_act(jnp.asarray(x), jnp.asarray(s)))
        got = tcrn._quant_act(torch.from_numpy(x), torch.tensor(s))
        np.testing.assert_array_equal(got.numpy(), want)
    # Exact ties k + 1/2 round half to even, and clip at +-127.
    ties = (np.arange(-140, 140, dtype=np.float32) + 0.5) * 0.25
    want = np.asarray(jcrn._quant_act(jnp.asarray(ties), jnp.float32(0.25)))
    got = tcrn._quant_act(torch.from_numpy(ties), torch.tensor(0.25))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[140].item() == 0 and got[141].item() == 2  # 0.5, 1.5
    assert got.min().item() == -127 and got.max().item() == 127


def test_conv_int8_is_bit_identical():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 7, 12).astype(np.float32)
    k = (rng.randn(3, 3, 12, 5) * 0.1).astype(np.float32)
    s = np.float32(np.abs(x).max() / 127.0)
    want = np.asarray(jcrn._conv_int8(
        jcrn._quant_act(jnp.asarray(x), s), jnp.asarray(k), s))
    xq = tcrn._quant_act(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.tensor(s))
    got = tcrn._conv_int8(
        xq, torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
        torch.tensor(s))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (1, 7, 1, 3)])
def test_upsample_nearest_int8_is_exact(shape):
    x = torch.randint(-127, 128, shape, dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest")
    got = tlayers.upsample_nearest(x, 2)
    assert got.dtype == torch.int8
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = torch.nn.functional.interpolate(x.float(), scale_factor=2,
                                           mode="nearest")
    assert torch.equal(got.float(), want)
    jwant = jlayers.upsample_nearest(jnp.asarray(x.permute(0, 2, 3, 1)
                                                 .numpy()), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jwant))


def test_act_scales_calibrate_and_serve():
    scales = tcrn.ActScales()
    with pytest.raises(RuntimeError, match="not calibrated"):
        scales("t", torch.ones(2))
    scales.values, scales.calibrating = {}, True
    assert scales("t", torch.tensor([-2.54, 1.0])).item() == \
        np.float32(2.54) / np.float32(127)
    # The running max is stored; the fresh batch value is used.
    fresh = scales("t", torch.tensor([1.27]))
    assert fresh.item() == np.float32(1.27) / np.float32(127)
    assert scales.values["t"].item() == np.float32(2.54) / np.float32(127)
    assert scales("z", torch.zeros(3)).item() == np.float32(1e-30)
    scales.calibrating = False
    assert scales("t", torch.ones(1)).item() == \
        np.float32(2.54) / np.float32(127)
    assert scales.values["z"].item() == 0.0
    assert scales("z", torch.ones(1)).item() == np.float32(1e-30)


# -- the JAX tier tests, ported ----------------------------------------------

def test_quant_state_dict_matches_unquantized(state):
    base = Sg2ImGenerator(VOCAB, **MODEL_KWARGS).state_dict()
    quant = Sg2ImGenerator(VOCAB, crn_quant="int8", crn_mode="split",
                           compute_dtype=torch.bfloat16,
                           **MODEL_KWARGS).state_dict()
    assert [(k, v.shape) for k, v in base.items()] == \
        [(k, v.shape) for k, v in quant.items()]
    assert set(base) == set(state)
    eng = engine(state, **TURBO)  # strict load of the JAX-mapped weights
    eng.calibrate(SG, noise="zeros")
    assert set(eng.model.state_dict()) == set(base)


def test_quant_engine_output_bounded_vs_bf16(state):
    _, out_f = engine(state, **BF16).generate(SG, noise="zeros")
    _, out_q = engine(state, **TURBO).generate(SG, noise="zeros")
    a, b = imgs(out_f), imgs(out_q)
    rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-12)
    assert 0 < rel < 0.35, rel
    # Geometry heads are untouched by the CRN tier: boxes bit-identical.
    assert torch.equal(out_f["boxes"], out_q["boxes"])
    assert torch.equal(out_f["masks"], out_q["masks"])


def test_quant_low_res_stages_unquantized():
    kw = dict(MODEL_KWARGS, image_size=(16, 16), refinement_dims=(16, 8),
              layout_noise_dim=0)
    st = state_dict_from_jax(jax_variables(image_size=(16, 16),
                                           refinement_dims=(16, 8),
                                           layout_noise_dim=0))
    _, out_f = engine(st, kw, **BF16).generate(SG, seed=1)
    q = engine(st, kw, **TURBO)
    _, out_q = q.generate(SG, seed=1)
    assert torch.equal(out_f["imgs"], out_q["imgs"])
    assert q.calibrated and q.scales() == {}


def test_quant_calibration_lifecycle(state):
    eng = engine(state, **TURBO)
    assert not eng.calibrated
    eng.calibrate(SG, noise="zeros")
    assert eng.calibrated
    scales = eng.scales()
    assert scales and all(s >= 0 for s in scales.values())
    assert any(s > 0 for s in scales.values())
    # The serving program is deterministic.
    _, o1 = eng.generate(SG, noise="zeros")
    _, o2 = eng.generate(SG, noise="zeros")
    assert torch.equal(o1["imgs"], o2["imgs"])
    # Re-calibration is a running max: same data -> same scales; other
    # data can only raise them.
    eng.calibrate(SG, noise="zeros")
    assert eng.scales() == scales
    eng.calibrate(SG, noise=np.full((2, 64, 64, 6), 3.0, np.float32))
    grown = eng.scales()
    assert all(grown[k] >= scales[k] for k in scales)
    assert any(grown[k] > scales[k] for k in scales)
    # Auto-calibration: a fresh engine calibrates on its first batch and
    # serves statically from the second on.
    eng2 = engine(state, **TURBO)
    _, a1 = eng2.generate(SG, noise="zeros")
    assert eng2.calibrated and eng2.scales() == scales
    assert torch.equal(a1["imgs"], o1["imgs"])  # valid turbo output
    _, a2 = eng2.generate(SG, noise="zeros")
    assert torch.equal(a2["imgs"], o1["imgs"])
    # calibrate() on an engine without the tier is an error.
    with pytest.raises(ValueError, match="quantize"):
        engine(state, **BF16).calibrate(SG)


@pytest.mark.parametrize("mode", ["packed", "phase"])
def test_quant_refuses_packed_and_phase(state, mode):
    """The JAX package asserts the same (nn/crn.py): int8 quantizes the
    legacy and split conv0 forms only."""
    with pytest.raises(ValueError, match="int8"):
        Sg2ImGenerator(VOCAB, crn_quant="int8", crn_mode=mode,
                       **MODEL_KWARGS)
    with pytest.raises(ValueError, match="int8"):
        engine(state, quantize="int8", crn_mode=mode)


def test_quant_zero_scale_warning():
    with pytest.warns(UserWarning, match="ZERO activation scale"):
        InferenceEngine._warn_zero_scales({"a/act_up": 0.0, "a/act_mid": 0.5})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        InferenceEngine._warn_zero_scales({"a/act_up": 0.1})


def test_quant_opts(state):
    with pytest.raises(ValueError, match="quant_opts"):
        engine(state, quant_opts={"head": False})
    with pytest.raises(ValueError, match="unknown quant_opts"):
        engine(state, quantize="int8", quant_opts={"stage": 3})
    with pytest.raises(ValueError, match="quantize"):
        engine(state, quantize="int4")
    eng = engine(state, quantize="int8")
    assert eng.model_kwargs["crn_quant_max_res"] == 64
    assert eng.quant_band() == {"head": None, "min_res": None, "max_res": 64}
    eng_h = engine(state, quantize="int8", quant_opts={"head": False})
    assert eng_h.model_kwargs["crn_quant_max_res"] == 64  # merged, kept
    assert eng_h.model_kwargs["crn_quant_head"] is False
    eng_r = engine(state, quantize="int8", quant_opts={"max_res": None})
    assert "crn_quant_max_res" not in eng_r.model_kwargs
    # Every stage exempt: bit-identical to the unquantized engine.
    none = engine(state, **TURBO, quant_opts={"max_res": 8})
    a = none.generate(SG, noise="zeros")[1]["imgs"]
    b = engine(state, **BF16).generate(SG, noise="zeros")[1]["imgs"]
    assert torch.equal(a, b)


def test_calibration_save_load_roundtrip(state, tmp_path):
    eng_a = engine(state, **TURBO)
    eng_a.calibrate(SG)
    out_a = eng_a.generate(SG, noise="zeros")[1]["imgs"]
    path = tmp_path / "cal.json"
    eng_a.save_calibration(path)
    eng_b = engine(state, **TURBO)
    assert not eng_b.calibrated
    eng_b.load_calibration(path)
    assert eng_b.calibrated and eng_b.scales() == eng_a.scales()
    for k, v in eng_a.model.refinement_net.act_scales.values.items():
        assert torch.equal(v, eng_b.model.refinement_net.act_scales.values[k])
    assert torch.equal(eng_b.generate(SG, noise="zeros")[1]["imgs"], out_a)


def test_calibration_file_validation(state, tmp_path):
    eng = engine(state, **TURBO)
    path = tmp_path / "cal.json"
    with pytest.raises(ValueError, match="not calibrated"):
        eng.save_calibration(path)
    plain = engine(state)
    with pytest.raises(ValueError, match="quantize='int8'"):
        plain.save_calibration(path)
    with pytest.raises(ValueError, match="quantize='int8'"):
        plain.load_calibration(path)
    eng.calibrate(SG)
    eng.save_calibration(path)
    payload = json.loads(path.read_text())
    bad = tmp_path / "bad.json"

    band = engine(state, **TURBO, quant_opts={"max_res": None})
    with pytest.raises(ValueError, match="band"):
        band.load_calibration(path)
    assert not band.calibrated
    fresh = engine(state, **TURBO)
    for edit, match in (
            (lambda p: p["scales"].pop(sorted(p["scales"])[0]), "missing"),
            (lambda p: p["scales"].update({"x/act_mid": 1.0}), "unexpected"),
            (lambda p: p.update({"format": "something_else"}), "format")):
        p = json.loads(json.dumps(payload))
        edit(p)
        bad.write_text(json.dumps(p))
        with pytest.raises(ValueError, match=match):
            fresh.load_calibration(bad)
        assert not fresh.calibrated
    p = json.loads(json.dumps(payload))
    p["scales"][sorted(p["scales"])[0]] = 0.0
    bad.write_text(json.dumps(p))
    with pytest.warns(UserWarning, match="ZERO activation scale"):
        fresh.load_calibration(bad)


def test_run_model_cli_turbo(tmp_path):
    from PIL import Image

    from sg2im_tpu_torch.cli.run_model import main

    with open(GRAPHS) as f:
        graphs = json.load(f)
    eng = InferenceEngine.from_torch_checkpoint(CKPT, device="cpu",
                                                quantize="int8")
    eng.calibrate(graphs[:4], noise="zeros")
    cal = tmp_path / "cal.json"
    eng.save_calibration(cal)
    args = ["--checkpoint", CKPT, "--scene_graphs_json", GRAPHS,
            "--noise", "zeros", "--device", "cpu", "--output_dir",
            str(tmp_path / "out")]
    assert main(args + ["--calibration_file", str(cal)]) == 1
    assert main(args + ["--quantize", "int8", "--calibration_file",
                        str(cal)]) == 0
    want, _ = eng.generate(graphs, noise="zeros")
    for i in range(len(graphs)):
        got = np.asarray(Image.open(tmp_path / "out" / f"img{i:06d}.png"))
        np.testing.assert_array_equal(got, want[i])


# -- against the JAX engine ---------------------------------------------------

@pytest.mark.parametrize("opts", [None, {"max_res": None}, {"head": False},
                                  {"min_res": 16, "max_res": 32}])
def test_expected_tags_equal_jax(variables, state, opts):
    j = JaxEngine(VOCAB, MODEL_KWARGS, variables, quantize="int8",
                  quant_opts=opts)
    t = engine(state, quantize="int8", quant_opts=opts)
    assert t.expected_quant_tags() == jax_tags(j)
    assert t.quant_band() == j._quant_band()


def test_expected_tags_equal_jax_vg128_depth():
    """Five stages at 128 px, the vg128 band: s3 and s4 quantized, the
    head exempt, four tags."""
    kw = dict(MODEL_KWARGS, image_size=(128, 128),
              refinement_dims=(16, 12, 8, 6, 4), layout_noise_dim=0)
    v = jax_variables(image_size=(128, 128),
                      refinement_dims=(16, 12, 8, 6, 4), layout_noise_dim=0)
    j = JaxEngine(VOCAB, kw, v, quantize="int8")
    t = InferenceEngine(VOCAB, kw, state_dict_from_jax(v), device="cpu",
                        quantize="int8")
    assert t.expected_quant_tags() == jax_tags(j) == [
        "refinement_net/refinement_modules_2/act_mid",
        "refinement_net/refinement_modules_2/act_out",
        "refinement_net/refinement_modules_2/layer0/act_up",
        "refinement_net/refinement_modules_3/act_mid"]


def test_calibration_files_interchange_with_jax(variables, state, tmp_path):
    j = JaxEngine(VOCAB, MODEL_KWARGS, variables, quantize="int8",
                  compute_dtype=jnp.bfloat16, crn_mode="split")
    j.calibrate(SG)
    j_file = tmp_path / "jax.json"
    j.save_calibration(str(j_file))
    t = engine(state, **TURBO)
    t.load_calibration(j_file)
    assert t.scales() == calibration_from_jax(
        jax.device_get(j.variables["quant"]))
    t_file = tmp_path / "port.json"
    t.save_calibration(t_file)
    assert t_file.read_bytes() == j_file.read_bytes()
    # The reverse: a file the port calibrated and saved loads into JAX.
    t2 = engine(state, **TURBO)
    t2.calibrate(SG, noise="zeros")
    t2.save_calibration(t_file)
    j2 = JaxEngine(VOCAB, MODEL_KWARGS, variables, quantize="int8",
                   compute_dtype=jnp.bfloat16, crn_mode="split")
    j2.load_calibration(str(t_file))
    assert calibration_from_jax(jax.device_get(j2.variables["quant"])) == \
        t2.scales()


def _flip_recorders(monkeypatch):
    """Record every int8 activation both packages quantize (the JAX engine
    run eagerly under jax.disable_jit)."""
    rec = {"jax": [], "port": []}
    j_quant, t_quant = jcrn._quant_act, tcrn._quant_act

    def jax_rec(x, s):
        y = j_quant(x, s)
        if not isinstance(y, jax.core.Tracer):
            rec["jax"].append(np.asarray(y))
        return y

    def port_rec(x, s):
        y = t_quant(x, s)
        rec["port"].append(y.permute(0, 2, 3, 1).numpy())
        return y

    monkeypatch.setattr(jcrn, "_quant_act", jax_rec)
    monkeypatch.setattr(tcrn, "_quant_act", port_rec)
    return rec


def _turbo_pair(vocab, kwargs, jvars, mode, graphs, noise):
    """JAX and port turbo engines with the same weights and the JAX
    engine's scales (calibrated on ``graphs`` with ``noise``)."""
    jdt, tdt = ((None, None) if mode == "legacy"
                else (jnp.bfloat16, torch.bfloat16))
    j = JaxEngine(vocab, kwargs, jvars, compute_dtype=jdt, crn_mode=mode,
                  quantize="int8")
    t = InferenceEngine(vocab, kwargs, state_dict_from_jax(jvars),
                        device="cpu", compute_dtype=tdt, crn_mode=mode,
                        quantize="int8")
    j.calibrate(graphs, noise=noise)
    t.set_calibration(calibration_from_jax(
        jax.device_get(j.variables["quant"])))
    return j, t


@pytest.mark.parametrize("mode", ["legacy", "split"])
def test_turbo_images_match_jax_small_model(variables, mode, monkeypatch):
    noise = np.random.RandomState(0).randn(2, 64, 64, 6).astype(np.float32)
    j, t = _turbo_pair(VOCAB, MODEL_KWARGS, variables, mode, SG, noise)
    rec = _flip_recorders(monkeypatch)
    with jax.disable_jit():
        j_u8, j_out = j.generate(SG, noise=noise)
    t_u8, t_out = t.generate(SG, noise=noise)
    assert len(rec["jax"]) == len(rec["port"]) == 5
    shares = [np.mean(a != b) for a, b in zip(rec["jax"], rec["port"])]
    if mode == "legacy":
        assert max(shares) <= FLIP_SHARE_F32, shares
        np.testing.assert_allclose(
            t_out["imgs"].permute(0, 2, 3, 1).numpy(),
            np.asarray(j_out["imgs"]), atol=1e-5)
        assert psnr_u8(t_u8, j_u8) >= PSNR_F32
    else:
        assert psnr_u8(t_u8, j_u8) >= PSNR_BF16
    np.testing.assert_allclose(t_out["boxes"].numpy(),
                               np.asarray(j_out["boxes"]), atol=2e-5)


def test_turbo_split_noise_matches_jax_small_model(variables):
    """int8 with the noise apart: the JAX engine's scales load into the
    port's (the same tags), and the images agree at the bf16 bar."""
    noise = np.random.RandomState(2).randn(2, 64, 64, 6).astype(np.float32)
    j, t = _turbo_pair(VOCAB, MODEL_KWARGS, variables, "split_noise", SG,
                       noise)
    assert t.expected_quant_tags() == jax_tags(j)
    j_u8, _ = j.generate(SG, noise=noise)
    t_u8, _ = t.generate(SG, noise=noise)
    assert psnr_u8(t_u8, j_u8) >= PSNR_BF16


@pytest.mark.parametrize("mode", ["legacy", "split"])
def test_turbo_learned_checkpoint_matches_jax(mode):
    bundle = convert_checkpoint(CKPT)
    with open(GRAPHS) as f:
        graphs = json.load(f)
    D = bundle["model_kwargs"]["layout_noise_dim"]
    noise = np.random.RandomState(1).randn(len(graphs), 64, 64,
                                           D).astype(np.float32)
    j, t = _turbo_pair(bundle["vocab"], bundle["model_kwargs"],
                       bundle["generator"], mode, graphs[:4], noise[:4])
    j_u8, _ = j.generate(graphs, noise=noise)
    t_u8, _ = t.generate(graphs, noise=noise)
    assert psnr_u8(t_u8, j_u8) >= (PSNR_F32 if mode == "legacy"
                                   else PSNR_BF16)
