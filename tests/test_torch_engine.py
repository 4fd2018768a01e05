"""Port parity: the sg2im_tpu_torch inference engine, CLI, checkpoint
loading and host-side data against the JAX package, on the CPU.

The learned checkpoint ``artifacts/trained_coco64.pt`` runs through both
engines with zero noise and with the same explicit noise; the bar is the
JAX package's u8 PSNR gate, 40 dB.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "trained_coco64.pt")
GRAPHS = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")


def psnr_u8(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


@pytest.fixture(scope="module")
def scene_graphs():
    with open(GRAPHS) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_engine():
    from sg2im_tpu_torch.inference import InferenceEngine

    return InferenceEngine.from_torch_checkpoint(CKPT, device="cpu")


@pytest.fixture(scope="module")
def jax_engine():
    from sg2im_tpu.inference import InferenceEngine

    return InferenceEngine.from_torch_checkpoint(CKPT)


def test_trained_artifact_zero_noise_matches_jax(port_engine, jax_engine,
                                                 scene_graphs):
    got, out = port_engine.generate(scene_graphs, noise="zeros")
    want, jout = jax_engine.generate(scene_graphs, noise="zeros")
    assert got.shape == want.shape == (8, 64, 64, 3)
    assert got.dtype == np.uint8
    assert psnr_u8(got, want) >= 40.0
    f32 = out["imgs"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(f32, np.asarray(jout["imgs"]), atol=1e-3)
    np.testing.assert_allclose(out["boxes"].numpy(),
                               np.asarray(jout["boxes"]), atol=2e-5)


def test_trained_artifact_packed_matches_jax_packed(scene_graphs):
    """The learned checkpoint with crn_mode='packed' through both engines:
    its 32x32 and 64x64 stages and the head run in the packed domain."""
    from sg2im_tpu.inference import InferenceEngine as JaxEngine
    from sg2im_tpu_torch.inference import InferenceEngine

    port = InferenceEngine.from_torch_checkpoint(CKPT, device="cpu",
                                                 crn_mode="packed")
    jax_packed = JaxEngine.from_torch_checkpoint(CKPT, crn_mode="packed")
    got, out = port.generate(scene_graphs, noise="zeros")
    want, jout = jax_packed.generate(scene_graphs, noise="zeros")
    assert got.shape == want.shape == (8, 64, 64, 3)
    assert psnr_u8(got, want) >= 40.0
    np.testing.assert_allclose(out["imgs"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jout["imgs"]), atol=1e-3)


def test_trained_artifact_explicit_noise_matches_jax(port_engine, jax_engine,
                                                     scene_graphs):
    noise = np.random.RandomState(0).randn(5, 64, 64, 32).astype(np.float32)
    got, _ = port_engine.generate(scene_graphs[:5], noise=noise)
    want, _ = jax_engine.generate(scene_graphs[:5], noise=noise)
    assert psnr_u8(got, want) >= 40.0


def test_seeded_noise_is_pad_bucket_invariant(port_engine, scene_graphs):
    from sg2im_tpu_torch.inference import seeded_noise

    one = seeded_noise(1, (2, 3, 4), seed=7, device="cpu")
    four = seeded_noise(4, (2, 3, 4), seed=7, device="cpu")
    assert torch.equal(one[0], four[0])
    # Rows drawn alone by their row index are those rows of the batch.
    assert torch.equal(seeded_noise(2, (2, 3, 4), seed=7, device="cpu",
                                    row=2), four[2:])
    # Bucket 1 vs bucket 4 (3 graphs padded to 4): the first image agrees.
    a, out_a = port_engine.generate(scene_graphs[:1], seed=7)
    b, out_b = port_engine.generate(scene_graphs[:3], seed=7)
    # Same noise; the convolutions' sum order may depend on the batch
    # size (the conv bar, 1e-4), which can move a pixel across a u8
    # rounding boundary.
    torch.testing.assert_close(out_a["imgs"][0], out_b["imgs"][0],
                               atol=1e-4, rtol=1e-4)
    assert np.abs(a[0].astype(int) - b[0]).max() <= 1
    c, _ = port_engine.generate(scene_graphs[:1], seed=8)
    assert not np.array_equal(a[0], c[0])


def test_zero_noise_is_deterministic(port_engine, scene_graphs):
    a, out_a = port_engine.generate(scene_graphs, noise="zeros")
    b, out_b = port_engine.generate(scene_graphs, noise="zeros")
    np.testing.assert_array_equal(a, b)
    assert torch.equal(out_a["imgs"], out_b["imgs"])


def test_noise_argument_is_checked(port_engine, scene_graphs):
    with pytest.raises(ValueError, match="noise"):
        port_engine.generate(scene_graphs[:2], noise="uniform")
    with pytest.raises(ValueError, match="noise"):
        port_engine.generate(scene_graphs[:2],
                             noise=np.zeros((3, 64, 64, 32), np.float32))


def test_run_model_cli_writes_the_engine_images(tmp_path, port_engine,
                                                scene_graphs):
    from PIL import Image

    from sg2im_tpu_torch.cli.run_model import main

    rc = main(["--checkpoint", CKPT, "--scene_graphs_json", GRAPHS,
               "--output_dir", str(tmp_path), "--noise", "zeros",
               "--device", "cpu"])
    assert rc == 0
    want, _ = port_engine.generate(scene_graphs, noise="zeros")
    for i in range(len(scene_graphs)):
        img = np.asarray(Image.open(tmp_path / f"img{i:06d}.png"))
        np.testing.assert_array_equal(img, want[i])
    assert main(["--checkpoint", str(tmp_path / "missing.pt")]) == 1


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sg2im_tpu_torch.inference import InferenceEngine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_torch_checkpoint(CKPT, device="cuda")


def test_encoding_and_deprocess_match_jax_package(scene_graphs):
    from sg2im_tpu.data import encode_scene_graphs as jencode
    from sg2im_tpu.data import imagenet_deprocess_batch as jdeprocess
    from sg2im_tpu_torch.ckpt import load_reference_checkpoint
    from sg2im_tpu_torch.data import (encode_scene_graphs,
                                      imagenet_deprocess_batch)

    vocab, _, _ = load_reference_checkpoint(CKPT)
    for align in (1, 8):
        got = encode_scene_graphs(scene_graphs, vocab, align=align)
        want = jencode(scene_graphs, vocab, align=align)
        for k in ("objs", "triples", "obj_mask", "triple_mask"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    imgs = np.random.RandomState(1).randn(3, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(imagenet_deprocess_batch(imgs),
                                  jdeprocess(imgs))
    with pytest.raises(ValueError, match="not in vocab"):
        encode_scene_graphs({"objects": ["nope"], "relationships": []},
                            vocab)


def test_state_dict_from_jax_matches_the_jax_converter():
    """The learned checkpoint through the JAX package's converter into flax
    variables, and back through both mappings."""
    from sg2im_tpu.ckpt.torch_convert import (
        convert_generator_state,
        convert_variables_to_torch_state,
    )
    from sg2im_tpu_torch.ckpt import state_dict_from_jax

    state = torch.load(CKPT, map_location="cpu",
                       weights_only=True)["model_state"]
    variables = convert_generator_state(state)
    got = state_dict_from_jax(variables)
    want = convert_variables_to_torch_state(variables)
    assert got.keys() == want.keys() == state.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], state[k]), k


def test_reference_checkpoint_loads_strict_with_prefixes(tmp_path):
    from sg2im_tpu_torch.ckpt import load_reference_checkpoint
    from sg2im_tpu_torch.models import Sg2ImGenerator

    ckpt = torch.load(CKPT, map_location="cpu", weights_only=True)
    state = {f"module.{k}": v for k, v in ckpt["model_state"].items()}
    state["module.mask_net.1.num_batches_tracked"] = torch.tensor(3)
    kwargs = dict(ckpt["model_kwargs"], vec_noise_dim=0)
    torch.save({"model_state": state, "model_kwargs": kwargs},
               tmp_path / "wrapped.pt")
    vocab, model_kwargs, loaded = load_reference_checkpoint(
        tmp_path / "wrapped.pt")
    assert "vec_noise_dim" not in model_kwargs
    model = Sg2ImGenerator(vocab, **model_kwargs)
    model.load_state_dict(loaded, strict=True)


def test_port_imports_no_jax():
    """Every port module imports without JAX, flax or the JAX package (a
    subprocess: this test process has JAX loaded by conftest)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sg2im_tpu_torch\n"
        "for m in pkgutil.walk_packages(sg2im_tpu_torch.__path__, "
        "'sg2im_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'flax', 'sg2im_tpu'))\n"
        "assert not bad, bad\n"
        "print('imported', len([n for n in sys.modules "
        "if n.startswith('sg2im_tpu_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_deprocess_on_device_matches_host_and_jax(port_engine, scene_graphs):
    """The engine deprocesses on its device: bit-equal to the host
    deprocess of the same float images, and within 1 u8 level of the JAX
    engine's on-device deprocess (the two engines' float images differ by
    f32 round-off)."""
    from sg2im_tpu.inference import InferenceEngine as JaxEngine
    from sg2im_tpu_torch.data import imagenet_deprocess_batch

    got, out = port_engine.generate(scene_graphs, noise="zeros")
    assert got.dtype == np.uint8 and got.shape == (8, 64, 64, 3)
    f32, _ = port_engine.generate(scene_graphs, noise="zeros",
                                  deprocess=False)
    assert f32.dtype == np.float32
    np.testing.assert_array_equal(
        f32, out["imgs"].permute(0, 2, 3, 1).numpy())
    np.testing.assert_array_equal(got, imagenet_deprocess_batch(f32))
    jax_engine = JaxEngine.from_torch_checkpoint(CKPT,
                                                 deprocess_on_device=True)
    jgot, _ = jax_engine.generate(scene_graphs, noise="zeros")
    assert np.abs(got.astype(int) - jgot).max() <= 1


@pytest.mark.parametrize("shape", [(3, 8, 8, 3), (1, 5, 7, 3), (2, 64, 64, 3)])
def test_deprocess_torch_is_bit_equal_to_host(shape):
    from sg2im_tpu.data.transforms import imagenet_deprocess_batch_jnp
    from sg2im_tpu_torch.data import (imagenet_deprocess_batch,
                                      imagenet_deprocess_batch_torch)

    imgs = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = imagenet_deprocess_batch(imgs)
    got = imagenet_deprocess_batch_torch(torch.from_numpy(imgs))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # An NCHW tensor goes in as its NHWC view.
    nchw = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
    np.testing.assert_array_equal(
        imagenet_deprocess_batch_torch(nchw.permute(0, 2, 3, 1)).numpy(),
        want)
    jgot = np.asarray(imagenet_deprocess_batch_jnp(imgs))
    assert np.abs(got.numpy().astype(int) - jgot).max() <= 1


def test_noise_downsample(scene_graphs):
    """f = 2: zero noise gives the f = 1 images; seeded noise is the
    (D, H/2, W/2) draw, constant over 2x2 tiles."""
    from sg2im_tpu_torch.inference import InferenceEngine, seeded_noise

    one = InferenceEngine.from_torch_checkpoint(CKPT, device="cpu")
    two = InferenceEngine.from_torch_checkpoint(CKPT, device="cpu",
                                                noise_downsample=2)
    a, out_a = one.generate(scene_graphs, noise="zeros")
    b, out_b = two.generate(scene_graphs, noise="zeros")
    np.testing.assert_array_equal(a, b)
    assert torch.equal(out_a["imgs"], out_b["imgs"])
    noise = two.draw_noise(3, seed=4)
    assert noise.shape == (3, 32, 64, 64)
    # The (3, 32, 32, 32) draw: the JAX engine's normal(PRNGKey(4), (3,
    # 32, 32, 32)), each value over a 2x2 tile.
    coarse = seeded_noise(3, (32, 32, 32), seed=4, device="cpu")
    for dy in (0, 1):
        for dx in (0, 1):
            assert torch.equal(noise[:, :, dy::2, dx::2], coarse)
    assert two.draw_noise(1, seed=4).equal(noise[:1])  # row-stable
    assert two.draw_noise(2, seed=4, row=1).equal(noise[1:])
    c, _ = two.generate(scene_graphs[:2], seed=4)
    d, _ = one.generate(scene_graphs[:2], seed=4)
    assert not np.array_equal(c, d)


@pytest.mark.parametrize("kw, match", [
    (dict(noise_downsample=3), "noise_downsample must be"),
    (dict(noise_downsample=0), "noise_downsample must be"),
])
def test_engine_refuses_knobs_it_cannot_keep(kw, match):
    from sg2im_tpu_torch.inference import InferenceEngine

    with pytest.raises(ValueError, match=match):
        InferenceEngine.from_torch_checkpoint(CKPT, device="cpu", **kw)


def test_noise_downsample_must_divide_the_image():
    from sg2im_tpu_torch.ckpt import load_reference_checkpoint
    from sg2im_tpu_torch.inference import InferenceEngine

    vocab, kwargs, state = load_reference_checkpoint(CKPT)
    kwargs = dict(kwargs, image_size=(62, 62))
    with pytest.raises(ValueError, match="does not divide"):
        InferenceEngine(vocab, kwargs, state, device="cpu",
                        noise_downsample=4)


def test_warmup_bucket_shapes_match_jax(port_engine, jax_engine):
    sizes = (1, 3)
    assert port_engine.warmup(batch_sizes=sizes) == \
        jax_engine.warmup(batch_sizes=sizes)
    sg = {"objects": ["thing1"] * 9, "relationships": [[0, "above", 1]]}
    assert port_engine.warmup(batch_sizes=(5,), scene_graph=sg) == \
        [(8, 16, 16)]


def test_warmup_keeps_only_prior_int8_scales(scene_graphs):
    """int8: warmup scales are discarded on an uncalibrated engine; a
    calibrated engine keeps its scales through warmup."""
    from sg2im_tpu_torch.inference import InferenceEngine

    engine = InferenceEngine.from_torch_checkpoint(CKPT, device="cpu",
                                                   quantize="int8")
    assert engine.warmup(batch_sizes=(1, 2)) == [(1, 8, 8), (2, 8, 8)]
    assert not engine.calibrated
    engine.calibrate(scene_graphs, noise="zeros")
    scales = engine.scales()
    engine.warmup(batch_sizes=(1, 2))
    assert engine.scales() == scales


def test_explicit_noise_tensor_stays_where_it_lies(port_engine,
                                                   scene_graphs):
    """A (n, H, W, D) tensor on the engine's device is used in place
    (padded rows added on the device) and gives the images of the same
    noise as a numpy array."""
    noise = torch.from_numpy(
        np.random.RandomState(5).randn(4, 64, 64, 32).astype(np.float32))
    used = port_engine._noise(noise, 0, 4)
    assert used.data_ptr() == noise.data_ptr()
    padded = port_engine._noise(noise[:3], 0, 4)
    assert torch.equal(padded[:3], noise[:3].permute(0, 3, 1, 2))
    assert not padded[3].any()
    a, _ = port_engine.generate(scene_graphs[:3], noise=noise[:3])
    b, _ = port_engine.generate(scene_graphs[:3], noise=noise[:3].numpy())
    np.testing.assert_array_equal(a, b)


def test_from_bundle_reads_the_checkpoint_once(port_engine, scene_graphs):
    from sg2im_tpu_torch.ckpt import load_reference_checkpoint
    from sg2im_tpu_torch.inference import InferenceEngine

    bundle = load_reference_checkpoint(CKPT)
    a, b = (InferenceEngine.from_bundle(bundle, device="cpu")
            for _ in range(2))
    want, _ = port_engine.generate(scene_graphs, noise="zeros")
    for e in (a, b):
        np.testing.assert_array_equal(
            e.generate(scene_graphs, noise="zeros")[0], want)


def test_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sg2im_tpu_torch.inference import InferenceEngine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_torch_checkpoint(CKPT)


def _verify(tmp_path, *extra):
    from sg2im_tpu_torch.cli.verify_pretrained import main

    return main(["--checkpoint", CKPT, "--scene_graphs_json", GRAPHS,
                 "--output_dir", str(tmp_path / "out"), "--device", "cpu",
                 *extra])


@pytest.fixture(scope="module")
def jax_goldens(tmp_path_factory, jax_engine, scene_graphs):
    """Golden PNGs written by the JAX engine with zero noise."""
    from PIL import Image

    golden = tmp_path_factory.mktemp("goldens")
    imgs, _ = jax_engine.generate(scene_graphs, noise="zeros")
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(golden / f"img{i:06d}.png")
    return golden


def test_verify_pretrained_passes_against_jax_goldens(tmp_path, capsys,
                                                      jax_goldens):
    assert _verify(tmp_path, "--golden_dir", str(jax_goldens)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["pass"] is True
    assert set(last["psnr"]) == {"golden_u8:trained_scene_graphs.json",
                                 "golden_u8:ALL"}
    assert min(last["psnr"].values()) >= 40.0
    assert lines[0].startswith("Wrote 8 images")
    assert len(os.listdir(tmp_path / "out")) == 8


@pytest.mark.parametrize("case, rc", [("missing golden", 1),
                                      ("no golden dir", 1),
                                      ("below --min_psnr", 2),
                                      ("missing checkpoint", 1)])
def test_verify_pretrained_exit_codes(tmp_path, capsys, jax_goldens, case,
                                      rc):
    from sg2im_tpu_torch.cli.verify_pretrained import main

    if case == "missing golden":
        partial = tmp_path / "partial"
        partial.mkdir()
        for i in range(4):
            name = f"img{i:06d}.png"
            (partial / name).write_bytes((jax_goldens / name).read_bytes())
        assert _verify(tmp_path, "--golden_dir", str(partial)) == rc
        assert "missing golden image" in capsys.readouterr().out
    elif case == "no golden dir":
        assert _verify(tmp_path) == rc
        assert "nothing to compare against" in capsys.readouterr().out
    elif case == "below --min_psnr":
        assert _verify(tmp_path, "--golden_dir", str(jax_goldens),
                       "--min_psnr", "1000", "--conv_precision",
                       "highest") == rc
        out = capsys.readouterr().out
        assert "[LOW]" in out and json.loads(
            out.strip().splitlines()[-1])["pass"] is False
    else:
        assert main(["--checkpoint", str(tmp_path / "nope.pt")]) == rc


def test_full_fp32_holds_across_threads():
    """Engines in several threads (server replicas): TF32 stays off inside
    every open block, and the switches come back once the last ends."""
    import threading

    from sg2im_tpu_torch.inference import full_fp32

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    seen_on = []

    def worker():
        for _ in range(200):
            with full_fp32():
                if (torch.backends.cuda.matmul.allow_tf32
                        or torch.backends.cudnn.allow_tf32):
                    seen_on.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not seen_on
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        sys.setswitchinterval(interval)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
