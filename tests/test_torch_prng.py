"""The port's random numbers against ``jax.random`` on the CPU: threefry2x32
keys, splits, bits, uniforms and normals (``sg2im_tpu_torch.ops.prng``),
the threefry kernel's wrappers on their plain path
(``ops.prng_kernel``), and the JAX package's seed contract through the
port: the engine's seeded ``generate``, the server's per-request rows and
one train step with the layout noise on.

Bars: keys, splits, bits and float32 uniforms bit for bit; XLA's float32
``erf_inv`` and float32 normals within 1e-6 absolute (the two log1p's round
differently: measured 4.8e-7, with about 99% of normals bit-equal);
bfloat16 normals within one bfloat16 ulp of their size; the seeded images
of the two engines within 2e-5 (f32); the train step's losses within the
JAX suite's 2e-4 relative, 2e-5 absolute, and its next key bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sg2im_tpu.inference import InferenceEngine as JaxEngine
from sg2im_tpu.ckpt.torch_convert import convert_generator_state
from sg2im_tpu.train.config import TrainConfig as JaxConfig
from sg2im_tpu.train.state import TrainState as JaxState
from sg2im_tpu.train.trainer import Trainer as JaxTrainer
from sg2im_tpu_torch.ckpt import train_state_from_jax
from sg2im_tpu_torch.inference import InferenceEngine
from sg2im_tpu_torch.models import Sg2ImGenerator
from sg2im_tpu_torch.ops import prng
from sg2im_tpu_torch.ops import prng_kernel as pk
from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.trainer import Trainer
from test_train import TINY, VOCAB, _rand_batch

SEEDS = [0, 7, 2 ** 31 - 1, -1, -2 ** 31]
ODD = (3, 37, 29, 5)  # an NHWC draw: N 3, 37 x 29, C 5
NORMAL_BAR = 1e-6


def _u32(t):
    return t.to(torch.int64).numpy().astype(np.uint32)


def _np_threefry(k0, k1, hi, lo):
    """An independent threefry2x32-20 in numpy uint32 (Random123's
    schedule): the reference for counters JAX cannot reach (hi > 0)."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    ks = [np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA)]
    x = [hi.astype(np.uint32) + ks[0], lo.astype(np.uint32) + ks[1]]
    rots = [(13, 15, 26, 6), (17, 29, 16, 24)]
    for i in range(5):
        for r in rots[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0] ^ x[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    assert tk.dtype == torch.uint32
    np.testing.assert_array_equal(_u32(tk), np.asarray(key))
    for num in (2, 5):
        np.testing.assert_array_equal(_u32(prng.split(tk, num)),
                                      np.asarray(jax.random.split(key, num)))
    np.testing.assert_array_equal(
        prng.random_bits(tk, ODD).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(key, ODD, jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_wrapper_plain_path_matches_jax(seed):
    """threefry_split on the CPU (its plain version, no launch) is
    ``jax.random.split``, for a key tensor and for its words as ints."""
    key = jax.random.PRNGKey(seed)
    for num in (1, 2, 5):
        want = np.asarray(jax.random.split(key, num))
        got = pk.threefry_split(prng.prng_key(seed), num)
        assert got.dtype == torch.uint32 and got.device.type == "cpu"
        np.testing.assert_array_equal(_u32(got), want)
        np.testing.assert_array_equal(
            _u32(pk.threefry_split(prng.key_words(prng.prng_key(seed)),
                                   num)), want)
    assert pk.threefry_split.launches == 0
    with pytest.raises(ValueError, match="num must be"):
        pk.threefry_split(prng.prng_key(seed), 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_read_every_form_of_a_key(seed):
    """key_words gives JAX's two uint32 words for a uint32 key, for its
    int32 bits (words of 2^31 and above read back whole), for int64 and
    numpy keys and for a sequence; a word outside uint32 is refused."""
    want = tuple(int(w) for w in np.asarray(jax.random.PRNGKey(seed)))
    tk = prng.prng_key(seed)
    for key in (tk, tk.view(torch.int32), tk.to(torch.int64),
                np.asarray(want, np.uint32), list(want)):
        assert prng.key_words(key) == want
    with pytest.raises(ValueError, match="two uint32 words"):
        prng.key_words(torch.tensor([-1, 0]))
    with pytest.raises(ValueError, match="two uint32 words"):
        prng.key_words([0, 0, 0])


def test_seeds_outside_int32_raise():
    for seed in (2 ** 31, -2 ** 31 - 1):
        with pytest.raises(ValueError, match="fit int32"):
            prng.prng_key(seed)


def test_offsets_are_row_slices_and_cross_two_to_the_32():
    """A draw from ``offset`` on is that slice of the whole draw; counters
    whose hi word is nonzero match an independent numpy threefry."""
    key = prng.prng_key(3)
    whole = prng.random_bits(key, (6, 4, 4, 3))
    rows = prng.random_bits(key, (2, 4, 4, 3), offset=2 * 48)
    assert torch.equal(rows, whole[2:4])
    offset = 2 ** 32 - 700
    got = prng.random_bits(key, (1400,), offset=offset).numpy()
    flat = np.arange(1400, dtype=np.uint64) + np.uint64(offset)
    want = _np_threefry(0, 3, (flat >> np.uint64(32)).astype(np.uint32),
                        (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert (flat >> np.uint64(32)).max() == 1  # the hi word was reached
    np.testing.assert_array_equal(
        prng.random_bits(key, ODD).numpy().astype(np.uint32).ravel(),
        _np_threefry(0, 3, np.zeros(np.prod(ODD), np.uint32),
                     np.arange(np.prod(ODD), dtype=np.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed):
    key, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for lo, hi in ((0.0, 1.0), (-0.5, 2.0),
                   (float(np.nextafter(np.float32(-1), np.float32(0))),
                    1.0)):
        got = prng.uniform(tk, ODD, torch.float32, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(key, ODD, jnp.float32, lo, hi))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    got = prng.uniform(tk, ODD, torch.bfloat16).float().numpy()
    want = np.asarray(jax.random.uniform(key, ODD, jnp.bfloat16))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_erf_inv_matches_xla():
    one = np.float32(1)
    below = np.nextafter(one, np.float32(0))
    edges = np.array([0, 1, -1, below, -below, 1e-30, -1e-30, 0.5, -0.3],
                     np.float32)
    x = np.concatenate([edges, np.linspace(-1, 1, 200001,
                                           dtype=np.float32)])
    got = prng.erf_inv_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    inf = ~np.isfinite(want)
    np.testing.assert_array_equal(got[inf], want[inf])  # +-inf at +-1
    assert inf.sum() == 2 * 2  # 1 and -1, in edges and in the linspace
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=0,
                               atol=NORMAL_BAR)
    print(f"erf_inv bit-equal share {np.mean(got == want):.4f}")


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    key, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    got = prng.normal(tk, ODD).numpy()
    want = np.asarray(jax.random.normal(key, ODD, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_BAR)
    print(f"seed {seed}: f32 normals bit-equal share "
          f"{np.mean(got == want):.4f}")
    got = prng.normal(tk, ODD, torch.bfloat16).float().numpy()
    want = np.asarray(jax.random.normal(key, ODD, jnp.bfloat16)).astype(
        np.float32)
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("fmt", [torch.contiguous_format,
                                 torch.channels_last])
def test_wrapper_plain_path_is_the_upsampled_jax_draw(f, fmt):
    """threefry_normal / threefry_bits on the CPU: element (n, c, y, x) is
    the JAX draw's (n, y // f, x // f, c), in the asked memory format;
    ``offset`` draws later rows."""
    N, C, H, W = 2, 5, 8 * f, 4 * f
    key = jax.random.PRNGKey(11)
    draw = np.asarray(jax.random.normal(key, (N + 1, H // f, W // f, C)))
    want = np.repeat(np.repeat(draw, f, 1), f, 2).transpose(0, 3, 1, 2)
    got = pk.threefry_normal(prng.prng_key(11), (N, C, H, W), f=f,
                             memory_format=fmt)
    assert got.is_contiguous(memory_format=fmt)
    np.testing.assert_allclose(got.numpy(), want[:N], rtol=0,
                               atol=NORMAL_BAR)
    later = pk.threefry_normal([0, 11], (1, C, H, W), f=f,
                               offset=N * (H // f) * (W // f) * C)
    np.testing.assert_allclose(later.numpy(), want[N:], rtol=0,
                               atol=NORMAL_BAR)
    bits = np.asarray(jax.random.bits(key, (N, H // f, W // f, C),
                                      jnp.uint32))
    bits = np.repeat(np.repeat(bits, f, 1), f, 2).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(
        pk.threefry_bits(prng.prng_key(11), (N, C, H, W), f=f).numpy(),
        bits.view(np.int32))
    assert pk.threefry_normal.launches == pk.threefry_bits.launches == 0
    with pytest.raises(ValueError, match="f = 3"):
        pk.threefry_normal([0, 1], (1, 1, 6, 6), f=3)


# -- the seed contract through the port ----------------------------------

MODEL = dict(image_size=(16, 16), embedding_dim=8, gconv_dim=12,
             gconv_hidden_dim=16, gconv_num_layers=2, refinement_dims=(12, 8),
             mask_size=4, layout_noise_dim=4, normalization="batch",
             activation="leakyrelu-0.2", mlp_normalization="none")
GRAPHS = [{"objects": ["cat", "dog", "sky"],
           "relationships": [[0, "left of", 1], [2, "above", 0]]},
          {"objects": ["dog", "sky"], "relationships": [[0, "above", 1]]},
          {"objects": ["sky", "cat"], "relationships": [[1, "left of", 0]]}]


@pytest.fixture(scope="module")
def weights():
    model = Sg2ImGenerator(VOCAB, **MODEL)
    model.reset_parameters(torch.Generator().manual_seed(4))
    state = model.state_dict()
    return state, convert_generator_state(state)


@pytest.mark.parametrize("opts", [{}, {"noise_downsample": 2}],
                         ids=["f1", "f2"])
def test_seeded_generate_matches_jax_engine(weights, opts):
    """The same weights, graphs and seed through both engines: the JAX
    engine draws its noise in its program, the port through its wrapper;
    images within 2e-5, and row 0 the same in pad buckets 1 and 4."""
    state, variables = weights
    port = InferenceEngine(VOCAB, MODEL, state, device="cpu", **opts)
    ref = JaxEngine(VOCAB, MODEL, variables, **opts)
    _, out = port.generate(GRAPHS, seed=123)
    _, jout = ref.generate(GRAPHS, seed=123)
    np.testing.assert_allclose(out["imgs"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jout["imgs"]), rtol=0, atol=2e-5)
    _, one = port.generate(GRAPHS[:1], seed=123)
    np.testing.assert_allclose(one["imgs"][0].numpy(),
                               out["imgs"][0].numpy(), rtol=0, atol=1e-5)


def test_engine_noise_knobs(weights):
    """noise_impl 'threefry' is the default, 'rbg' is refused with its
    reason; noise_dtype bfloat16 draws the JAX bfloat16 normals."""
    state, _ = weights
    e = InferenceEngine(VOCAB, MODEL, state, device="cpu",
                        noise_impl="threefry", noise_dtype=torch.bfloat16)
    noise = e.draw_noise(3, seed=9)
    assert noise.dtype == torch.bfloat16
    assert noise.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                        (3, 16, 16, 4), jnp.bfloat16))
    got = noise.permute(0, 2, 3, 1).float().numpy()
    ulp = np.maximum(np.abs(want.astype(np.float32)), 2.0 ** -126) * 2 ** -7
    assert np.all(np.abs(got - want.astype(np.float32)) <= ulp)
    imgs, _ = e.generate(GRAPHS[:2], seed=9)
    assert imgs.shape == (2, 16, 16, 3)
    with pytest.raises(ValueError, match="no\\s+single reference"):
        InferenceEngine(VOCAB, MODEL, state, device="cpu", noise_impl="rbg")
    with pytest.raises(ValueError, match="noise_dtype"):
        InferenceEngine(VOCAB, MODEL, state, device="cpu",
                        noise_dtype=torch.float16)
    with pytest.raises(ValueError, match="fit int32"):
        e.generate(GRAPHS[:1], seed=2 ** 31)


@pytest.mark.parametrize("noise_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("noise_downsample", [1, 2], ids=["f1", "f2"])
def test_server_rows_are_the_jax_servers(weights, noise_downsample,
                                         noise_dtype):
    """The port server's merged noise for coalesced requests equals the
    JAX server's own ``_Batcher._merged_noise``: each 'random' request's
    rows ``normal(PRNGKey(seed), (n, H, W, D))`` at full resolution in
    float32, zeros for 'zeros', whatever the engine's noise_downsample and
    noise_dtype (the JAX server's merged call ignores both)."""
    from types import SimpleNamespace

    from sg2im_tpu.cli.serve import _Batcher as JaxBatcher
    from sg2im_tpu_torch.cli.serve import _Batcher, _Request

    state, _ = weights
    engine = InferenceEngine(VOCAB, MODEL, state, device="cpu",
                             noise_downsample=noise_downsample,
                             noise_dtype=noise_dtype)
    batcher = _Batcher(engine, max_graphs=16, window_ms=0)
    reqs = [_Request(GRAPHS[:2], "random", 5),
            _Request(GRAPHS[:1], "zeros", 0),
            _Request(GRAPHS, "random", -3)]
    try:
        got = batcher._merged_noise(reqs)
    finally:
        batcher.close()
    stub = SimpleNamespace(engine=SimpleNamespace(model_kwargs=MODEL))
    want = JaxBatcher._merged_noise(stub, reqs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_BAR)
    np.testing.assert_allclose(
        want[:2], np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                               (2, 16, 16, 4))),
        rtol=0, atol=0)


def test_train_step_with_noise_continues_the_jax_key():
    """One step of both packages from one JAX state at layout_noise_dim
    32 (the port's seeded init carried into the JAX TrainState with the
    JAX Trainer's initial key; the discriminators off, to keep the JAX
    compile short), the port drawing its own noise from the state's key:
    losses within the step bar, and the next key JAX's bit for bit."""
    kw = dict(TINY, layout_noise_dim=32, discriminator_loss_weight=0.0)
    jc = JaxConfig(**kw)
    jt = JaxTrainer(jc, VOCAB)
    trainer = Trainer(TrainConfig(**kw), VOCAB, device="cpu")
    init = trainer.init_state(seed=3)
    want_key = jax.random.split(jax.random.PRNGKey(3), 5)[0]
    np.testing.assert_array_equal(_u32(init.rng), np.asarray(want_key))
    js = JaxState(step=jnp.zeros((), jnp.int32), rng=want_key,
                  g_vars=convert_generator_state(init.g),
                  g_opt=jt.optimizers["g"].init(
                      convert_generator_state(init.g)["params"]))
    batch = _rand_batch(np.random.RandomState(2), jc)
    ts = train_state_from_jax(js)
    assert torch.equal(ts.rng, init.rng)
    js, jm = jt.step(js, dict(batch))
    ts, tm = trainer.step(ts, dict(batch))
    np.testing.assert_array_equal(_u32(ts.rng), np.asarray(js.rng))
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
