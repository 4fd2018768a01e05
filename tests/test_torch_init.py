"""The port's parameter init (``sg2im_tpu_torch/nn/init.py``) against the
JAX package's flax ``init`` on the CPU, and the threefry wrappers the init
draws through (``ops.prng_kernel``, on their plain path here).

For the same key, each leaf the port draws is the one flax draws: the key
``fold_in(root, sha1(path, counter))`` (``ops.prng.fold_in_static``), the
JAX shape's row-major counters, the initializer's float32 factor.  The
JAX side is ``Module.init`` (the JAX ``Trainer.init_state`` for the
trainer's three models) mapped with the JAX package's own converter,
``sg2im_tpu/ckpt/torch_convert.py::convert_variables_to_torch_state``.

Bars: keys bit for bit; leaves drawn from a uniform (nn.Linear's default
kernels and every bias) bit for bit; leaves drawn from a normal (kaiming
kernels, embeddings) within 1e-6 of their stddev (the threefry normals'
bar: the two log1p's round differently); BatchNorm's ones and zeros and
its statistics exact; the step-1 losses of each package's fresh run
within the train step's 2e-4 relative, 2e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static

from sg2im_tpu.ckpt.torch_convert import convert_variables_to_torch_state
from sg2im_tpu.models import Sg2ImGenerator as JaxGenerator
from sg2im_tpu.train.config import TrainConfig as JaxConfig
from sg2im_tpu.train.trainer import Trainer as JaxTrainer
from sg2im_tpu_torch.models import Sg2ImGenerator
from sg2im_tpu_torch.models.sg2im import CRN_MODES
from sg2im_tpu_torch.nn.init import init_draws, init_plan, init_state_dict
from sg2im_tpu_torch.ops import prng
from sg2im_tpu_torch.ops import prng_kernel as pk
from sg2im_tpu_torch.tools import _measure as M
from sg2im_tpu_torch.tools import bench as B
from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.trainer import Trainer
from test_train import TINY, VOCAB, _rand_batch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

NORMAL_BAR = 1e-6  # of the leaf's stddev
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
SEEDS = [0, 7, 2 ** 31 - 1, -1, -2 ** 31]
# TINY's widths with layout noise and BatchNorm in the MLPs, so that every
# kind of leaf is drawn ('split_noise' needs the noise).
TINY_ALL = dict(TINY, layout_noise_dim=4, mlp_normalization="batch")
# COCO-64's shape (64 x 64, five CRN stages, 16 x 16 masks, 32 noise
# channels, three-layer discriminators of stride 2) at narrow widths.
COCO64_NARROW = dict(
    dataset="coco", batch_size=2, image_size=(64, 64), pad_objects_to=6,
    pad_triples_to=8, embedding_dim=16, gconv_dim=16, gconv_hidden_dim=32,
    gconv_num_layers=2, refinement_network_dims=(32, 16, 8, 8, 8),
    d_obj_arch="C4-8-2,C4-16-2,C4-32-2", d_img_arch="C4-8-2,C4-16-2,C4-32-2")


def _check(port: dict, jax_vars, module, model: str) -> dict:
    """Hold a port state dict against flax variables at the bars; -> the
    leaves checked by draw."""
    want = convert_variables_to_torch_state(jax_vars)
    assert set(port) == set(want)
    seen = {}
    for leaf in init_plan(module, model):
        got, ref = port[leaf.name], want[leaf.name].float()
        assert got.dtype == torch.float32 and got.shape == ref.shape
        if leaf.draw == "normal":
            err = (got - ref).abs().max().item()
            assert err <= NORMAL_BAR * leaf.scale, (leaf.name, err)
        else:
            assert torch.equal(got, ref), leaf.name
        seen[leaf.draw] = seen.get(leaf.draw, 0) + 1
    return seen


# -- keys -----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_jax_fold_in(seed):
    key = prng.prng_key(seed)
    for data in (0, 1, 2 ** 31, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert np.array_equal(prng.fold_in(key, data).numpy(), want)
        assert np.array_equal(prng.fold_in(prng.key_words(key), data)
                              .numpy(), want)
        assert prng.fold_in_words(key, data) == tuple(int(w) for w in want)


def test_fold_in_refuses_data_outside_uint32():
    for data in (-1, 2 ** 32):
        with pytest.raises(ValueError, match="uint32"):
            prng.fold_in(prng.prng_key(0), data)


@pytest.mark.parametrize("data", [
    (), ("obj_embeddings", 1), ("box_net", "layer0", 2),
    ("box_net", "layer1", "bn", 1), ("a", 0), ("x", 255), ("x", 256),
    ("refinement_net", "refinement_modules_4", "layer3", 2),
    ("üß", 2 ** 40), (7,)])
def test_static_fold_is_flax(data):
    want = np.asarray(_fold_in_static(jax.random.PRNGKey(3), data))
    assert np.array_equal(
        prng.fold_in_static(prng.prng_key(3), data).numpy(), want)


# -- the draws' wrappers on their plain path -------------------------------

@pytest.mark.parametrize("bounds,scale", [
    ((-1.0, 1.0), float(np.sqrt(np.float32(3) * np.float32(1 / 3 / 144)))),
    ((-1 / 12.0, 1 / 12.0), None), ((-1 / 96.0, 1 / 96.0), None),
    ((0.0, 1.0), None)])
def test_uniform_wrapper_is_jax_uniform_times_scale(bounds, scale):
    n = 1031
    key = prng.prng_key(5)
    got = pk.threefry_uniform(key, n, *bounds, scale)
    want = jax.random.uniform(jax.random.PRNGKey(5), (n,), jnp.float32,
                              *bounds)
    if scale is not None:
        want = want * jnp.float32(scale)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,offset", [(0, 0), (-3, 0), (4, -1),
                                      (4, 2 ** 64 - 3)])
def test_uniform_wrapper_refuses_empty_draws_and_counter_overflow(n, offset):
    with pytest.raises(ValueError, match="64 bits"):
        pk.threefry_uniform(prng.prng_key(0), n, offset=offset)


def test_scaled_normal_wrapper_is_jax_normal_times_scale():
    scale = float(np.sqrt(np.float32(2 / 144)))
    got = pk.threefry_normal(prng.prng_key(4), (1, 999, 1, 1),
                             memory_format=torch.channels_last, scale=scale)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (999,))
                      * jnp.float32(scale))
    assert np.abs(got.reshape(-1).numpy() - want).max() <= NORMAL_BAR * scale


def test_scaled_normal_wrapper_refuses_bfloat16():
    """Parameters are float32: the uniform draws float32 alone (it takes
    no dtype), and the normal takes a scale in float32 only."""
    with pytest.raises(TypeError, match="float32"):
        pk.threefry_normal(prng.prng_key(0), (1, 8, 1, 1),
                           dtype=torch.bfloat16, scale=2.0)


# -- the init against flax's -------------------------------------------------

def _jax_state(kw, seed, jit=False):
    """The JAX Trainer's ``init_state(seed)``; with ``jit`` each model's
    ``init`` runs as one compiled program (the same values as the eager
    init, in about a third of the time at COCO-64's shape)."""
    jt = JaxTrainer(JaxConfig(**kw), VOCAB)
    if jit:
        for m in (jt.generator, jt.d_obj, jt.d_img):
            object.__setattr__(m, "init", jax.jit(
                m.init, static_argnames=("train",)))
    return jt.init_state(seed=seed)


@pytest.mark.parametrize("mode", CRN_MODES)
def test_generator_init_matches_jax_in_every_crn_mode(mode):
    kw = dict(TINY_ALL, crn_mode=mode)
    js = _jax_state(kw, 3)
    trainer = Trainer(TrainConfig(**kw), VOCAB, device="cpu")
    state = trainer.init_state(seed=3)
    seen = _check(state.g, js.g_vars, trainer.generator, "g")
    assert seen["uniform"] and seen["normal"] and seen["ones"]
    # The same weights in every mode.
    legacy = Trainer(TrainConfig(**TINY_ALL), VOCAB,
                     device="cpu").init_state(seed=3)
    for k, v in state.g.items():
        assert torch.equal(v, legacy.g[k]), k


def _moments_zero(opt, params):
    assert int(opt.count) == 0
    for k in params:
        assert not opt.mu[k].any() and not opt.nu[k].any()


@pytest.mark.parametrize("config", ["tiny", "coco64_narrow"])
def test_trainer_init_state_matches_jax(config):
    kw = TINY if config == "tiny" else COCO64_NARROW
    js = _jax_state(kw, 11, jit=config != "tiny")
    trainer = Trainer(TrainConfig(**kw), VOCAB, device="cpu")
    state = trainer.init_state(seed=11)
    assert int(state.step) == 0 and state.rng.dtype == torch.uint32
    assert np.array_equal(state.rng.numpy(), np.asarray(js.rng))
    for name, jv in (("g", js.g_vars), ("d_obj", js.d_obj_vars),
                     ("d_img", js.d_img_vars)):
        _check(getattr(state, name), jv, trainer.modules()[name], name)
        params = dict(trainer.modules()[name].named_parameters())
        _moments_zero(getattr(state, name + "_opt"), params)


def test_fresh_runs_take_the_same_first_step():
    """Each package's Trainer from its own init of one seed: step-1
    losses at the train step's bar."""
    jc = JaxConfig(**TINY)
    batch = _rand_batch(np.random.RandomState(0), jc)
    jt = JaxTrainer(jc, VOCAB)
    _, jm = jt.step(jt.init_state(seed=5), dict(batch))
    trainer = Trainer(TrainConfig(**TINY), VOCAB, device="cpu")
    _, tm = trainer.step(trainer.init_state(seed=5), dict(batch))
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert abs(float(tm[k]) - float(v)) <= (
            LOSS_ATOL + LOSS_RTOL * abs(float(v))), k


def test_init_launches_count_the_drawn_leaves():
    trainer = Trainer(TrainConfig(**TINY_ALL), VOCAB, device="cpu")
    want = {"threefry_split": 1, "threefry_uniform": 0, "threefry_normal": 0}
    for name, module in trainer.modules().items():
        plan = init_plan(module, name)
        drawn = init_draws(module, name)
        assert drawn["threefry_uniform"] == sum(
            leaf.draw == "uniform" for leaf in plan)
        assert drawn["threefry_normal"] == sum(
            leaf.draw == "normal" for leaf in plan)
        for k, v in drawn.items():
            want[k] += v
    assert trainer.init_launches() == want
    # On the CPU the wrappers run their plain versions: no launch.
    before = (pk.threefry_uniform.launches, pk.threefry_normal.launches,
              pk.threefry_split.launches)
    trainer.init_state(seed=0)
    assert (pk.threefry_uniform.launches, pk.threefry_normal.launches,
            pk.threefry_split.launches) == before


# -- vg128 at full width ----------------------------------------------------

def _jax_vg128_init():
    """(the JAX generator of vg128, its init as a function of the key)."""
    vocab, kwargs = M.vg128_config()
    gen = JaxGenerator(vocab=vocab, **kwargs)
    args = (jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 2, 3), jnp.int32),
            jnp.ones((1, 2)), jnp.ones((1, 2)))
    noise = jnp.zeros((1, 128, 128, 32))
    return gen, lambda key: gen.init({"params": key}, *args, train=False,
                                     layout_noise=noise)


def test_vg128_paths_and_shapes_match_jax():
    _, init = _jax_vg128_init()
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            dict(shapes))[0]:
        want[tuple(p.key for p in path)] = tuple(leaf.shape)
    vocab, kwargs = M.vg128_config()
    plan = init_plan(Sg2ImGenerator(vocab, **kwargs), "g")
    got = {(leaf.collection,) + leaf.path: leaf.shape for leaf in plan}
    assert got == want
    assert sum(leaf.collection == "params" for leaf in plan) == 112


@pytest.mark.slow
def test_vg128_values_match_jax():
    """The whole vg128 init at the bars (the JAX init jitted, 9 s on the
    CPU against 26 s eager; the port's plain init 4-7 s).  Slow: over
    100 s inside the whole suite's run, out of Tier-1 (``-m 'not
    slow'``); the paths and shapes above stay in it."""
    _, init = _jax_vg128_init()
    variables = jax.jit(init)(jax.random.PRNGKey(0))
    vocab, kwargs = M.vg128_config()
    model = Sg2ImGenerator(vocab, **kwargs)
    port = init_state_dict(model, "g", prng.prng_key(0))
    _check(port, variables, model, "g")


# -- the entry points that build fresh weights -------------------------------

def test_bench_model_is_bench_pys_init():
    """tools.bench's engine weights at --config tiny are the JAX init of
    PRNGKey(0), as bench.py:136-141's; the PSNR proxy's too, but for the
    box head's last Linear, which it scales."""
    vocab, kwargs = B._generator_config("tiny")
    gen = JaxGenerator(vocab=vocab, **kwargs)
    variables = gen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 2, 3), jnp.int32),
        jnp.ones((1, 2)), jnp.ones((1, 2)), train=False,
        layout_noise=jnp.zeros((1, 32, 32, 4)))
    engine = B.flagship_engine("cpu", bf16=False, crn_mode="legacy",
                               config="tiny")
    state = {k: v for k, v in engine.model.state_dict().items()}
    _check(state, variables, Sg2ImGenerator(vocab, **kwargs), "g")
    _, _, proxy, _ = B.build_proxy("tiny")
    last = [n for n, m in engine.model.box_net.named_modules()
            if isinstance(m, torch.nn.Linear)][-1]
    head = (f"box_net.{last}.weight", f"box_net.{last}.bias")
    for k, v in proxy.items():
        if k not in head:
            assert torch.equal(v, state[k]), k
    assert torch.equal(proxy[head[0]], state[head[0]] * 0.01)
    assert proxy[head[1]].tolist() == pytest.approx([0.15, 0.2, 0.85, 0.8])


def test_reset_parameters_of_each_model():
    trainer = Trainer(TrainConfig(**TINY), VOCAB, device="cpu")
    state = trainer.init_state(seed=2)
    keys = prng.split(prng.prng_key(2), 5)
    for i, name in enumerate(("g", "d_obj", "d_img"), start=1):
        module = trainer.modules()[name]
        module.reset_parameters(keys[i])
        for k, v in module.state_dict().items():
            assert torch.equal(v, getattr(state, name)[k]), (name, k)


def test_profile_crn_stage_is_the_generators_stage():
    from sg2im_tpu_torch.tools import profile_crn

    vocab, kwargs = M.tiny_config()
    g = init_state_dict(Sg2ImGenerator(vocab, **kwargs), "g",
                        prng.prng_key(0))
    L = kwargs["gconv_dim"] + kwargs["layout_noise_dim"]
    mods = profile_crn.stage_modules(L, 16, 8, "cpu", 2)
    prefix = "refinement_net.refinement_modules.2."
    for k, v in mods["legacy"].state_dict().items():
        assert torch.equal(v, g[prefix + k]), k
