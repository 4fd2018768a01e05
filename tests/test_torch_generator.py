"""Port parity: the whole sg2im_tpu_torch generator against the JAX
Sg2ImGenerator on the CPU, at a small size with the same weights and the
same explicit layout noise.

Bars: 2e-5 abs for the Linear-only outputs (boxes, relation scores), 1e-4
abs/rel for convolution outputs (masks, images), whose sums run in another
order; u8 PSNR >= 40 dB for the bf16 serving mode against JAX float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sg2im_tpu.models import Sg2ImGenerator as JaxGenerator
from sg2im_tpu_torch.ckpt import state_dict_from_jax
from sg2im_tpu_torch.data import imagenet_deprocess_batch
from sg2im_tpu_torch.models import Sg2ImGenerator

EXACT = 2e-5
CONV = 1e-4

VOCAB = {"object_idx_to_name": [f"o{i}" for i in range(10)],
         "pred_idx_to_name": [f"p{i}" for i in range(5)]}
SMALL = dict(image_size=(32, 32), embedding_dim=32, gconv_dim=32,
             gconv_hidden_dim=64, gconv_num_layers=2,
             refinement_dims=(64, 32, 16), normalization="batch",
             activation="leakyrelu-0.2", mask_size=8, layout_noise_dim=8)
VARIANTS = {"small": {}, "gconv0": {"gconv_num_layers": 0},
            "no_masks": {"mask_size": None}}
N, O, T = 2, 8, 8


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    objs = rng.randint(0, 11, (N, O)).astype(np.int32)
    obj_mask = np.zeros((N, O), np.float32)
    obj_mask[0, :6] = 1
    obj_mask[1, :4] = 1
    triples = np.stack([rng.randint(0, 4, (N, T)), rng.randint(0, 5, (N, T)),
                        rng.randint(0, 4, (N, T))], -1).astype(np.int32)
    triple_mask = (rng.rand(N, T) < 0.75).astype(np.float32)
    noise = rng.randn(N, 32, 32, 8).astype(np.float32)  # NHWC
    return objs, triples, obj_mask, triple_mask, noise


def _jax_variables(gen, inputs, seed=0):
    """JAX init from a seed, with BatchNorm state away from (0, 1) and a box
    head that predicts boxes inside the image, so the layout is not
    empty."""
    init = jax.jit(lambda key, *a: gen.init(key, *a[:4], layout_noise=a[4]))
    variables = _numpy_tree(init(jax.random.PRNGKey(seed),
                                 *map(jnp.asarray, inputs)))
    rng = np.random.RandomState(seed + 1)
    for node, leaf in _walk(variables.get("batch_stats", {})):
        node[leaf] = (0.1 * rng.randn(*node[leaf].shape) if leaf == "mean"
                      else rng.uniform(0.5, 1.5, node[leaf].shape)
                      ).astype(np.float32)
    head = variables["params"]["box_net"]["layer2"]
    head["kernel"] *= 0.05
    head["bias"] = np.array([0.1, 0.15, 0.7, 0.8], np.float32)
    return variables


def _walk(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield tree, k


def _run_port(model, inputs):
    objs, triples, obj_mask, triple_mask, noise = inputs
    with torch.inference_mode():
        return model(torch.from_numpy(objs), torch.from_numpy(triples),
                     torch.from_numpy(obj_mask), torch.from_numpy(triple_mask),
                     torch.from_numpy(noise).permute(0, 3, 1, 2))


@pytest.fixture(scope="module")
def small_variables():
    return _jax_variables(JaxGenerator(vocab=VOCAB, **SMALL), _inputs())


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def jax_case(request):
    kwargs = dict(SMALL, **VARIANTS[request.param])
    inputs = _inputs()
    gen = JaxGenerator(vocab=VOCAB, **kwargs)
    variables = (request.getfixturevalue("small_variables")
                 if request.param == "small" else _jax_variables(gen, inputs))
    apply = jax.jit(lambda v, *a: gen.apply(v, *a[:4], layout_noise=a[4]))
    want = apply(variables, *map(jnp.asarray, inputs))
    want = [None if w is None else np.asarray(w) for w in want]
    return request.param, kwargs, inputs, state_dict_from_jax(variables), want


@pytest.mark.parametrize("crn_mode", ["legacy", "split"])
def test_generator_f32_matches_jax(jax_case, crn_mode):
    name, kwargs, inputs, state, want = jax_case
    model = Sg2ImGenerator(VOCAB, crn_mode=crn_mode, **kwargs)
    model.load_state_dict(state, strict=True)
    imgs, boxes, masks, rel = _run_port(model.eval(), inputs)
    w_imgs, w_boxes, w_masks, w_rel = want
    assert (w_boxes[..., 2:] > w_boxes[..., :2]).any(), "empty layout"
    np.testing.assert_allclose(boxes.numpy(), w_boxes, atol=EXACT)
    np.testing.assert_allclose(rel.numpy(), w_rel, atol=EXACT)
    if w_masks is None:
        assert masks is None
    else:
        np.testing.assert_allclose(masks.numpy(), w_masks, atol=CONV,
                                   rtol=CONV)
    got = imgs.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, w_imgs, atol=CONV, rtol=CONV)


def test_generator_bf16_split_psnr_vs_jax_f32(jax_case):
    name, kwargs, inputs, state, want = jax_case
    model = Sg2ImGenerator(VOCAB, compute_dtype=torch.bfloat16,
                           crn_mode="split", **kwargs)
    model.load_state_dict(state, strict=True)
    imgs = _run_port(model.eval(), inputs)[0]
    assert imgs.dtype == torch.float32
    got = imagenet_deprocess_batch(imgs.permute(0, 2, 3, 1).numpy())
    ref = imagenet_deprocess_batch(want[0])
    mse = np.mean((got.astype(np.float64) - ref) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else np.inf
    assert psnr >= 40.0, f"{name}: bf16/split u8 PSNR {psnr:.2f} dB"


def test_noise_is_required_when_the_model_takes_it(jax_case):
    name, kwargs, inputs, state, _ = jax_case
    model = Sg2ImGenerator(VOCAB, **kwargs).eval()
    objs, triples, obj_mask, triple_mask, _ = inputs
    with pytest.raises(ValueError, match="layout_noise"):
        model(torch.from_numpy(objs), torch.from_numpy(triples),
              torch.from_numpy(obj_mask), torch.from_numpy(triple_mask))


def test_seeded_init_is_reproducible():
    a = Sg2ImGenerator(VOCAB, **SMALL)
    b = Sg2ImGenerator(VOCAB, **SMALL)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    # Conv weights of the CRN take kaiming-normal: std sqrt(2 / fan_in).
    w = a.refinement_net.refinement_modules[0].net[3].weight
    assert abs(w.std().item() / (2 / w[0].numel()) ** 0.5 - 1) < 0.1


# -- the CRN modes beyond legacy / split ---------------------------------------

@pytest.fixture(scope="module", params=["packed", "phase", "split_noise"])
def mode_case(request, small_variables):
    """The SMALL generator's JAX float32 output in one crn_mode, and the
    port's state of the same weights.  At 32x32 the 'packed' default
    packed_min_res (32) packs the 32x32 stage and the head."""
    mode = request.param
    inputs = _inputs()
    gen = JaxGenerator(vocab=VOCAB, crn_mode=mode, **SMALL)
    apply = jax.jit(lambda v, *a: gen.apply(v, *a[:4], layout_noise=a[4]))
    want = [None if w is None else np.asarray(w) for w in
            apply(small_variables, *map(jnp.asarray, inputs))]
    return mode, inputs, state_dict_from_jax(small_variables), want


def test_generator_mode_f32_matches_jax_in_that_mode(mode_case):
    mode, inputs, state, want = mode_case
    model = Sg2ImGenerator(VOCAB, crn_mode=mode, **SMALL)
    model.load_state_dict(state, strict=True)
    imgs, boxes, _, _ = _run_port(model.eval(), inputs)
    np.testing.assert_allclose(boxes.numpy(), want[1], atol=EXACT)
    np.testing.assert_allclose(imgs.permute(0, 2, 3, 1).numpy(), want[0],
                               atol=CONV, rtol=CONV)


def test_generator_mode_bf16_psnr_vs_jax_f32(mode_case):
    mode, inputs, state, want = mode_case
    model = Sg2ImGenerator(VOCAB, compute_dtype=torch.bfloat16,
                           crn_mode=mode, **SMALL)
    model.load_state_dict(state, strict=True)
    imgs = _run_port(model.eval(), inputs)[0]
    assert imgs.dtype == torch.float32
    got = imagenet_deprocess_batch(imgs.permute(0, 2, 3, 1).numpy())
    ref = imagenet_deprocess_batch(want[0])
    mse = np.mean((got.astype(np.float64) - ref) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else np.inf
    assert psnr >= 40.0, f"bf16/{mode} u8 PSNR {psnr:.2f} dB"


@pytest.mark.parametrize("mode,calls", [("packed", (1, 1)),
                                        ("phase", (0, 3)),
                                        ("split_noise", (0, 0))])
def test_crn_modes_call_the_relayout_wrappers(monkeypatch, mode, calls):
    """(space_to_depth, depth_to_space) calls of one SMALL forward: packed
    packs the 32x32 stage's level and unpacks after the head; phase
    interleaves conv0's feats branch in each of the three stages."""
    from sg2im_tpu_torch.nn import crn as tcrn

    seen = {"space_to_depth": 0, "depth_to_space": 0}
    for name in seen:
        def counted(x, _fn=getattr(tcrn, name), _name=name):
            seen[_name] += 1
            return _fn(x)
        monkeypatch.setattr(tcrn, name, counted)
    model = Sg2ImGenerator(VOCAB, crn_mode=mode, **SMALL).eval()
    imgs = _run_port(model, _inputs())[0]
    assert imgs.shape == (N, 3, 32, 32)
    assert (seen["space_to_depth"], seen["depth_to_space"]) == calls


def test_generator_refuses_unknown_modes():
    with pytest.raises(ValueError, match="unknown crn_mode"):
        Sg2ImGenerator(VOCAB, **dict(SMALL, crn_mode="stacked"))
