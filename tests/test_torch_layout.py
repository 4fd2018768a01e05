"""Port parity: sg2im_tpu_torch layout ops and the layout-compose kernel's
plain version against the JAX package on the CPU.

The Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them.  Bar: 1e-5 abs, the bar of the JAX suite's kernel tests (the port's
t = p / (size - 1) and JAX's linspace differ by an ulp at most).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sg2im_tpu.ops import layout as jlayout
from sg2im_tpu.ops import sampling as jsampling
from sg2im_tpu.ops.pallas.layout_kernel import (
    fused_layout_compose,
    fused_layout_compose_v2,
)
from sg2im_tpu_torch.ops import layout as tlayout
from sg2im_tpu_torch.ops import layout_kernel as tk
from sg2im_tpu_torch.ops import sampling as tsampling

ATOL = 1e-5

# (N, O, H, W, M, D, degenerate)
SHAPES = {
    "square": (2, 4, 32, 32, 8, 12, False),
    "odd_24x40_O5": (2, 5, 24, 40, 8, 16, False),
    "degenerate": (2, 6, 16, 20, 4, 7, True),
}


def _inputs(N, O, H, W, M, D, degenerate, seed=0):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-0.1, 0.6, (N, O, 2)).astype(np.float32)
    sz = rng.uniform(0.1, 0.5, (N, O, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + sz], -1)
    if degenerate:
        boxes[:, 0, 2] = boxes[:, 0, 0]          # zero width
        boxes[:, 1, 3] = boxes[:, 1, 1]          # zero height
        boxes[:, 2] = 0.0                        # a point: 0/0 at t = 0
    masks = rng.rand(N, O, M, M).astype(np.float32)
    vecs = rng.randn(N, O, D).astype(np.float32)
    obj_mask = (rng.rand(N, O) < 0.8).astype(np.float32)
    obj_mask[:, 0] = 1.0
    return vecs, boxes, masks, obj_mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_tent_weights_zero_non_finite_rows():
    src = np.array([0.3, 2.0, -0.5, 7.9, np.nan, np.inf, -np.inf, 3.5],
                   np.float32)
    want = np.asarray(jsampling.tent_weights(jnp.asarray(src), 5))
    got = tsampling.tent_weights(torch.from_numpy(src), 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[4:7] == 0).all()


def test_separable_sample_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randn(3, 6, 5).astype(np.float32)
    wy = rng.rand(3, 9, 6).astype(np.float32)
    wx = rng.rand(3, 7, 5).astype(np.float32)
    want = jsampling.separable_sample(*map(jnp.asarray, (img, wy, wx)))
    got = tsampling.separable_sample(*_t(img, wy, wx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_box_warp_weights_match_jax(name):
    N, O, H, W, M, D, degen = SHAPES[name]
    _, boxes, _, _ = _inputs(N, O, H, W, M, D, degen)
    jwy, jwx = jlayout.box_warp_weights(jnp.asarray(boxes), H, W, M, M)
    twy, twx = tlayout.box_warp_weights(torch.from_numpy(boxes), H, W, M, M)
    np.testing.assert_allclose(twy.numpy(), np.asarray(jwy), atol=ATOL)
    np.testing.assert_allclose(twx.numpy(), np.asarray(jwx), atol=ATOL)


@pytest.mark.parametrize("pooling", ["sum", "avg"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_masks_to_layout_matches_jax_xla(name, pooling):
    N, O, H, W, M, D, degen = SHAPES[name]
    vecs, boxes, masks, obj_mask = _inputs(N, O, H, W, M, D, degen)
    want = np.asarray(jlayout.masks_to_layout(
        *map(jnp.asarray, (vecs, boxes, masks, obj_mask)), H, W,
        pooling=pooling, backend="xla"))
    for backend in ("torch", "cuda", "auto"):  # CPU tensors: plain path
        got = tlayout.masks_to_layout(*_t(vecs, boxes, masks, obj_mask), H,
                                      W, pooling=pooling, backend=backend)
        assert got.shape == (N, H, W, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                   err_msg=backend)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_compose_from_boxes_matches_pallas_v2(name):
    """Plain version of the boxes entry vs fused_layout_compose_v2."""
    N, O, H, W, M, D, degen = SHAPES[name]
    vecs, boxes, masks, obj_mask = _inputs(N, O, H, W, M, D, degen)
    v = vecs * obj_mask[..., None]
    want = np.asarray(fused_layout_compose_v2(
        jnp.asarray(boxes), jnp.asarray(masks), jnp.asarray(v), H, W, True))
    got = tk.layout_compose_ref(*_t(boxes, masks, v), H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_compose_from_weights_matches_pallas(name):
    """Plain version of the weights entry vs fused_layout_compose."""
    N, O, H, W, M, D, degen = SHAPES[name]
    vecs, boxes, masks, obj_mask = _inputs(N, O, H, W, M, D, degen)
    v = vecs * obj_mask[..., None]
    wy, wx = jlayout.box_warp_weights(jnp.asarray(boxes), H, W, M, M)
    want = np.asarray(fused_layout_compose(
        wy, wx, jnp.asarray(masks), jnp.asarray(v), True))
    got = tk.layout_compose_weights_ref(
        *_t(np.asarray(wy), np.asarray(wx), masks, v))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    via_layout = tlayout.masks_to_layout(
        *_t(vecs, boxes, masks, obj_mask), H, W, backend="cuda",
        weights=tuple(_t(np.asarray(wy), np.asarray(wx))))
    np.testing.assert_allclose(via_layout.numpy(), want, atol=ATOL)


def test_boxes_to_layout_matches_jax():
    N, O, H, W, M, D, _ = SHAPES["odd_24x40_O5"]
    vecs, boxes, _, obj_mask = _inputs(N, O, H, W, M, D, False)
    for pooling in ("sum", "avg"):
        want = np.asarray(jlayout.boxes_to_layout(
            *map(jnp.asarray, (vecs, boxes, obj_mask)), H, W,
            pooling=pooling))
        got = tlayout.boxes_to_layout(*_t(vecs, boxes, obj_mask), H, W,
                                      pooling=pooling)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_degenerate_box_adds_exactly_nothing():
    N, O, H, W, M, D, _ = SHAPES["degenerate"]
    vecs, boxes, masks, _ = _inputs(N, O, H, W, M, D, True)
    for k in (0, 1, 2):  # zero width, zero height, a point
        lone = np.zeros_like(vecs)
        lone[:, k] = vecs[:, k] + 1.0
        out = tk.layout_compose(*_t(boxes, masks, lone), H, W)
        assert torch.isfinite(out).all()
        assert out.abs().max().item() == 0.0


def test_wrappers_on_cpu_use_plain_version_and_count_nothing():
    N, O, H, W, M, D, _ = SHAPES["square"]
    _, boxes, masks, _ = _inputs(N, O, H, W, M, D, False)
    vecs = np.random.RandomState(3).randn(N, O, D).astype(np.float32)
    tb, tm, tv = _t(boxes, masks, vecs)
    before = (tk.layout_compose.launches, tk.layout_compose_weights.launches)
    want = tk.layout_compose_ref(tb, tm, tv, H, W)
    got = tk.layout_compose(tb, tm, tv, H, W)
    assert torch.equal(got, want)
    bf = tk.layout_compose(tb, tm, tv, H, W, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, want.to(torch.bfloat16))
    wy, wx = tlayout.box_warp_weights(tb, H, W, M, M)
    assert torch.equal(tk.layout_compose_weights(wy, wx, tm, tv),
                       tk.layout_compose_weights_ref(wy, wx, tm, tv))
    assert (tk.layout_compose.launches,
            tk.layout_compose_weights.launches) == before


def test_wrappers_are_forward_only_and_check_inputs():
    """The wrappers take inputs that require a gradient (the training
    path) and give autograd's gradient of the plain version; they check
    devices and shapes."""
    N, O, H, W, M, D, _ = SHAPES["square"]
    vecs, boxes, masks, _ = _inputs(N, O, H, W, M, D, False)
    tb, tm, tv = _t(boxes, masks, vecs)
    tv.requires_grad_(True)
    (got,) = torch.autograd.grad(tk.layout_compose(tb, tm, tv, H, W).sum(),
                                 tv)
    (want,) = torch.autograd.grad(
        tk.layout_compose_ref(tb, tm, tv, H, W).sum(), tv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    with torch.no_grad():
        assert not tk.layout_compose(tb, tm, tv, H, W).requires_grad
    tv = tv.detach()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.layout_compose(tb.to("meta"), tm.to("meta"), tv.to("meta"), H, W)
    with pytest.raises(ValueError, match="different devices"):
        tk.layout_compose(tb, tm.to("meta"), tv, H, W)
    with pytest.raises(ValueError, match="masks must be"):
        tk.layout_compose(tb, tm[:, :, :, :-1], tv, H, W)
    with pytest.raises(ValueError, match="backend"):
        tlayout.masks_to_layout(tv, tb, tm, None, H, W, backend="pallas")


FLAT_ATOL = 2e-5  # the JAX suite's bar for exact reformulations


def _flat_inputs(O, D, M, n_imgs, seed):
    vecs, boxes, masks, _ = _inputs(1, O, 8, 8, M, D, False, seed)
    obj_to_img = np.sort(np.random.RandomState(seed).randint(0, n_imgs, O))
    return vecs[0], boxes[0], masks[0], obj_to_img.astype(np.int64)


@pytest.mark.parametrize("pooling", ["sum", "avg"])
@pytest.mark.parametrize("H, W, num_imgs", [(16, 16, None), (24, 40, 5)])
def test_flat_layout_apis_match_jax(H, W, num_imgs, pooling):
    """boxes_to_layout_flat / masks_to_layout_flat against the JAX
    package's on seeded inputs; num_imgs 5 leaves images without objects."""
    vecs, boxes, masks, obj_to_img = _flat_inputs(7, 6, 8, 3, seed=H)
    jargs = (jnp.asarray(vecs), jnp.asarray(boxes))
    targs = _t(vecs, boxes)
    want = np.asarray(jlayout.boxes_to_layout_flat(
        *jargs, jnp.asarray(obj_to_img), H, W, pooling=pooling,
        num_imgs=num_imgs))
    got = tlayout.boxes_to_layout_flat(
        *targs, torch.from_numpy(obj_to_img), H, W, pooling=pooling,
        num_imgs=num_imgs)
    assert got.shape == want.shape == ((num_imgs or 3), H, W, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=FLAT_ATOL)
    want = np.asarray(jlayout.masks_to_layout_flat(
        *jargs, jnp.asarray(masks), jnp.asarray(obj_to_img), H, W,
        pooling=pooling, num_imgs=num_imgs))
    got = tlayout.masks_to_layout_flat(
        *targs, torch.from_numpy(masks), torch.from_numpy(obj_to_img), H, W,
        pooling=pooling, num_imgs=num_imgs)
    np.testing.assert_allclose(got.numpy(), want, atol=FLAT_ATOL)


def test_flat_layout_matches_padded_layout():
    """One image's objects through the flat API equal the padded API."""
    vecs, boxes, masks, _ = _flat_inputs(5, 4, 8, 1, seed=3)
    obj_to_img = torch.zeros(5, dtype=torch.long)
    flat = tlayout.masks_to_layout_flat(*_t(vecs, boxes, masks), obj_to_img,
                                        16, 20)
    padded = tlayout.masks_to_layout(*_t(vecs[None], boxes[None],
                                         masks[None]), None, 16, 20,
                                     backend="torch")
    np.testing.assert_allclose(flat.numpy(), padded.numpy(), atol=FLAT_ATOL)
    with pytest.raises(ValueError, match="pooling"):
        tlayout.boxes_to_layout_flat(*_t(vecs, boxes), obj_to_img, 8,
                                     pooling="max")
