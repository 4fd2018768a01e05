"""Gradients through the port's kernels on the CPU: the layout compose's
two entries (K1, boxes; K2, given weights) and the relayout (K3).

K1's and K2's ``autograd.Function`` backward recomputes the plain compose
and takes its vector-Jacobian product, as the JAX package's ``custom_vjp``
does (``_v2_bwd``, ``_bwd``).  It is held against autograd of the plain
version and against ``jax.grad`` through ``fused_layout_compose_v2`` /
``fused_layout_compose`` with the Pallas kernels in interpret mode, within
1e-5 of the gradient's largest magnitude (or 1e-5 abs below 1): the JAX
suite's kernel bar, scaled because a box or mask gradient sums hundreds of
terms and reaches several hundred.  K3's backward is the other entry,
so its gradients are bit-equal to autograd of the plain relayout.  On the
CPU every wrapper computes its plain version; the card cases live in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sg2im_tpu.ops.pallas.layout_kernel import (
    fused_layout_compose,
    fused_layout_compose_v2,
)
from sg2im_tpu_torch.ops import layout as tlayout
from sg2im_tpu_torch.ops import layout_kernel as lk
from sg2im_tpu_torch.ops import relayout as rl

ATOL = 1e-5

# (N, O, M, H, W, D): a flagship-like tile and a ragged one.
SHAPES = {"N2 O4 M8 32x32 D12": (2, 4, 8, 32, 32, 12),
          "N2 O5 M4 24x40 D7": (2, 5, 4, 24, 40, 7)}


def _inputs(N, O, M, H, W, D, seed=0):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-0.1, 0.6, (N, O, 2)).astype(np.float32)
    sz = rng.uniform(0.1, 0.5, (N, O, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + sz], -1)
    masks = rng.rand(N, O, M, M).astype(np.float32)
    vecs = rng.randn(N, O, D).astype(np.float32)
    g = rng.randn(N, H, W, D).astype(np.float32)
    return boxes, masks, vecs, g


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    bar = ATOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bar


def _grads(fn, inputs, g, needs):
    leaves = [torch.from_numpy(a).requires_grad_(n)
              for a, n in zip(inputs, needs)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return [x.grad for x in leaves]


@pytest.mark.parametrize("needs", [(False, False, True), (True, True, True)],
                         ids=["vecs", "all"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_boxes_entry_gradients(name, needs):
    """K1: the Function's gradients against autograd of the plain version
    and against jax.grad through the Pallas compose in interpret mode."""
    N, O, M, H, W, D = SHAPES[name]
    boxes, masks, vecs, g = _inputs(N, O, M, H, W, D)
    got = _grads(lambda b, m, v: lk.layout_compose(b, m, v, H, W),
                 (boxes, masks, vecs), g, needs)
    plain = _grads(lambda b, m, v: lk.layout_compose_ref(b, m, v, H, W),
                   (boxes, masks, vecs), g, needs)
    _, vjp = jax.vjp(lambda b, m, v: fused_layout_compose_v2(
        b, m, v, H, W, interpret=True), *map(jnp.asarray,
                                             (boxes, masks, vecs)))
    want = vjp(jnp.asarray(g))
    for i, need in enumerate(needs):
        if not need:
            assert got[i] is None
            continue
        _close(got[i], plain[i])
        _close(got[i], want[i])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_weights_entry_gradients(name):
    """K2: gradients of all four inputs against autograd of the plain
    version and jax.grad through ``fused_layout_compose`` in interpret
    mode."""
    N, O, M, H, W, D = SHAPES[name]
    boxes, masks, vecs, g = _inputs(N, O, M, H, W, D, seed=1)
    wy, wx = (t.numpy() for t in tlayout.box_warp_weights(
        torch.from_numpy(boxes), H, W, M, M))
    inputs = (wy, wx, masks, vecs)
    needs = (True,) * 4
    got = _grads(lk.layout_compose_weights, inputs, g, needs)
    plain = _grads(lk.layout_compose_weights_ref, inputs, g, needs)
    _, vjp = jax.vjp(lambda *a: fused_layout_compose(*a, interpret=True),
                     *map(jnp.asarray, inputs))
    want = vjp(jnp.asarray(g))
    for a, b, c in zip(got, plain, want):
        _close(a, b)
        _close(a, c)


def test_compose_backward_keeps_dtype_and_masks_to_layout_gradient():
    """A bf16 output's gradient comes back in the inputs' dtype, and the
    object mask product outside the kernel carries its share."""
    N, O, M, H, W, D = SHAPES["N2 O5 M4 24x40 D7"]
    boxes, masks, vecs, g = _inputs(N, O, M, H, W, D, seed=2)
    v = torch.from_numpy(vecs).requires_grad_()
    out = lk.layout_compose(torch.from_numpy(boxes), torch.from_numpy(masks),
                            v, H, W, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert v.grad.dtype == torch.float32 and torch.isfinite(v.grad).all()

    obj_mask = torch.tensor([[1, 1, 0, 1, 0], [1, 0, 1, 1, 1]],
                            dtype=torch.float32)
    grads = []
    for backend in ("cuda", "torch"):  # the wrapper (plain on the CPU)
        v = torch.from_numpy(vecs).requires_grad_()
        tlayout.masks_to_layout(v, torch.from_numpy(boxes),
                                torch.from_numpy(masks), obj_mask, H, W,
                                backend=backend).backward(torch.from_numpy(g))
        grads.append(v.grad)
    _close(grads[0], grads[1])
    assert (grads[0][obj_mask == 0] == 0).all()


RELAYOUT = {"s2d 16x16 C8 f32": ("s2d", (2, 8, 16, 16), torch.float32),
            "d2s 8x8 C20 f32": ("d2s", (2, 20, 8, 8), torch.float32),
            "s2d 32x16 C5 bf16": ("s2d", (1, 5, 32, 16), torch.bfloat16)}


@pytest.mark.parametrize("name", sorted(RELAYOUT))
def test_relayout_backward_bit_equal_to_plain(name):
    """K3: the gradient of each entry is the other entry applied to the
    incoming gradient, bit-equal to autograd of the plain relayout; a
    double backward goes through too."""
    entry, shape, dtype = RELAYOUT[name]
    wrapper, plain = {"s2d": (rl.space_to_depth, rl.space_to_depth_ref),
                      "d2s": (rl.depth_to_space, rl.depth_to_space_ref)}[entry]
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    out_shape = wrapper(x).shape
    g = torch.from_numpy(rng.randn(*out_shape).astype(np.float32)).to(
        dtype).requires_grad_()
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    (ga,) = torch.autograd.grad(wrapper(a), a, g, create_graph=True)
    (gb,) = torch.autograd.grad(plain(b), b, g)
    assert ga.dtype == dtype and torch.equal(ga, gb)
    (gg,) = torch.autograd.grad(ga.float().sum(), g)
    assert torch.equal(gg, torch.ones_like(gg))
