"""Port parity: the space-to-depth / depth-to-space relayout of
sg2im_tpu_torch (ops/relayout.py) against the JAX package on the CPU.

The plain versions must be bit-equal to both JAX forms, the Pallas kernels
of sg2im_tpu/ops/pallas/relayout_kernel.py in interpret mode and the jnp
functions of sg2im_tpu/nn/crn.py (a relayout moves values and computes
nothing), on the shapes of tests/test_pallas.py, C = 5 and bf16 included.
The wrappers' refusals are checked on what the CPU can reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sg2im_tpu.nn import crn as jcrn
from sg2im_tpu.ops.pallas.relayout_kernel import (
    depth_to_space_pallas,
    space_to_depth_pallas,
)
from sg2im_tpu_torch.ops import relayout as rl

# (N, 2R, 2Rw, C) NHWC and dtype, as tests/test_pallas.py.
CASES = {"16x16 C8 f32": ((2, 16, 16, 8), "float32"),
         "64x32 C5 f32": ((1, 64, 32, 5), "float32"),
         "8x8 C160 f32": ((2, 8, 8, 160), "float32"),
         "32x32 C16 bf16": ((2, 32, 32, 16), "bfloat16"),
         # The packed CRN head's channel count: d2s of NHWC (1, 16, 16, 12).
         "32x32 C3 f32": ((1, 32, 32, 3), "float32")}


def _both(shape, dtype, seed):
    """The same values as a JAX NHWC array and a port NCHW tensor in
    channels_last memory (the JAX array's bytes)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, dtype)).permute(0, 3, 1, 2)
    return jx, tx


def _nhwc_f32(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_relayout_plain_versions_equal_jax(name):
    shape, dtype = CASES[name]
    jx, tx = _both(shape, dtype, seed=len(name))
    assert tx.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jcrn.space_to_depth(jx), np.float32)
    np.testing.assert_array_equal(
        np.asarray(space_to_depth_pallas(jx, interpret=True), np.float32),
        want)
    got = rl.space_to_depth(tx)
    assert got.dtype == tx.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc_f32(got), want)
    # The plain version takes any memory format.
    np.testing.assert_array_equal(_nhwc_f32(rl.space_to_depth(
        tx.contiguous())), want)

    jp = jcrn.space_to_depth(jx)
    want_back = np.asarray(jcrn.depth_to_space(jp), np.float32)
    np.testing.assert_array_equal(
        np.asarray(depth_to_space_pallas(jp, interpret=True), np.float32),
        want_back)
    back = rl.depth_to_space(got)
    assert back.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc_f32(back), want_back)
    assert torch.equal(back, tx)


def test_relayout_is_phase_major_not_pixel_unshuffle():
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    p = rl.space_to_depth(x)
    for a in (0, 1):
        for b in (0, 1):
            k = 2 * a + b
            assert torch.equal(p[:, 3 * k:3 * (k + 1)], x[:, :, a::2, b::2])
    assert not torch.equal(p, torch.nn.functional.pixel_unshuffle(x, 2))


def test_relayout_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="even H and W"):
        rl.space_to_depth(torch.zeros(1, 2, 5, 4))
    with pytest.raises(ValueError, match="even H and W"):
        rl.space_to_depth(torch.zeros(1, 2, 4, 3))
    with pytest.raises(ValueError, match="4C channels"):
        rl.depth_to_space(torch.zeros(1, 6, 2, 2))
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        rl.space_to_depth(torch.zeros(2, 4, 4))
    with pytest.raises(ValueError, match=r"\(N, 4C, R, Rw\)"):
        rl.depth_to_space(torch.zeros(4, 2, 2))


def test_relayout_wrappers_refuse_other_devices_and_gradients():
    """A tensor that is not on the CPU takes the kernel's checks: they
    refuse a device other than CUDA, with or without a gradient, and
    nothing is counted.  A gradient itself is taken: the backward of each
    entry is the other one."""
    before = (rl.space_to_depth.launches, rl.depth_to_space.launches)
    meta = torch.empty(1, 4, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rl.space_to_depth(meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rl.depth_to_space(meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rl.space_to_depth(meta.requires_grad_())
    with torch.no_grad():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            rl.space_to_depth(meta)
    assert (rl.space_to_depth.launches, rl.depth_to_space.launches) == before
    # On the CPU the plain version runs, gradient included.
    x = torch.randn(1, 2, 4, 4, requires_grad=True)
    rl.depth_to_space(rl.space_to_depth(x)).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
