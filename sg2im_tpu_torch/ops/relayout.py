"""Space-to-depth / depth-to-space relayout: the Hopper kernel's wrappers,
their plain versions and their launch counters.

``space_to_depth`` maps (N, C, 2R, 2Rw) to (N, 4C, R, Rw) with the
phase-major channel order of the packed CRN domain,

    packed[n, (2a + b) * C + c, i, j] = fine[n, c, 2i + a, 2j + b],

and ``depth_to_space`` is its inverse.  This is not ``F.pixel_unshuffle``,
whose channel order is channel-major (c * 4 + 2a + b).  In channels_last
memory a logical NCHW tensor is the JAX package's NHWC array byte for byte,
so the kernel reads and writes the bytes the TPU kernel does.  They replace
the TPU kernels of ``sg2im_tpu/ops/pallas/relayout_kernel.py``
(``space_to_depth_pallas`` and ``depth_to_space_pallas``).  The CUDA source
is ``csrc/relayout.cu``; its header says what bounds the kernel.

For a CUDA tensor each wrapper launches the kernel or raises: the input
must be channels_last contiguous (the wrapper makes no copy; the call site
states the layout).  For a CPU tensor it computes the plain version
(``space_to_depth_ref``, ``depth_to_space_ref``), a reshape and a permute
of the NHWC view, which returns channels_last too.  The kernels are a byte
copy, so every dtype is taken.  ``<wrapper>.launches`` counts kernel
launches and nothing else.

Gradients: each wrapper is a ``torch.autograd.Function`` whose backward is
the other entry, depth_to_space being the adjoint (and inverse) of
space_to_depth, so a gradient is the incoming one moved back, bit for bit.
On CUDA the backward launches the other kernel; an incoming gradient that is
not channels_last is made so first, and ``<wrapper>.grad_copies`` counts
those copies.  The backward is itself the other wrapper, so it has a
gradient too.  A call that needs no gradient skips the Function.
"""

from __future__ import annotations

import torch

_MAX_INT = 2 ** 31 - 1


def space_to_depth_ref(x) -> torch.Tensor:
    """Plain version: (N, C, 2R, 2Rw) -> (N, 4C, R, Rw), phase-major."""
    N, C, H, W = x.shape
    y = x.permute(0, 2, 3, 1).reshape(N, H // 2, 2, W // 2, 2, C)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(N, H // 2, W // 2, 4 * C)
    return y.permute(0, 3, 1, 2)


def depth_to_space_ref(x) -> torch.Tensor:
    """Plain version: (N, 4C, R, Rw) -> (N, C, 2R, 2Rw)."""
    N, C4, R, Rw = x.shape
    C = C4 // 4
    y = x.permute(0, 2, 3, 1).reshape(N, R, Rw, 2, 2, C)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(N, 2 * R, 2 * Rw, C)
    return y.permute(0, 3, 1, 2)


def _check_kernel_input(x, N, R, Rw, C):
    if x.device.type != "cuda":
        raise ValueError(f"relayout runs on CPU or CUDA, not {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (NHWC memory); "
                         "the caller converts it explicitly")
    if min(N, R, Rw, C) < 1:
        raise ValueError(f"empty relayout: x {tuple(x.shape)}")
    run = C * x.element_size()
    if run > _MAX_INT or 4 * Rw * run > _MAX_INT or N * R > _MAX_INT:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")


def _launch(entry: str, x, out_shape, N, R, Rw, C) -> torch.Tensor:
    from sg2im_tpu_torch.ops._build import load_library

    lib = load_library()
    N_, C_, H_, W_ = out_shape
    out = torch.empty((N_, H_, W_, C_), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), out.data_ptr(), N, R, Rw, C, x.element_size(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return out.permute(0, 3, 1, 2)


def _s2d(x) -> torch.Tensor:
    if x.device.type == "cpu":
        return space_to_depth_ref(x)
    N, C, H, W = x.shape
    R, Rw = H // 2, W // 2
    _check_kernel_input(x, N, R, Rw, C)
    out = _launch("sg2im_space_to_depth", x, (N, 4 * C, R, Rw), N, R, Rw, C)
    space_to_depth.launches += 1
    return out


def _d2s(x) -> torch.Tensor:
    if x.device.type == "cpu":
        return depth_to_space_ref(x)
    N, C4, R, Rw = x.shape
    C = C4 // 4
    _check_kernel_input(x, N, R, Rw, C)
    out = _launch("sg2im_depth_to_space", x, (N, C, 2 * R, 2 * Rw), N, R, Rw,
                  C)
    depth_to_space.launches += 1
    return out


def _grad_nhwc(g, wrapper) -> torch.Tensor:
    """The incoming gradient of ``wrapper``'s output as the other kernel
    reads it: channels_last, counting the copy when one is made."""
    if g.device.type == "cpu" or g.is_contiguous(
            memory_format=torch.channels_last):
        return g
    wrapper.grad_copies += 1
    return g.contiguous(memory_format=torch.channels_last)


class _SpaceToDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _s2d(x)

    @staticmethod
    def backward(ctx, g):
        return depth_to_space(_grad_nhwc(g, space_to_depth))


class _DepthToSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _d2s(x)

    @staticmethod
    def backward(ctx, g):
        return space_to_depth(_grad_nhwc(g, depth_to_space))


def space_to_depth(x) -> torch.Tensor:
    """(N, C, 2R, 2Rw) -> (N, 4C, R, Rw), phase-major channels; on CUDA x
    must be channels_last and the result is channels_last."""
    if x.ndim != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    H, W = x.shape[2:]
    if H % 2 or W % 2:
        raise ValueError(f"space_to_depth needs even H and W, got {H}x{W}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _SpaceToDepth.apply(x)
    return _s2d(x)


def depth_to_space(x) -> torch.Tensor:
    """(N, 4C, R, Rw) -> (N, C, 2R, 2Rw), the inverse of
    :func:`space_to_depth`; on CUDA x must be channels_last and the result
    is channels_last."""
    if x.ndim != 4:
        raise ValueError(f"x must be (N, 4C, R, Rw), got {tuple(x.shape)}")
    if x.shape[1] % 4:
        raise ValueError(f"depth_to_space needs 4C channels, got "
                         f"{x.shape[1]}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _DepthToSpace.apply(x)
    return _d2s(x)


space_to_depth.launches = 0
depth_to_space.launches = 0
space_to_depth.grad_copies = 0
depth_to_space.grad_copies = 0
