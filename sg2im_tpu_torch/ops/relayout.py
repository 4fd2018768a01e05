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
launches and nothing else; ``<wrapper>.unaligned_launches`` counts those
among them that took the units route (inputs off 16-byte alignment).

The launch follows :func:`relayout_plan`: packed row (n, i) and fine rows
2i and 2i + 1 hold the same S = 4 Rw C elsize bytes at the same offset on
both sides (a segment), so the relayout permutes runs of 2 C elsize bytes
inside contiguous segments, and the kernel walks the output in blocks of
one full trip of units each.  The direct route moves 16-byte units; the
units route, the same walk in smaller units, takes the inputs whose
pointers or segments are not 16-byte aligned (no shape of the CRN's
paths).  The host's part of a launch is kept short (a cached plan passed
as one struct pointer, the raw stream): at the smaller path shapes it
takes longer than the kernel.

Gradients: each wrapper is a ``torch.autograd.Function`` whose backward is
the other entry, depth_to_space being the adjoint (and inverse) of
space_to_depth, so a gradient is the incoming one moved back, bit for bit.
On CUDA the backward launches the other kernel; an incoming gradient that is
not channels_last is made so first, and ``<wrapper>.grad_copies`` counts
those copies.  The backward is itself the other wrapper, so it has a
gradient too.  A call that needs no gradient skips the Function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sg2im_tpu_torch.ops.prng_kernel import magic_divisor

_MAX_INT = 2 ** 31 - 1

ROUTE_DIRECT = 0  # the flat walk in 16-byte units
ROUTE_UNITS = 1   # the same walk in smaller units: the unaligned route
ROUTES = ("direct", "units")
THREADS = 256  # the kernel's block
UNROLL = 4     # units a thread a trip
SPAN = THREADS * UNROLL  # units a block: one trip


class RelayoutPlan(NamedTuple):
    """How one relayout launches: ``grid`` blocks of ``THREADS`` threads,
    each ``span`` consecutive output units of ``unit`` bytes (the largest
    that divides the run and both pointers' alignment), wherever in a
    segment it starts.  ``run`` is L = 2 C elsize bytes, two horizontal
    phases, and ``seg`` S = 2 Rw L bytes, a segment; the (mul, shift)
    pairs divide by L / unit and S / unit (``magic_divisor``).  The route
    is ``ROUTE_UNITS`` where the unit is under 16 bytes for the pointers'
    sake or because S is no multiple of 16 (no path shape)."""
    route: int
    unit: int
    segs: int
    Rw: int
    run: int
    seg: int
    span: int
    grid: int
    run_mul: int
    run_shift: int
    seg_mul: int
    seg_shift: int


class PlanStruct(ctypes.Structure):
    """A plan as the C entries read it (``struct Plan`` of
    ``csrc/relayout.cu``)."""
    _fields_ = [(name, ctypes.c_uint32 if name.endswith("_mul")
                 else ctypes.c_int32) for name in RelayoutPlan._fields]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def relayout_plan(N, R, Rw, C, elsize, in_ptr=0, out_ptr=0) -> RelayoutPlan:
    """The launch of K3 for fine (N, 2R, 2Rw, C) <-> packed (N, R, Rw,
    4C) NHWC of ``elsize``-byte elements at the given data pointers (only
    their alignment to 16 bytes counts)."""
    return _plan(N, R, Rw, C, elsize, (in_ptr | out_ptr) % 16)


@functools.lru_cache(maxsize=256)
def _plan(N, R, Rw, C, elsize, misalign) -> RelayoutPlan:
    L = 2 * C * elsize
    S = 2 * Rw * L
    unit = next(u for u in (16, 8, 4, 2, 1)
                if L % u == 0 and misalign % u == 0)
    Lu, Su = L // unit, S // unit
    grid = _cdiv(N * R * Su, SPAN)
    if grid > _MAX_INT or 2 * Su + SPAN > _MAX_INT or N * R > _MAX_INT:
        raise ValueError(f"relayout of {N * R} segments of {S} bytes "
                         f"exceeds the kernel's grid")
    route = ROUTE_UNITS if misalign or S % 16 else ROUTE_DIRECT
    return RelayoutPlan(route, unit, N * R, Rw, L, S, SPAN, grid,
                        *magic_divisor(Lu), *magic_divisor(Su))


@functools.lru_cache(maxsize=256)
def _plan_struct(N, R, Rw, C, elsize, misalign):
    """(plan, its PlanStruct, the struct's address): the cache keeps the
    struct alive."""
    plan = _plan(N, R, Rw, C, elsize, misalign)
    struct = PlanStruct(*plan)
    return plan, struct, ctypes.addressof(struct)


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


# The current device, and the current stream as a raw CUDA handle,
# without a Python object made a launch; torch.cuda's where a build lacks
# the raw calls.
_current_device = getattr(torch._C, "_cuda_getDevice",
                          torch.cuda.current_device)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(entry: str, wrapper, x, out_shape, N, R, Rw, C) -> torch.Tensor:
    """One launch by the plan.  The host's part is kept short (a cached
    plan as one struct pointer, the raw stream, the output allocated
    channels_last): at the smaller path shapes it takes longer than the
    kernel."""
    from sg2im_tpu_torch.ops._build import load_library

    out = torch.empty(out_shape, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    xp, op = x.data_ptr(), out.data_ptr()
    plan, _, addr = _plan_struct(N, R, Rw, C, x.element_size(),
                                 (xp | op) % 16)
    index = x.get_device()
    fn = getattr(load_library(), entry)
    if index == _current_device():
        rc = fn(xp, op, addr, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(xp, op, addr, _stream(index))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    wrapper.launches += 1
    wrapper.unaligned_launches += plan.route == ROUTE_UNITS
    return out


def _s2d(x) -> torch.Tensor:
    if x.device.type == "cpu":
        return space_to_depth_ref(x)
    N, C, H, W = x.shape
    R, Rw = H // 2, W // 2
    _check_kernel_input(x, N, R, Rw, C)
    return _launch("sg2im_space_to_depth", space_to_depth, x,
                   (N, 4 * C, R, Rw), N, R, Rw, C)


def _d2s(x) -> torch.Tensor:
    if x.device.type == "cpu":
        return depth_to_space_ref(x)
    N, C4, R, Rw = x.shape
    C = C4 // 4
    _check_kernel_input(x, N, R, Rw, C)
    return _launch("sg2im_depth_to_space", depth_to_space, x,
                   (N, C, 2 * R, 2 * Rw), N, R, Rw, C)


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
space_to_depth.unaligned_launches = 0
depth_to_space.unaligned_launches = 0
space_to_depth.grad_copies = 0
depth_to_space.grad_copies = 0
