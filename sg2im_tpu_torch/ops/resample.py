"""The CRN's 2x resampling, R1: the Hopper kernel's wrappers, their plain
versions, the rule that chooses them and the launch counters.

The CRN changes resolution in two places.  ``RefinementNetwork.forward``
builds the layout pyramid, each level the 2x2 average of the one above
(``F.avg_pool2d(x, 2)`` once a level); each stage whose features are
coarser than its layout level upsamples them (``F.interpolate``, nearest,
2x).  ``csrc/resample.cu`` does both as data movement in 16-byte vectors
of channels:

* :func:`pool_pyramid` reads level 0 once and writes every pooled level in
  one launch.  Each window is summed in float32 in aten's order, divided by
  4 and rounded to the storage type before the next level is formed from
  it, so each level is bit-equal to successive ``F.avg_pool2d``.
* :func:`upsample2` copies each coarse vector to its four fine pixels:
  bit-equal to ``F.interpolate``.

It replaces no Pallas kernel: XLA fused the pooling and the upsampling
into the convolutions that read them.  Both directions are bound by bytes
(``utils/roofline.crn_resample_bytes``); aten moved one 2-byte element a
thread.  The design moves 16-byte vectors and reads the pyramid's input
once; the source's header says more.

For a CUDA tensor a wrapper launches the kernel or raises: x bf16 or
float32, its channels whole 16-byte vectors, 16-byte aligned, and for the
pyramid its sides multiples of 2^levels.  An input that is not
channels_last is copied so first, and the copy counted in
``layout_copies``.  The outputs are channels_last.  For a CPU tensor a
wrapper computes its plain version.  ``launches`` counts kernel launches
of either entry.  :func:`takes_kernel` and :func:`pyramid_takes_kernel`
are the callers' rule (``nn/layers.upsample_nearest``,
``nn/crn.RefinementNetwork``); nothing here has a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sg2im_tpu_torch.ops.relayout import _current_device, _stream

# The device type on which a resampling takes the kernel.
RESAMPLE_DEVICE = "cuda"
VECTOR_BYTES = 16
DTYPES = (torch.bfloat16, torch.float32)
MAX_LEVELS = 5        # the pyramid kernel's instances
POOL_THREADS = 64     # a block; the kernel's bound is 256
UP_THREADS = 512      # a block; the kernel's bound
_MAX_INT = 2 ** 31 - 1

launches = 0
layout_copies = 0


def takes_kernel(x) -> bool:
    """Whether a resampling of ``x`` takes the kernel: x a 4-D tensor on
    the card, bf16 or float32, whose channels fill whole 16-byte vectors
    from a 16-byte aligned start, and no gradient recorded through it."""
    return (x.device.type == RESAMPLE_DEVICE and x.dtype in DTYPES
            and x.ndim == 4
            and x.shape[1] * x.element_size() % VECTOR_BYTES == 0
            and x.data_ptr() % VECTOR_BYTES == 0
            and not (torch.is_grad_enabled() and x.requires_grad))


def pyramid_takes_kernel(x, levels: int) -> bool:
    """:func:`takes_kernel`, 1 to ``MAX_LEVELS`` levels, and sides that
    halve ``levels`` times without a remainder."""
    return (takes_kernel(x) and 1 <= levels <= MAX_LEVELS
            and x.shape[2] % (1 << levels) == 0
            and x.shape[3] % (1 << levels) == 0)


class PoolPlan(NamedTuple):
    """One pyramid launch: ``tasks`` threads (a vector of a 2^levels
    square tile each) in ``grid`` blocks of ``threads``; level 0 of
    ``height`` x ``width`` pixels of ``vecs`` vectors, float32 storage or
    bf16 (``f32``)."""
    tasks: int
    height: int
    width: int
    vecs: int
    levels: int
    f32: int
    threads: int
    grid: int


class PoolPlanStruct(ctypes.Structure):
    """A PoolPlan as the C entry reads it (``struct PoolPlan`` of
    ``csrc/resample.cu``)."""
    _fields_ = ([("tasks", ctypes.c_int64)]
                + [(name, ctypes.c_int32) for name in PoolPlan._fields[1:]])


class UpPlan(NamedTuple):
    """One upsample launch: ``units`` coarse vectors, one a thread in
    ``grid`` blocks of ``threads``; ``row_units`` a coarse row, ``vecs`` a
    pixel."""
    units: int
    row_units: int
    vecs: int
    threads: int
    grid: int


class UpPlanStruct(ctypes.Structure):
    """An UpPlan as the C entry reads it (``struct UpPlan``)."""
    _fields_ = ([("units", ctypes.c_int64)]
                + [(name, ctypes.c_int32) for name in UpPlan._fields[1:]])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pool_plan(N, H, W, vecs, levels, f32) -> PoolPlan:
    """The pyramid's launch for N images of H x W pixels of ``vecs``
    16-byte vectors, ``levels`` levels pooled."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{levels} levels; the kernel pools 1 to "
                         f"{MAX_LEVELS}")
    if H % (1 << levels) or W % (1 << levels):
        raise ValueError(f"{H}x{W} does not halve {levels} times")
    tasks = N * (H >> levels) * (W >> levels) * vecs
    grid = _cdiv(tasks, POOL_THREADS)
    if grid > _MAX_INT or H > _MAX_INT or W > _MAX_INT:
        raise ValueError(f"{N}x{H}x{W} exceeds the kernel's grid")
    return PoolPlan(tasks, H, W, vecs, levels, int(f32), POOL_THREADS,
                    grid)


def up_plan(N, H, W, vecs) -> UpPlan:
    """The upsample's launch for N coarse images of H x W pixels of
    ``vecs`` 16-byte vectors."""
    units = N * H * W * vecs
    if units > _MAX_INT:
        raise ValueError(f"{units} vectors exceed the kernel's index")
    return UpPlan(units, W * vecs, vecs, UP_THREADS,
                  _cdiv(units, UP_THREADS))


@functools.lru_cache(maxsize=256)
def _pool_plan_address(*key) -> tuple:
    """(the PoolPlanStruct of ``pool_plan(*key)``, its address), cached per
    shape: the cache keeps the struct alive."""
    struct = PoolPlanStruct(*pool_plan(*key))
    return struct, ctypes.addressof(struct)


@functools.lru_cache(maxsize=256)
def _up_plan_address(*key) -> tuple:
    struct = UpPlanStruct(*up_plan(*key))
    return struct, ctypes.addressof(struct)


def pool_pyramid_ref(x, levels: int) -> list:
    """Plain version: ``levels`` successive ``F.avg_pool2d(., 2)``."""
    out = [x]
    for _ in range(levels):
        out.append(F.avg_pool2d(out[-1], 2))
    return out[1:]


def upsample2_ref(x) -> torch.Tensor:
    """Plain version: ``F.interpolate``, nearest, 2x."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _nhwc(x):
    """x as the kernel reads it: channels_last contiguous, a copy counted
    in ``layout_copies`` where it is not."""
    global layout_copies
    if not x.is_contiguous(memory_format=torch.channels_last):
        layout_copies += 1
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def _check(x, what):
    if (x.ndim != 4 or x.device.type != "cuda" or x.dtype not in DTYPES
            or x.shape[1] * x.element_size() % VECTOR_BYTES
            or x.data_ptr() % VECTOR_BYTES or x.numel() == 0):
        raise ValueError(
            f"{what} takes a non-empty 4-D bf16 or float32 CUDA tensor whose "
            f"channels fill 16-byte vectors, 16-byte aligned; got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")


def _run(entry, *args, index):
    from sg2im_tpu_torch.ops._build import load_library

    global launches
    fn = getattr(load_library(), entry)
    if index == _current_device():
        rc = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _stream(index))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    launches += 1


def pool_pyramid(x, levels: int) -> list:
    """Levels 1 .. ``levels`` of the average pyramid of ``x`` (N, C, H, W),
    level l of H / 2^l x W / 2^l, each the 2x2 average of the one before
    rounded to x's type; channels_last on CUDA, in one launch."""
    if x.device.type == "cpu":
        return pool_pyramid_ref(x, levels)
    _check(x, "pool_pyramid")
    x = _nhwc(x)
    N, C, H, W = x.shape
    _, addr = _pool_plan_address(N, H, W, C * x.element_size()
                                 // VECTOR_BYTES, levels,
                                 x.dtype == torch.float32)
    outs = [torch.empty((N, C, H >> l, W >> l), dtype=x.dtype,
                        device=x.device, memory_format=torch.channels_last)
            for l in range(1, levels + 1)]
    ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in outs])
    _run("sg2im_pool_pyramid", x.data_ptr(), ctypes.addressof(ptrs), addr,
         index=x.get_device())
    return outs


def upsample2(x) -> torch.Tensor:
    """The nearest-2x upsample of ``x`` (N, C, H, W) -> (N, C, 2H, 2W),
    channels_last on CUDA."""
    if x.device.type == "cpu":
        return upsample2_ref(x)
    _check(x, "upsample2")
    x = _nhwc(x)
    N, C, H, W = x.shape
    _, addr = _up_plan_address(N, H, W, C * x.element_size() // VECTOR_BYTES)
    out = torch.empty((N, C, 2 * H, 2 * W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    _run("sg2im_upsample2", x.data_ptr(), out.data_ptr(), addr,
         index=x.get_device())
    return out
