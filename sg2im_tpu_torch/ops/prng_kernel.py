"""Threefry normals: the Hopper kernel's wrappers, their plain versions and
their launch counters.

``threefry_normal(key, (N, C, H, W), f, dtype, offset)`` is the layout noise
of the JAX package: ``jax.random.normal(key, (N, H / f, W / f, C), dtype)``
drawn from flat index ``offset`` on, nearest-upsampled by ``f`` and returned
as the (N, C, H, W) tensor the generator takes (NCHW, or channels_last when
asked: the JAX array's own bytes).  ``threefry_bits`` is the same walk with
the 32 random bits of each element (int32) in place of the normal, for
checking the hash.  ``threefry_split(key, num)`` is ``jax.random.split``
in one launch, for a key that lives on the card (the train step's).  The
CUDA source is ``csrc/threefry.cu``, whose notes say what bounds the
kernels; they replace no TPU kernel (XLA expands ``jax.random`` itself on
the TPU).  ``normal_plan`` is the kernel's walk over one draw (values a
thread, the grid); the wrapper passes it to the launch.

For CUDA output each wrapper launches the kernel or raises; for CPU output
it computes the plain version (``ops.prng``).  A key on the card is read by
the kernel where it lies (no launch waits for the host); a key on the CPU,
or given as two ints, is passed by value.  ``<wrapper>.launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sg2im_tpu_torch.ops import prng

_DTYPES = {torch.float32: 1, torch.bfloat16: 2}

# The normal kernel's constants (csrc/threefry.cu).
THREADS = 256        # threads a block
VEC_BYTES = 16       # a thread's values: one 16-byte store at f = 1
MAX_GRID_YZ = 65535  # blocks along grid y and z
WALK_FLAT, WALK_PIXEL, WALK_ROW = 0, 1, 2


class NormalPlan(NamedTuple):
    """How the normal kernel walks one draw of (N, C, H, W) at f.  Each
    thread draws V consecutive values along the output's innermost
    dimension (V = 16 bytes of the output type):

    * ``WALK_FLAT`` (channels_last, f 1): thread q of the 1-D grid draws
      flat indices q V ... q V + V - 1, which are also its output elements;
    * ``WALK_PIXEL`` (channels_last, f > 1): block (x, Hd, N); in the
      drawn row (n, yd) = (z, y), thread q draws channels j V ... of the
      pixel xd = q // J (J = ceil(C / V) runs a pixel), stored f x f times;
    * ``WALK_ROW`` (NCHW): block (x, C, N); in the plane (n, c) = (z, y),
      thread q draws the columns k V ... of the drawn row yd = q // J (J =
      ceil(Wd / V) runs a row), each stored f times along the row and in f
      rows.

    ``j_mul``, ``j_shift``: q // J = (umulhi(q, j_mul) + q) >> j_shift for
    q < 2^31.  ``vec``: the runs' stores are 16-byte aligned (C, or the
    output width, a multiple of V).  ``carry``: the draw's counters cross a
    multiple of 2^32, so a run's values may differ in their hi word.
    ``drawn``: (N, C, H / f, W / f)."""
    drawn: tuple
    walk: int
    V: int
    J: int
    j_mul: int
    j_shift: int
    vec: bool
    carry: bool
    block: int
    grid: tuple


def magic_divisor(d: int) -> tuple[int, int]:
    """(mul, shift) such that q // d = (umulhi(q, mul) + q) >> shift for
    0 <= q < 2^31, 1 <= d < 2^31 (a multiply-high, an add and a shift in
    place of a division)."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} out of range")
    shift = (d - 1).bit_length()
    return (((1 << 32) * ((1 << shift) - d)) // d + 1) & 0xFFFFFFFF, shift


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def normal_plan(shape, f: int = 1, memory_format=torch.contiguous_format,
                dtype=torch.float32, offset: int = 0) -> NormalPlan:
    """The normal kernel's plan for a draw of ``shape`` (N, C, H, W) at
    ``f`` in ``memory_format`` with ``dtype`` output (float32, bfloat16,
    or int32 for :func:`threefry_bits`) from counter ``offset``; raises
    for a shape the kernel does not take."""
    N, C, Hd, Wd = _drawn_shape(shape, f)
    if memory_format not in (torch.contiguous_format, torch.channels_last):
        raise ValueError(f"memory_format must be contiguous or channels_last, "
                         f"got {memory_format}")
    if dtype not in (torch.float32, torch.bfloat16, torch.int32):
        raise TypeError(f"no normal kernel for {dtype}")
    V = VEC_BYTES // dtype.itemsize
    total = N * C * Hd * Wd
    offset = int(offset)
    if not 0 <= offset or offset + total > 1 << 64:
        raise ValueError(f"offset {offset} leaves the 64-bit counter space")
    # Per-image element counts and the thread's 32-bit index arithmetic.
    if (f * f * Hd * Wd + 64) * C >= 2 ** 31 or N > MAX_GRID_YZ:
        raise ValueError(f"shape {tuple(shape)} exceeds the kernel's grid")
    carry = (offset >> 32) != ((offset + total - 1) >> 32)
    if memory_format == torch.channels_last and f == 1:
        walk, J, vec, items, gy, gz = WALK_FLAT, 1, True, _cdiv(total, V), 1, 1
        if items >= 2 ** 31:
            raise ValueError(f"shape {tuple(shape)} exceeds the kernel's "
                             f"grid")
    elif memory_format == torch.channels_last:
        J = _cdiv(C, V)
        walk, vec, items, gy, gz = WALK_PIXEL, C % V == 0, Wd * J, Hd, N
    else:
        J = _cdiv(Wd, V)
        walk, vec, items, gy, gz = WALK_ROW, Wd * f % V == 0, Hd * J, C, N
    if gy > MAX_GRID_YZ:
        raise ValueError(f"shape {tuple(shape)} exceeds the kernel's grid")
    mul, shift = magic_divisor(J)
    return NormalPlan((N, C, Hd, Wd), walk, V, J, mul, shift, vec, carry,
                      THREADS, (_cdiv(items, THREADS), gy, gz))


# The wrapper's plans, by the hashable arguments of normal_plan: a draw's
# host work is then its launch alone.
_cached_plan = functools.lru_cache(maxsize=1024)(normal_plan)


def _drawn_shape(shape, f: int):
    N, C, H, W = (int(s) for s in shape)
    if min(N, C, H, W) < 1:
        raise ValueError(f"shape must be (N, C, H, W) >= 1, got {shape}")
    if f not in (1, 2, 4) or H % f or W % f:
        raise ValueError(f"f = {f} must be 1, 2 or 4 and divide H = {H}, "
                         f"W = {W}")
    return N, C, H // f, W // f


def _plain(draw, key, shape, f, memory_format, device):
    N, C, Hd, Wd = _drawn_shape(shape, f)
    out = draw(key, (N, Hd, Wd, C), device).permute(0, 3, 1, 2)
    if f > 1:
        out = out.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
    return out.contiguous(memory_format=memory_format)


def _key_args(key, device):
    """(key tensor on the card or None, k0, k1): a key on the card is read
    by the kernel where it lies; any other key is passed by value."""
    if isinstance(key, torch.Tensor) and key.device.type == "cuda":
        if key.device != device or key.shape != (2,):
            raise ValueError(f"a key on the card must be (2,) on {device}, "
                             f"got {tuple(key.shape)} on {key.device}")
        if key.dtype not in (torch.uint32, torch.int32):
            raise TypeError(f"a key on the card must be uint32 (or its "
                            f"int32 bits), got {key.dtype}")
        return key.contiguous(), 0, 0
    k0, k1 = prng.key_words(key)
    return None, k0, k1


def _launch(mode, key, shape, f, offset, dtype, memory_format, device):
    from sg2im_tpu_torch.ops._build import load_library

    plan = _cached_plan(tuple(shape), f, memory_format, dtype, int(offset))
    N, C, Hd, Wd = plan.drawn
    kptr, k0, k1 = _key_args(key, device)
    out = torch.empty((N, C, Hd * f, Wd * f), dtype=dtype, device=device,
                      memory_format=memory_format)
    with torch.cuda.device(device):
        rc = load_library().sg2im_threefry_normal(
            out.data_ptr(), None if kptr is None else kptr.data_ptr(),
            k0, k1, int(offset), mode, plan.walk, int(plan.carry), N, C, Hd,
            Wd, f, plan.V, plan.J, plan.j_mul, plan.j_shift, int(plan.vec),
            *plan.grid, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sg2im_threefry_normal launch failed: "
                           f"cudaError {rc}")
    return out


def _device(key, device):
    if device is not None:
        device = torch.device(device)
    elif isinstance(key, torch.Tensor):
        device = key.device
    else:
        device = torch.device("cpu")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"threefry draws run on CPU or CUDA, not {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def threefry_normal(key, shape, f: int = 1, dtype=torch.float32,
                    offset: int = 0, device=None,
                    memory_format=torch.contiguous_format) -> torch.Tensor:
    """The (N, C, H, W) layout noise of ``key``: element (n, c, y, x) is
    element (n, y // f, x // f, c) of ``jax.random.normal(key, (N, H // f,
    W // f, C), dtype)`` started at flat index ``offset``.  On ``device``
    (default the key's, the CPU for ints)."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype must be one of {tuple(_DTYPES)}, got {dtype}")
    device = _device(key, device)
    if device.type == "cpu":
        return _plain(lambda k, s, d: prng.normal(k, s, dtype, offset, d),
                      key, shape, f, memory_format, device)
    out = _launch(_DTYPES[dtype], key, shape, f, offset, dtype,
                  memory_format, device)
    threefry_normal.launches += 1
    return out


def threefry_bits(key, shape, f: int = 1, offset: int = 0, device=None,
                  memory_format=torch.contiguous_format) -> torch.Tensor:
    """:func:`threefry_normal`'s walk with each element's 32 random bits
    (``jax.random.bits``) as int32 in place of its normal."""
    device = _device(key, device)
    if device.type == "cpu":
        return _plain(
            lambda k, s, d: prng.random_bits(k, s, offset, d).to(torch.int32),
            key, shape, f, memory_format, device)
    out = _launch(0, key, shape, f, offset, torch.int32, memory_format,
                  device)
    threefry_bits.launches += 1
    return out


def threefry_split(key, num: int = 2, device=None) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys on ``device``
    (default the key's, the CPU for ints)."""
    from sg2im_tpu_torch.ops._build import load_library

    num = int(num)
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    device = _device(key, device)
    if device.type == "cpu":
        return prng.split(key, num).to(device)
    kptr, k0, k1 = _key_args(key, device)
    out = torch.empty((num, 2), dtype=torch.uint32, device=device)
    with torch.cuda.device(device):
        rc = load_library().sg2im_threefry_split(
            out.data_ptr(), None if kptr is None else kptr.data_ptr(),
            k0, k1, num, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sg2im_threefry_split launch failed: "
                           f"cudaError {rc}")
    threefry_split.launches += 1
    return out


threefry_normal.launches = 0
threefry_bits.launches = 0
threefry_split.launches = 0
