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
the TPU).

For CUDA output each wrapper launches the kernel or raises; for CPU output
it computes the plain version (``ops.prng``).  A key on the card is read by
the kernel where it lies (no launch waits for the host); a key on the CPU,
or given as two ints, is passed by value.  ``<wrapper>.launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from sg2im_tpu_torch.ops import prng

_DTYPES = {torch.float32: 1, torch.bfloat16: 2}
_MAX_GRID_Y = 65535 * 8


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

    N, C, Hd, Wd = _drawn_shape(shape, f)
    if memory_format not in (torch.contiguous_format, torch.channels_last):
        raise ValueError(f"memory_format must be contiguous or channels_last, "
                         f"got {memory_format}")
    c_inner = memory_format == torch.channels_last
    if ((Wd if c_inner else Hd) > _MAX_GRID_Y
            or N * (Hd if c_inner else C) >= 2 ** 31):
        raise ValueError(f"shape {tuple(shape)} exceeds the kernel's grid")
    offset = int(offset)
    if not 0 <= offset or offset + N * Hd * Wd * C > 1 << 64:
        raise ValueError(f"offset {offset} leaves the 64-bit counter space")
    kptr, k0, k1 = _key_args(key, device)
    out = torch.empty((N, C, Hd * f, Wd * f), dtype=dtype, device=device,
                      memory_format=memory_format)
    sn, sc, sy, sx = out.stride()
    with torch.cuda.device(device):
        rc = load_library().sg2im_threefry_normal(
            out.data_ptr(), None if kptr is None else kptr.data_ptr(),
            k0, k1, offset, mode, N, C, Hd, Wd, f, sn, sc, sy, sx,
            int(c_inner), torch.cuda.current_stream().cuda_stream)
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
