"""The JAX package's random numbers in PyTorch: threefry2x32 keys, splits,
bits, uniforms and normals that equal ``jax.random``'s (partitionable
threefry, the JAX default and what the JAX package requires).

Plain versions in torch ops, on any device.  The names follow
``jax.random`` so that each has its counterpart:

* :func:`threefry2x32` is the Threefry-2x32 hash with 20 rounds (Salmon et
  al., SC'11; ``jax._src.prng._threefry2x32_lowering``);
* :func:`prng_key` is ``jax.random.PRNGKey`` for an int32 seed (64-bit mode
  off): the key ``[0, seed mod 2**32]``;
* :func:`split` is the partitionable ``threefry_split``: key ``i`` of
  ``num`` is the hash of the counter pair ``(0, i)``;
* :func:`random_bits` hashes the counter pairs ``(hi, lo)`` of each
  element's flat row-major index (plus ``offset``) and XORs the two output
  words;
* :func:`uniform` and :func:`normal` are ``jax.random.uniform`` and
  ``jax.random.normal`` (``_normal_real``: ``sqrt(2) erf_inv(u)`` with ``u``
  uniform on ``[nextafter(-1, 0), 1)``), where :func:`erf_inv_f32` is XLA's
  float32 polynomial (Giles), not ``torch.erfinv``.

Keys are (2,) integer tensors holding the two uint32 words (torch.uint32
or int64), or any pair of Python ints.  Arithmetic runs in int64 masked to
32 bits, since torch has few uint32 operations.

``offset`` is the flat index of the first element drawn, so that a draw of
rows r ... r + n - 1 equals those rows of the whole draw: this is what keeps
pad buckets, coalesced batches and data-parallel ranks row-stable.

bfloat16 follows JAX: ``uniform`` takes 8 random bits (the low byte of the
XOR) for bfloat16's 7 mantissa bits, its arithmetic rounds to bfloat16 after
each operation, ``erf_inv`` runs in float32 on the bfloat16 uniform and is
rounded, and the product with bfloat16's ``sqrt(2)`` is rounded again.

The draw on the card is the hand-written kernel of ``ops/prng_kernel.py``;
this module's functions are its plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's float32 erf_inv: Giles' polynomials in w - 2.5 (w < 5) and
# sqrt(w) - 3 (w >= 5), w = -log1p(-x^2); highest power first.
ERF_INV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
ERF_INV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)

_FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def key_words(key) -> tuple[int, int]:
    """The two uint32 words of a key: a (2,) tensor (uint32 or its int32
    bits read as uint32), array or sequence."""
    if isinstance(key, torch.Tensor):
        if key.dtype in (torch.uint32, torch.int32) and key.shape == (2,):
            k0, k1 = key.detach().view(torch.int32).tolist()
            return k0 & MASK32, k1 & MASK32
        key = key.detach().cpu().to(torch.int64).tolist()
    words = [int(w) for w in np.asarray(key).reshape(-1).tolist()]
    if len(words) != 2 or not all(0 <= w <= MASK32 for w in words):
        raise ValueError(f"a threefry key is two uint32 words, got {key!r}")
    return words[0], words[1]


def _as_words(key, device):
    """(k0, k1) as int64 0-dim tensors on ``device``."""
    if isinstance(key, torch.Tensor):
        k = key.to(device=device, dtype=torch.int64)
        if k.shape != (2,):
            raise ValueError(f"a threefry key has shape (2,), got "
                             f"{tuple(k.shape)}")
        return k[0] & MASK32, k[1] & MASK32
    k0, k1 = key_words(key)
    return (torch.tensor(k0, dtype=torch.int64, device=device),
            torch.tensor(k1, dtype=torch.int64, device=device))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: the key words ``k0``, ``k1`` and the
    counter words ``x0``, ``x1`` (int64 tensors holding uint32 values, any
    broadcastable shapes) -> the two output words, int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) uint32 tensor on ``device``.
    Seeds must fit int32, as the JAX engine requires."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit int32, got {seed}")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=device).to(torch.uint32)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys on the key's
    device (the CPU for a key given as ints)."""
    device = key.device if isinstance(key, torch.Tensor) else "cpu"
    k0, k1 = _as_words(key, device)
    lo = torch.arange(num, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=1).to(torch.uint32)


def _counters(shape, offset: int, device):
    """Each element's 64-bit counter, flat index + ``offset``, as its (hi,
    lo) words."""
    n = int(np.prod(shape, dtype=np.int64))
    offset = int(offset)
    if not (0 <= offset and offset + n <= 1 << 64):
        raise ValueError(f"offset {offset} + {n} elements leaves the 64-bit "
                         "counter space")
    base_hi, base_lo = offset >> 32, offset & MASK32
    lo = torch.arange(n, dtype=torch.int64, device=device) + base_lo
    hi = ((lo >> 32) + base_hi) & MASK32
    return hi.reshape(shape), (lo & MASK32).reshape(shape)


def random_bits(key, shape, offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` from flat index ``offset``
    on: int64 tensor of uint32 values on ``device`` (default the key's)."""
    if device is None:
        device = key.device if isinstance(key, torch.Tensor) else "cpu"
    shape = tuple(int(s) for s in shape)
    k0, k1 = _as_words(key, device)
    hi, lo = _counters(shape, offset, device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def _bits_to_unit(bits, dtype):
    """Random bits -> floats in [0, 1) of ``dtype``: the mantissa bits of
    a float in [1, 2), minus 1 (``jax.random._uniform``)."""
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    else:
        f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
            torch.bfloat16)
    return f - 1.0


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
            offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` from flat
    index ``offset`` on (float32 or bfloat16)."""
    if dtype not in _FLOAT_DTYPES:
        raise TypeError(f"uniform takes {_FLOAT_DTYPES}, got {dtype}")
    bits = random_bits(key, shape, offset, device)
    lo = torch.tensor(minval, dtype=dtype, device=bits.device)
    hi = torch.tensor(maxval, dtype=dtype, device=bits.device)
    floats = _bits_to_unit(bits, dtype)
    # XLA fuses the product and the sum (one rounding): the product of two
    # float32 values is exact in float64, and so is the sum for the ranges
    # the package draws (the normal's product, by 2, is exact anyway).
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.to(dtype))


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (not ``torch.erfinv``): ±inf at |x| = 1.
    Where ``w`` lies within rounding of 5, a log1p that rounds otherwise
    than XLA's takes the other polynomial, about 1e-3 away."""
    x = x.float()
    w = -torch.log1p(x * -x)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERF_INV_SMALL[0], ERF_INV_LARGE[0])
    t64 = t.double()
    for a, b in zip(ERF_INV_SMALL[1:], ERF_INV_LARGE[1:]):
        # One fused multiply-add, as XLA emits it: the product is exact in
        # float64 and the sum is rounded to float32 (twice, which differs
        # from one rounding only on a float64 result exactly halfway
        # between two float32 values).
        p = (p.double() * t64 + torch.where(small, a, b).double()).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, shape, dtype=torch.float32, offset: int = 0,
           device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` from flat index ``offset``
    on (float32 or bfloat16)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    if dtype == torch.bfloat16:
        lo = float(torch.nextafter(torch.tensor(-1.0, dtype=torch.bfloat16),
                                   torch.tensor(0.0, dtype=torch.bfloat16)))
    u = uniform(key, shape, dtype, lo, 1.0, offset, device)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=dtype, device=u.device)
    return sqrt2 * erf_inv_f32(u).to(dtype)
