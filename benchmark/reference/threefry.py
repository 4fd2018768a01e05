"""jax.random's partitionable threefry2x32 in plain torch: keys, split and
normals, as the port's layout noise and its train step draw them.

A frozen copy of the arithmetic (the Threefry-2x32 hash with 20 rounds,
Salmon et al., SC'11; ``jax.random.normal`` as ``sqrt(2) erf_inv(u)`` with
XLA's float32 ``erf_inv`` polynomial), kept here so that the reference
recomputes every noise value itself.  Arithmetic runs in int64 masked to 32
bits; each element's counter is its flat row-major index.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's float32 erf_inv (Giles): polynomials in w - 2.5 (w < 5) and
# sqrt(w) - 3 (w >= 5), w = -log1p(-x^2); highest power first.
_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
          -4.39150654e-06, 0.00021858087, -0.00125372503,
          -0.00417768164, 0.246640727, 1.50140941)
_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
          -0.00367342844, 0.00573950773, -0.0076224613,
          0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def hash2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 of the counter words (x0, x1) under key (k0, k1);
    int64 tensors or ints holding uint32 values."""
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


def key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: (0, seed mod 2**32)."""
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"a seed must fit int32, got {seed}")
    return 0, int(seed) & MASK32


def split(k: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(k, num)``: key i hashes the counter (0, i)."""
    return [tuple(int(w) for w in hash2x32(k[0], k[1], 0, i))
            for i in range(num)]


def normal_nhwc(k: tuple[int, int], shape, device,
                offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(k, (..., ) + shape[1:], float32)`` from flat
    index ``offset`` on, in ``shape`` (row-major)."""
    n = int(np.prod(shape))
    lo = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    hi = (lo >> 32) & MASK32
    lo = lo & MASK32
    y0, y1 = hash2x32(torch.tensor(k[0], device=device),
                      torch.tensor(k[1], device=device), hi, lo)
    bits = y0 ^ y1
    del y0, y1, hi, lo
    unit = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    unit = unit - 1.0
    del bits
    # uniform on [nextafter(-1, 0), 1): the affine map rounded once.
    minval = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = float(np.float32(1.0) - minval)  # a float32 difference: 2.0
    minval = float(minval)
    u = (unit.double() * span + minval).float()
    u = torch.clamp_min(u, minval)
    del unit
    w = -torch.log1p(u * -u)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _SMALL[0], _LARGE[0])
    for a, b in zip(_SMALL[1:], _LARGE[1:]):
        p = (p.double() * t + torch.where(small, a, b).double()).float()
    x = torch.where(u.abs() == 1.0, u * float("inf"), p * u)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=device)
    return (sqrt2 * x).reshape(shape)


def layout_noise(k: tuple[int, int], n: int, channels: int, height: int,
                 width: int, device, row: int = 0) -> torch.Tensor:
    """Rows row ... row + n - 1 of the layout noise, (n, C, H, W): those
    rows of ``jax.random.normal(k, (., H, W, C))`` with their channels
    moved to dim 1."""
    return normal_nhwc(k, (n, height, width, channels), device,
                       offset=row * height * width * channels
                       ).permute(0, 3, 1, 2)
