"""Bilinear sampling, plain PyTorch: separable ("tent") sampling, the
crops' linspace grids, the border-clamped gather sampler and the general
grid sampler.

Counterpart of ``sg2im_tpu/ops/sampling.py``.  Every sampling grid of the
layout warp is separable, so bilinear sampling with torch-0.4
``F.grid_sample`` semantics (align_corners=True, zeros padding) is two small
matrix products with tent weights:

    out[y, x] = sum_ij  Wy[y, i] * img[i, j] * Wx[x, j]

with ``W[p, i] = max(0, 1 - |src(p) - i|)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tent_weights(src: torch.Tensor, size: int) -> torch.Tensor:
    """Dense 1-D bilinear weight matrix.

    Args:
      src: (...,) source coordinates in pixel space (0 .. size-1 are texels).
      size: number of source texels along the axis.

    Returns:
      (..., size) weights ``max(0, 1 - |src - i|)``.  Non-finite sources
      (a degenerate zero-width box divides by zero) give all-zero rows, the
      zeroing the reference relies on.
    """
    idx = torch.arange(size, dtype=src.dtype, device=src.device)
    w = (1.0 - (src[..., None] - idx).abs()).clamp_min(0.0)
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))


def separable_sample(img: torch.Tensor, wy: torch.Tensor,
                     wx: torch.Tensor) -> torch.Tensor:
    """``wy @ img @ wx^T``: img (..., H, W), wy (..., HH, H), wx (..., WW, W)
    -> (..., HH, WW)."""
    return torch.matmul(torch.matmul(wy, img), wx.transpose(-1, -2))


def normalized_to_pixel(coord, size: int):
    """align_corners=True normalized coordinates [-1, 1] -> pixel
    coordinates [0, size - 1]."""
    return (coord + 1.0) * 0.5 * (size - 1)


def tensor_linspace(start: torch.Tensor, end: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """Linspace between per-element ``start`` and ``end`` (upstream
    ``bilinear.py:249-278``): ``start.shape + (steps,)``, endpoints
    included."""
    w_end = torch.linspace(0.0, 1.0, steps, dtype=start.dtype,
                           device=start.device)
    w_start = torch.linspace(1.0, 0.0, steps, dtype=start.dtype,
                             device=start.device)
    return start[..., None] * w_start + end[..., None] * w_end


def bilinear_sample_border(img: torch.Tensor, X: torch.Tensor,
                           Y: torch.Tensor) -> torch.Tensor:
    """Gather-based bilinear sampling with upstream's hand-written
    sampler's border clamp (``bilinear.py:191-246``): corner indices are
    clamped into the image, and coordinates scale by the size, not size - 1.

    img (N, C, H, W); X, Y (N, HH, WW) in [0, 1] image space -> (N, C, HH,
    WW)."""
    N, C, H, W = img.shape
    gx, gy = X * W, Y * H
    x0 = gx.floor().clamp(0, W - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y0 = gy.floor().clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    flat = img.reshape(N, C, H * W)

    def gather(yi, xi):
        idx = (yi * W + xi).long().reshape(N, 1, -1).expand(-1, C, -1)
        return torch.gather(flat, 2, idx).reshape(N, C, *yi.shape[1:])

    w1 = ((x1 - gx) * (y1 - gy))[:, None]
    w2 = ((x1 - gx) * (gy - y0))[:, None]
    w3 = ((gx - x0) * (y1 - gy))[:, None]
    w4 = ((gx - x0) * (gy - y0))[:, None]
    return (w1 * gather(y0, x0) + w2 * gather(y1, x0) + w3 * gather(y0, x1)
            + w4 * gather(y1, x1))


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """General bilinear grid sample with torch-0.4 ``F.grid_sample``
    semantics (align_corners=True, zeros padding): grid values in [-1, 1]
    address texel centres, and taps outside the image add 0.  A grid point
    with a non-finite coordinate (a degenerate box) samples 0.

    The arguments keep the JAX function's layout: img (N, H, W, C) and
    grid (N, Hg, Wg, 2) with ``grid[..., 0]`` the x (width) coordinate ->
    (N, Hg, Wg, C).  This is the public sampler of the JAX package's API,
    whose tensors are NHWC, not one of the port's NCHW modules (none of
    which calls it): stock ``F.grid_sample`` runs it on NCHW views, as XLA
    runs it without a Pallas kernel.
    """
    finite = torch.isfinite(grid).all(-1)
    safe = torch.where(finite[..., None], grid, torch.zeros_like(grid))
    out = F.grid_sample(img.permute(0, 3, 1, 2), safe, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1) * finite[..., None].to(out.dtype)
