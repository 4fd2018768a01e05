"""Scene layout composition over padded graph batches, NHWC.

Counterpart of ``sg2im_tpu/ops/layout.py``.  The warped input is rank one
along the channel axis and the box warp is separable, so

    warp[o]   = Wy[o] @ mask[o] @ Wx[o]^T          # (H, W)
    layout[n] = sum_o warp[n, o] * vecs[n, o]      # (H, W, D)

``masks_to_layout`` runs this through the Hopper kernel for CUDA tensors
(``ops/layout_kernel.py``) and through the plain version for CPU tensors.
Layouts are returned NHWC, as the JAX package returns them; the generator
views them as NCHW with ``permute(0, 3, 1, 2)``, which costs nothing.
The flat (ragged) APIs ``boxes_to_layout_flat`` / ``masks_to_layout_flat``
take upstream's signature (objects of all images in one list, with
``obj_to_img``); they are plain PyTorch, as their JAX counterparts are
plain jnp.
"""

from __future__ import annotations

import torch

from sg2im_tpu_torch.ops.layout_kernel import (
    layout_compose,
    layout_compose_weights,
)
from sg2im_tpu_torch.ops.sampling import separable_sample, tent_weights

BACKENDS = ("auto", "torch", "cuda")


def box_warp_coords(boxes: torch.Tensor, out_size: int, in_size: int,
                    axis: int) -> torch.Tensor:
    """Source pixel coordinates of one axis of the box warp.

    ``t = p / (out_size - 1)`` (the endpoints of ``linspace(0, 1)``),
    ``s = (t - lo) / (hi - lo) * (in_size - 1)``, with (lo, hi) = (x0, x1)
    for axis 0 and (y0, y1) for axis 1 of boxes (..., 4) [x0, y0, x1, y1]
    in [0, 1].  The kernel evaluates the same expression.

    Returns (..., out_size).
    """
    lo = boxes[..., axis]
    hi = boxes[..., 2 + axis]
    # t rounded once from float64, as the kernel's IEEE division rounds it
    # (a float32 division by a Python scalar may be a multiplication by its
    # reciprocal, an ulp off, and s amplifies that by (M-1) / (hi-lo)).
    t = (torch.arange(out_size, dtype=torch.float64, device=boxes.device)
         / (out_size - 1)).to(boxes.dtype)
    return (t - lo[..., None]) / (hi - lo)[..., None] * (in_size - 1)


def box_warp_weights(boxes: torch.Tensor, out_h: int, out_w: int, in_h: int,
                     in_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Tent weights (wy (..., out_h, in_h), wx (..., out_w, in_w)) warping an
    (in_h, in_w) source into box positions of an (out_h, out_w) canvas."""
    sy = box_warp_coords(boxes, out_h, in_h, axis=1)
    sx = box_warp_coords(boxes, out_w, in_w, axis=0)
    return tent_weights(sy, in_h), tent_weights(sx, in_w)


def mask_warp(boxes, masks, H: int, W: int) -> torch.Tensor:
    """Warp masks (..., M, M) into their boxes: (..., H, W) coefficients."""
    M_h, M_w = masks.shape[-2:]
    wy, wx = box_warp_weights(boxes, H, W, M_h, M_w)
    return separable_sample(masks, wy, wx)


def box_warp(boxes, H: int, W: int, tile: int = 8) -> torch.Tensor:
    """Warp coefficients of the boxes-only path: ``mask_warp`` of an all-ones
    (tile, tile) mask, an outer product of summed tent weights."""
    wy, wx = box_warp_weights(boxes, H, W, tile, tile)
    return wy.sum(-1)[..., :, None] * wx.sum(-1)[..., None, :]


def _compose(warp, vecs, obj_mask, pooling: str) -> torch.Tensor:
    """layout[n] = sum_o warp[n, o] * vecs[n, o]: warp (N, O, H, W), vecs
    (N, O, D), obj_mask (N, O) or None -> (N, H, W, D) f32."""
    N, O = warp.shape[:2]
    if obj_mask is not None:
        warp = warp * obj_mask[:, :, None, None].to(warp.dtype)
    out = torch.einsum("nohw,nod->nhwd", warp.float(), vecs.float())
    return _apply_avg(out, obj_mask, pooling, O)


def _apply_avg(out, obj_mask, pooling: str, num_objs: int) -> torch.Tensor:
    if pooling == "sum":
        return out
    if pooling != "avg":
        raise ValueError(f'Invalid pooling "{pooling}"')
    if obj_mask is None:
        counts = torch.full((out.shape[0],), float(num_objs),
                            dtype=out.dtype, device=out.device)
    else:
        counts = obj_mask.to(out.dtype).sum(-1).clamp_min(1.0)
    return out / counts[:, None, None, None]


def boxes_to_layout(vecs, boxes, obj_mask, H: int, W: int | None = None,
                    pooling: str = "sum") -> torch.Tensor:
    """Layout from boxes only: vecs (N, O, D), boxes (N, O, 4), obj_mask
    (N, O) or None -> (N, H, W, D) f32.  Plain PyTorch (no TPU kernel
    serves this path)."""
    W = H if W is None else W
    return _compose(box_warp(boxes, H, W), vecs, obj_mask, pooling)


def masks_to_layout(vecs, boxes, masks, obj_mask, H: int,
                    W: int | None = None, pooling: str = "sum",
                    backend: str = "auto", weights=None,
                    out_dtype=None) -> torch.Tensor:
    """Layout modulated by per-object masks.

    Args:
      vecs: (N, O, D); boxes: (N, O, 4) [x0, y0, x1, y1] in [0, 1];
      masks: (N, O, M, M); obj_mask: (N, O) or None (all slots real).
      backend: 'auto' (the kernel for CUDA tensors, the plain path for CPU
        ones), 'torch' (the plain path: materialise the (N, O, H, W) warp),
        or 'cuda' (the kernel's wrapper, which itself uses the plain
        version only for CPU tensors).
      weights: optional (wy (N, O, H, M), wx (N, O, W, M)) tent weights to
        use instead of the boxes' own; with a kernel backend they go to the
        weights entry of the kernel.
      out_dtype: dtype of the result (default float32).  The sums are
        float32 in every backend; bfloat16 is written directly by the
        kernel.

    Returns:
      (N, H, W, D) layout, NHWC.
    """
    W = H if W is None else W
    if backend not in BACKENDS:
        raise ValueError(f'Invalid backend "{backend}"; one of {BACKENDS}')
    if backend == "auto":
        backend = "cuda" if vecs.is_cuda else "torch"
    out_dtype = out_dtype or torch.float32
    masks = masks.to(vecs.dtype)
    if backend == "torch":
        if weights is None:
            warp = mask_warp(boxes, masks, H, W)
        else:
            warp = separable_sample(masks, *weights)
        return _compose(warp, vecs, obj_mask, pooling).to(out_dtype)
    v = vecs if obj_mask is None else vecs * obj_mask[..., None].to(
        vecs.dtype)
    # The kernel writes out_dtype directly, except under 'avg', whose
    # division happens in f32 afterwards.
    kernel_dtype = out_dtype if pooling == "sum" else torch.float32
    if weights is None:
        out = layout_compose(boxes, masks, v, H, W, out_dtype=kernel_dtype)
    else:
        out = layout_compose_weights(*weights, masks, v,
                                     out_dtype=kernel_dtype)
    return _apply_avg(out, obj_mask, pooling, vecs.shape[1]).to(out_dtype)


def boxes_to_layout_flat(vecs, boxes, obj_to_img, H: int,
                         W: int | None = None, pooling: str = "sum",
                         num_imgs: int | None = None) -> torch.Tensor:
    """Upstream's ragged ``boxes_to_layout`` signature: vecs (O, D), boxes
    (O, 4), obj_to_img (O,) -> (N, H, W, D), N = ``num_imgs`` or
    ``obj_to_img.max() + 1``."""
    W = H if W is None else W
    N = int(num_imgs) if num_imgs is not None else int(obj_to_img.max()) + 1
    return _compose_flat(box_warp(boxes, H, W), vecs, obj_to_img, N, pooling)


def masks_to_layout_flat(vecs, boxes, masks, obj_to_img, H: int,
                         W: int | None = None, pooling: str = "sum",
                         num_imgs: int | None = None) -> torch.Tensor:
    """Upstream's ragged ``masks_to_layout`` signature: as
    :func:`boxes_to_layout_flat`, with masks (O, M, M)."""
    W = H if W is None else W
    N = int(num_imgs) if num_imgs is not None else int(obj_to_img.max()) + 1
    warp = mask_warp(boxes, masks.to(vecs.dtype), H, W)
    return _compose_flat(warp, vecs, obj_to_img, N, pooling)


def _compose_flat(warp, vecs, obj_to_img, N: int, pooling: str):
    """out[n] = sum over objects o of image n of warp[o] * vecs[o]: warp
    (O, H, W), vecs (O, D) -> (N, H, W, D)."""
    O, H, W = warp.shape
    onehot = torch.nn.functional.one_hot(obj_to_img.long(), N).to(vecs.dtype)
    vec_n = onehot[:, :, None] * vecs[:, None, :]  # (O, N, D)
    out = torch.einsum("ond,op->npd", vec_n, warp.reshape(O, H * W))
    out = out.reshape(N, H, W, -1)
    if pooling == "avg":
        counts = onehot.sum(0).clamp_min(1.0)
        out = out / counts[:, None, None, None]
    elif pooling != "sum":
        raise ValueError(f'Invalid pooling "{pooling}"')
    return out
