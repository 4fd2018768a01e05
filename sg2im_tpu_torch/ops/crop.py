"""Differentiable box crops for the object discriminator, NCHW.

Counterpart of ``sg2im_tpu/ops/crop.py`` (upstream ``sg2im/bilinear.py``).
The crop grid of a box is a separable linspace, so each crop is two tent
weight matrix products against its source image, batched over (image,
object) with no loop.  Coordinates follow upstream's ``crop_bbox`` with the
cuDNN grid sampler: boxes [x0, y0, x1, y1] in [0, 1], endpoints included,
align_corners=True, zeros padding:
``src_x(xx) = (x0 + (x1 - x0) * xx / (WW - 1)) * (W - 1)``.
The products are float32 sums; run them with TF32 off
(``inference.full_fp32``) where parity matters.
"""

from __future__ import annotations

import torch

from sg2im_tpu_torch.ops.sampling import (
    bilinear_sample_border,
    tensor_linspace,
    tent_weights,
)


def _crop_weights(boxes, HH: int, WW: int, H: int, W: int):
    """Tent weights for cropping: wy (..., HH, H), wx (..., WW, W)."""
    sx = tensor_linspace(boxes[..., 0], boxes[..., 2], WW) * (W - 1)
    sy = tensor_linspace(boxes[..., 1], boxes[..., 3], HH) * (H - 1)
    return tent_weights(sy, H), tent_weights(sx, W)


def crop_bbox(feats, bbox, HH: int, WW: int | None = None,
              backend: str = "separable") -> torch.Tensor:
    """crops[i] is bbox[i] (B, 4) cut from feats[i] (B, C, H, W) ->
    (B, C, HH, WW).  ``backend``: 'separable' (upstream's cuDNN zeros
    padding) or 'border' (upstream's hand-written sampler, border
    clamp)."""
    WW = HH if WW is None else WW
    B, C, H, W = feats.shape
    if backend == "border":
        X = tensor_linspace(bbox[:, 0], bbox[:, 2], WW)[:, None, :]
        Y = tensor_linspace(bbox[:, 1], bbox[:, 3], HH)[:, :, None]
        return bilinear_sample_border(feats, X.expand(B, HH, WW),
                                      Y.expand(B, HH, WW))
    if backend != "separable":
        raise ValueError(f'Invalid backend "{backend}"')
    wy, wx = _crop_weights(bbox, HH, WW, H, W)
    t = torch.einsum("byh,bchw->bcyw", wy, feats)
    return torch.einsum("bcyw,bxw->bcyx", t, wx)


def crop_bbox_batch(feats, bbox, bbox_to_feats, HH: int,
                    WW: int | None = None) -> torch.Tensor:
    """Upstream's flat API: crops[b] cuts bbox[b] from
    feats[bbox_to_feats[b]]; feats (N, C, H, W), bbox (B, 4) ->
    (B, C, HH, WW)."""
    return crop_bbox(feats[bbox_to_feats.long()], bbox, HH, WW)


def crop_bbox_padded(imgs, boxes, HH: int, WW: int | None = None
                     ) -> torch.Tensor:
    """Padded-batch crops, the object discriminator's path: imgs (N, C, H,
    W), boxes (N, O, 4) -> (N, O, C, HH, WW).  Padded slots give values
    the caller's loss masks out."""
    WW = HH if WW is None else WW
    H, W = imgs.shape[2:]
    wy, wx = _crop_weights(boxes, HH, WW, H, W)  # (N,O,HH,H), (N,O,WW,W)
    t = torch.einsum("noyh,nchw->nocyw", wy, imgs)
    return torch.einsum("nocyw,noxw->nocyx", t, wx)


def uncrop_bbox(feats, bbox, H: int, W: int | None = None,
                fill_value: float = 0.0) -> torch.Tensor:
    """Paste each crop back into its box (upstream ``uncrop_bbox``):
    feats (B, C, HH, WW), bbox (B, 4) -> (B, C, H, W), border-clamped
    bilinear samples of the crop at the inverse-warped coordinates and
    ``fill_value`` outside the box."""
    W = H if W is None else W
    B = feats.shape[0]
    x0, y0, x1, y1 = bbox.unbind(-1)
    tx = torch.linspace(0.0, 1.0, W, dtype=feats.dtype, device=feats.device)
    ty = torch.linspace(0.0, 1.0, H, dtype=feats.dtype, device=feats.device)
    X = (tx[None, :] - x0[:, None]) / (x1 - x0)[:, None]  # (B, W)
    Y = (ty[None, :] - y0[:, None]) / (y1 - y0)[:, None]  # (B, H)
    outside = (((X < 0) | (X > 1))[:, None, :]
               | ((Y < 0) | (Y > 1))[:, :, None])  # (B, H, W)
    out = bilinear_sample_border(feats, X[:, None, :].expand(B, H, W),
                                 Y[:, :, None].expand(B, H, W))
    return out.masked_fill(outside[:, None], fill_value)
