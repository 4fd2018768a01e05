"""Metrics of validation, of training and of the fidelity gate
(counterparts of ``sg2im_tpu/utils/metrics.py``: ``jaccard``,
``grad_global_norm`` and ``psnr``)."""

from __future__ import annotations

import numpy as np
import torch


def intersection(bbox_pred, bbox_gt):
    """Box intersection areas, elementwise over (..., 4) boxes."""
    max_xy = torch.minimum(bbox_pred[..., 2:], bbox_gt[..., 2:])
    min_xy = torch.maximum(bbox_pred[..., :2], bbox_gt[..., :2])
    inter = (max_xy - min_xy).clamp_min(0.0)
    return inter[..., 0] * inter[..., 1]


def jaccard(bbox_pred, bbox_gt, mask=None):
    """Sum of per-box IoU (upstream ``metrics.py:27-35``), over the boxes
    whose ``mask`` is 1; a box pair with no union counts 0, not NaN."""
    inter = intersection(bbox_pred, bbox_gt)
    area_pred = ((bbox_pred[..., 2] - bbox_pred[..., 0])
                 * (bbox_pred[..., 3] - bbox_pred[..., 1]))
    area_gt = ((bbox_gt[..., 2] - bbox_gt[..., 0])
               * (bbox_gt[..., 3] - bbox_gt[..., 1]))
    union = area_pred + area_gt - inter
    pos = union > 0
    iou = torch.where(pos, inter / torch.where(pos, union,
                                               torch.ones_like(union)),
                      torch.zeros_like(union))
    if mask is not None:
        iou = iou * mask.to(iou.dtype)
    return iou.sum()


def grad_global_norm(grads) -> torch.Tensor:
    """Global L2 norm, in float32, over gradient tensors given as an
    iterable or a dict (the JAX function takes a pytree); the sane
    replacement for upstream's ``get_total_norm`` (``metrics.py:37-49``).
    None entries (parameters without a gradient) are left out."""
    if isinstance(grads, dict):
        grads = grads.values()
    total = torch.zeros((), dtype=torch.float32)
    for g in grads:
        if g is not None:
            total = total.to(g.device) + g.float().square().sum()
    return total.sqrt()


def psnr(a, b, max_val: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two images or batches (dB)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val * max_val / mse))
