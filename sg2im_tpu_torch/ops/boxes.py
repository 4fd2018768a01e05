"""Box coordinate transforms (counterpart of ``sg2im_tpu/ops/boxes.py``,
upstream ``sg2im/box_utils.py``).  Boxes are (..., 4)."""

from __future__ import annotations

import torch


def apply_box_transform(anchors, transforms):
    """Apply [tx, ty, tw, th] transforms to [xc, yc, w, h] anchors."""
    xa, ya, wa, ha = anchors.unbind(-1)
    tx, ty, tw, th = transforms.unbind(-1)
    return torch.stack([xa + tx * wa, ya + ty * ha, wa * torch.exp(tw),
                        ha * torch.exp(th)], dim=-1)


def invert_box_transform(anchors, boxes):
    """The transform that maps anchors onto boxes ([xc, yc, w, h])."""
    xa, ya, wa, ha = anchors.unbind(-1)
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([(x - xa) / wa, (y - ya) / ha,
                        torch.log(w) - torch.log(wa),
                        torch.log(h) - torch.log(ha)], dim=-1)


def centers_to_extents(boxes):
    """[xc, yc, w, h] -> [x0, y0, x1, y1]."""
    xc, yc, w, h = boxes.unbind(-1)
    x0, y0 = xc - w / 2, yc - h / 2
    return torch.stack([x0, y0, x0 + w, y0 + h], dim=-1)


def extents_to_centers(boxes):
    """[x0, y0, x1, y1] -> [xc, yc, w, h]."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([0.5 * (x0 + x1), 0.5 * (y0 + y1), x1 - x0, y1 - y0],
                       dim=-1)
