"""Spatial ops and the Hopper kernels' wrappers (counterpart of
``sg2im_tpu/ops/``, with the same names): boxes, crops, the layout compose
and sampling; ``layout_kernel``, ``conv_kernel`` and ``relayout`` hold the
kernels' wrappers and plain versions."""

from sg2im_tpu_torch.ops.boxes import (
    apply_box_transform,
    centers_to_extents,
    extents_to_centers,
    invert_box_transform,
)
from sg2im_tpu_torch.ops.crop import (
    crop_bbox,
    crop_bbox_batch,
    crop_bbox_padded,
    uncrop_bbox,
)
from sg2im_tpu_torch.ops.layout import (
    box_warp,
    boxes_to_layout,
    boxes_to_layout_flat,
    mask_warp,
    masks_to_layout,
    masks_to_layout_flat,
)
from sg2im_tpu_torch.ops.sampling import (
    bilinear_sample_border,
    grid_sample,
    separable_sample,
    tensor_linspace,
    tent_weights,
)

__all__ = [
    "apply_box_transform",
    "bilinear_sample_border",
    "box_warp",
    "boxes_to_layout",
    "boxes_to_layout_flat",
    "centers_to_extents",
    "crop_bbox",
    "crop_bbox_batch",
    "crop_bbox_padded",
    "extents_to_centers",
    "grid_sample",
    "invert_box_transform",
    "mask_warp",
    "masks_to_layout",
    "masks_to_layout_flat",
    "separable_sample",
    "tensor_linspace",
    "tent_weights",
    "uncrop_bbox",
]
