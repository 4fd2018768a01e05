"""Image pre- and deprocessing (counterpart of
``sg2im_tpu/data/transforms.py``, upstream ``sg2im/data/utils.py:22-80``).

Images are float32 in [0, 1] before :func:`imagenet_preprocess`; the
datasets hand out NHWC numpy arrays.  :func:`imagenet_deprocess_batch` is
the host version, which tests hold the on-device
:func:`imagenet_deprocess_batch_torch` to, bit for bit; the latter takes
the place of the JAX package's ``imagenet_deprocess_batch_jnp``.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_preprocess(img):
    """(..., H, W, 3) float in [0, 1] -> normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def imagenet_deprocess(img, rescale_image: bool = True):
    """Undo the normalisation of an (H, W, 3) or (N, H, W, 3) float array;
    with ``rescale_image``, min-max rescale each image over all channels.
    -> a float array of the same shape, in [0, 1] if rescaled (not yet
    uint8)."""
    x = img * IMAGENET_STD + IMAGENET_MEAN
    if rescale_image:
        if x.ndim == 3:
            lo, hi = x.min(), x.max()
        else:
            lo = x.reshape(x.shape[0], -1).min(axis=1)[:, None, None, None]
            hi = x.reshape(x.shape[0], -1).max(axis=1)[:, None, None, None]
        x = (x - lo) / (hi - lo)
    return x


def imagenet_deprocess_batch(imgs: np.ndarray,
                             rescale: bool = True) -> np.ndarray:
    """(N, H, W, 3) imagenet-normalised float -> (N, H, W, 3) uint8:
    denormalise, min-max rescale each image over all channels (unless
    ``rescale`` is False), scale by 255, clip, truncate (reference
    ``imagenet_deprocess_batch``)."""
    x = imagenet_deprocess(np.asarray(imgs), rescale_image=rescale)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def imagenet_deprocess_batch_torch(imgs: torch.Tensor) -> torch.Tensor:
    """:func:`imagenet_deprocess_batch` on the tensor's own device: (N, H,
    W, 3) float -> (N, H, W, 3) uint8 (an NCHW tensor goes in as its
    ``permute(0, 2, 3, 1)`` view, no copy).

    Eager elementwise ops, one IEEE float32 operation each in the host
    path's order (no fused multiply-add), so the bytes equal the host
    path's on the CPU and on the card."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.as_tensor(IMAGENET_STD, device=imgs.device)
    x = imgs.float() * std + mean
    flat = x.reshape(x.shape[0], -1)
    lo = flat.amin(dim=1)[:, None, None, None]
    hi = flat.amax(dim=1)[:, None, None, None]
    x = (x - lo) / (hi - lo)
    return (x * 255.0).clamp(0, 255).to(torch.uint8)


def resize_image(pil_img, size, interp=None):
    """PIL bilinear resize matching reference ``Resize``
    (``data/utils.py:70-80``); ``size`` is (H, W) or one int."""
    from PIL import Image

    interp = interp if interp is not None else Image.BILINEAR
    if isinstance(size, tuple):
        H, W = size
        return pil_img.resize((W, H), interp)
    return pil_img.resize((size, size), interp)
