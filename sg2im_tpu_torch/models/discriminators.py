"""The GAN discriminators, NCHW (counterparts of
``sg2im_tpu/models/discriminators.py``, upstream
``sg2im/discriminators.py``).

State-dict names are upstream's: ``cnn.{i}`` for the patch discriminator,
``discriminator.cnn.0.{i}``, ``discriminator.cnn.2``,
``discriminator.real_classifier`` and ``discriminator.obj_classifier`` for
the object one, so that the JAX package's variables carry across
(``ckpt.state_dict_from_jax``).  Upstream's patch discriminator also builds
a 1x1 ``classifier`` its forward never uses; it is not built here.
Initialise with :func:`sg2im_tpu_torch.nn.layers.init_weights` and a seeded
``torch.Generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from sg2im_tpu_torch.nn.layers import ArchCNN, GlobalAvgPool, parse_arch
from sg2im_tpu_torch.ops.crop import crop_bbox_padded


class PatchDiscriminator(nn.Module):
    """Arch-string CNN over images; returns its last feature map as the
    patch scores (upstream ``discriminators.py:25-45``)."""

    def __init__(self, arch: str, normalization: str = "batch",
                 activation: str = "leakyrelu-0.2", padding: str = "same",
                 pooling: str = "avg", layout_dim: int = 0):
        super().__init__()
        self.cnn = ArchCNN(f"I{3 + layout_dim},{arch}", normalization,
                           activation, padding, pooling)

    def forward(self, x, layout=None):
        """x (N, 3, H, W), optional layout (N, layout_dim, H, W) ->
        scores (N, C, h, w)."""
        if layout is not None:
            x = torch.cat([x, layout], dim=1)
        return self.cnn(x)


class AcDiscriminator(nn.Module):
    """CNN, global average pool and Linear(1024), then a real/fake head and
    an auxiliary object classifier (upstream ``discriminators.py:48-75``,
    returning logits instead of the loss)."""

    def __init__(self, vocab, arch: str, normalization: str = "none",
                 activation: str = "relu", padding: str = "same",
                 pooling: str = "avg"):
        super().__init__()
        _, cnn_dim = parse_arch(arch, normalization, activation, padding,
                                pooling)
        self.cnn = nn.Sequential(
            ArchCNN(arch, normalization, activation, padding, pooling),
            GlobalAvgPool(), nn.Linear(cnn_dim, 1024))
        self.real_classifier = nn.Linear(1024, 1)
        self.obj_classifier = nn.Linear(1024,
                                        len(vocab["object_idx_to_name"]))

    def forward(self, x, sample_mask=None):
        """x (B, 3, h, w) crops; ``sample_mask`` (B,) keeps padded crops out
        of the train-mode BatchNorm statistics -> (real scores (B, 1),
        object logits (B, num_objects))."""
        vecs = self.cnn[2](self.cnn[1](self.cnn[0](x, sample_mask)))
        return self.real_classifier(vecs), self.obj_classifier(vecs)


class AcCropDiscriminator(nn.Module):
    """Crops every object's box out of its image and scores the crops with
    an :class:`AcDiscriminator` (upstream ``discriminators.py:78-90``), over
    padded batches."""

    def __init__(self, vocab, arch: str, normalization: str = "none",
                 activation: str = "relu", object_size: int = 64,
                 padding: str = "same", pooling: str = "avg"):
        super().__init__()
        self.object_size = object_size
        self.discriminator = AcDiscriminator(vocab, arch, normalization,
                                             activation, padding, pooling)

    def forward(self, imgs, boxes, obj_mask=None):
        """imgs (N, 3, H, W), boxes (N, O, 4), obj_mask (N, O) -> (real
        scores (N, O, 1), object logits (N, O, num_objects)); padded slots
        are for the loss to mask."""
        N, O = boxes.shape[:2]
        crops = crop_bbox_padded(imgs, boxes, self.object_size)
        crops = crops.reshape((N * O,) + crops.shape[2:])
        flat_mask = None if obj_mask is None else obj_mask.reshape(N * O)
        real, logits = self.discriminator(crops, sample_mask=flat_mask)
        return real.reshape(N, O, -1), logits.reshape(N, O, -1)
