"""The sg2im generator and the GAN discriminators."""

from sg2im_tpu_torch.models.discriminators import (
    AcCropDiscriminator,
    AcDiscriminator,
    PatchDiscriminator,
)
from sg2im_tpu_torch.models.sg2im import MaskNet, Sg2ImGenerator

__all__ = ["AcCropDiscriminator", "AcDiscriminator", "MaskNet",
           "PatchDiscriminator", "Sg2ImGenerator"]
