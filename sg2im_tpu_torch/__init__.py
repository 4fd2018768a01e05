"""sg2im_tpu_torch: the PyTorch / CUDA port of sg2im-tpu for NVIDIA Hopper.

Scene graph -> image generation (Johnson, Gupta & Fei-Fei, "Image
Generation from Scene Graphs", CVPR 2018), beside the JAX package
``sg2im_tpu``, which stays the reference it is tested against.  Plain
tensor code is PyTorch; the kernels the JAX package wrote in Pallas for the
TPU are CUDA kernels written for sm_90a, built with nvcc at first use: the
layout compose (``csrc/layout_compose.cu``), the 3x3 conv
(``csrc/conv3x3.cu``), whose int8 entry carries the int8 turbo serving
tier, and the space-to-depth / depth-to-space relayout of the CRN's
'packed' and 'phase' modes (``csrc/relayout.cu``).  ``train/`` is the
GAN training step and its Trainer, with gradients through those kernels;
``cli/train.py`` trains on COCO or Visual Genome through ``data/`` (the
datasets, loader and prefetch to the card) and ``native/`` (the host's C
RLE codec and image decoder).  The package imports neither JAX nor the
JAX package.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (a bare ``import sg2im_tpu_torch`` stays light)."""
    if name == "InferenceEngine":
        from sg2im_tpu_torch.inference import InferenceEngine

        return InferenceEngine
    if name == "Trainer":
        from sg2im_tpu_torch.train.trainer import Trainer

        return Trainer
    if name == "TrainConfig":
        from sg2im_tpu_torch.train.config import TrainConfig

        return TrainConfig
    if name == "Sg2ImGenerator":
        from sg2im_tpu_torch.models import Sg2ImGenerator

        return Sg2ImGenerator
    raise AttributeError(f"module 'sg2im_tpu_torch' has no attribute '{name}'")
