"""Generator layers: norms, MLPs, graph convolution, CRN (counterpart of
``sg2im_tpu/nn/``, with the same names)."""

from sg2im_tpu_torch.nn.crn import RefinementModule, RefinementNetwork
from sg2im_tpu_torch.nn.graph import (
    GraphTripleConv,
    GraphTripleConvNet,
    pool_messages,
)
from sg2im_tpu_torch.nn.layers import (
    MLP,
    ArchCNN,
    BatchNorm,
    apply_activation,
    avg_pool_2d,
    global_avg_pool,
    instance_norm_2d,
    parse_activation,
    parse_arch,
    parse_mlp,
    upsample_nearest,
)

__all__ = [
    "MLP",
    "ArchCNN",
    "BatchNorm",
    "GraphTripleConv",
    "GraphTripleConvNet",
    "RefinementModule",
    "RefinementNetwork",
    "apply_activation",
    "avg_pool_2d",
    "global_avg_pool",
    "instance_norm_2d",
    "parse_activation",
    "parse_arch",
    "parse_mlp",
    "pool_messages",
    "upsample_nearest",
]
