"""Layers shared by the generator: activations, norms, MLP, resampling.

Counterparts of ``sg2im_tpu/nn/layers.py``, in PyTorch idiom: NCHW
tensors, ``nn.Sequential`` stacks whose integer indices are the upstream
parameter names (``box_net.0.weight``, ...), so reference-layout state dicts
load without a converter.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def parse_activation(name: str) -> tuple[str, float]:
    """Activation of the CNN/CRN paths, parsed as upstream's
    ``get_activation`` does, quirk included: every name becomes
    'leakyrelu', so 'relu' gives LeakyReLU(0.01).  'leakyrelu-<slope>'
    sets the slope.  ``MLP`` does its own string checks and keeps a true
    ReLU."""
    slope = 0.01
    if name.lower().startswith("leakyrelu") and "-" in name:
        slope = float(name.split("-")[1])
    return ("leakyrelu", slope)


def apply_activation(spec: tuple[str, float], x: torch.Tensor) -> torch.Tensor:
    """Apply a :func:`parse_activation` result (always a leaky ReLU)."""
    return F.leaky_relu(x, negative_slope=spec[1])


def activation_module(spec: tuple[str, float]) -> nn.Module:
    return nn.LeakyReLU(spec[1])


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch-0.4 InstanceNorm2d defaults (no affine, no running stats) on
    NCHW: biased variance over each sample's H x W."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    """Parameterless module form of :func:`instance_norm_2d`."""

    def forward(self, x):
        return instance_norm_2d(x)


class BatchNorm(nn.Module):
    """BatchNorm with torch's eval semantics: ``(x - running_mean) /
    sqrt(running_var + 1e-5) * weight + bias``.  Channels are dim 1 of a
    4-D (NCHW) input and the last dim otherwise (the MLPs' (..., C) rows).

    State: ``weight``, ``bias``, ``running_mean``, ``running_var``, the
    upstream names; a ``num_batches_tracked`` entry in a loaded state dict
    is accepted and dropped.  Only eval mode is ported: train-mode batch
    statistics come with the training port (ROADMAP Queue 1)."""

    eps = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, phases: int = 1):
        """``phases`` > 1: x is packed (N, phases * C, R, Rw), channel
        p * C + c being phase p of channel c, and every phase of channel c
        takes channel c's statistics and affine parameters."""
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm comes with the training port (ROADMAP "
                "Queue 1); call .eval() for inference")
        if x.ndim == 4:
            stats = (self.running_mean, self.running_var, self.weight,
                     self.bias)
            if phases > 1:
                stats = tuple(t.repeat(phases) for t in stats)
            return F.batch_norm(x, *stats, False, 0.0, self.eps)
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), self.running_mean,
                         self.running_var, self.weight, self.bias, False,
                         0.0, self.eps)
        return y.reshape(shape)


class MLP(nn.Sequential):
    """Linear (+ BatchNorm) + ReLU stack of upstream ``build_mlp`` as the
    generator uses it: the activation is a true ReLU (``build_mlp`` checks
    its own strings, unlike :func:`parse_activation`) and the final layer
    ends in it too (``final_nonlinearity=True``), which is why the box
    head's outputs are non-negative.  Sequential indices are upstream's:
    Linear at 0, BatchNorm at 1 if any, ReLU next, and so on.

    ``kernel_init``: 'torch_linear' (nn.Linear's default) or
    'kaiming_normal' (the GCN's), applied by :func:`init_weights`."""

    def __init__(self, dim_list: Sequence[int], batch_norm: str = "none",
                 kernel_init: str = "torch_linear"):
        layers = []
        for din, dout in zip(dim_list[:-1], dim_list[1:]):
            linear = nn.Linear(din, dout)
            linear.kernel_init = kernel_init
            layers.append(linear)
            if batch_norm == "batch":
                layers.append(BatchNorm(dout))
            layers.append(nn.ReLU())
        super().__init__(*layers)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW by an integer factor.

    Integer tensors (the int8 turbo tier) go by index expansion, which
    ``F.interpolate`` does not implement for them; the result is
    channels_last, as the int8 conv kernel reads it."""
    if x.is_floating_point():
        return F.interpolate(x, scale_factor=factor, mode="nearest")
    N, C, H, W = x.shape
    nhwc = x.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    up = nhwc.expand(N, H, factor, W, factor, C).reshape(
        N, H * factor, W * factor, C)
    return up.permute(0, 3, 1, 2)


def avg_pool_2d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average pool with kernel = stride = factor, NCHW."""
    return F.avg_pool2d(x, factor)


# ---------------------------------------------------------------------------
# Seeded initialisation.
# ---------------------------------------------------------------------------

def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every parameter of ``module`` from ``generator``, with
    upstream's distributions: Linear and Conv2d weights (and any module
    with a ``kernel_init`` attribute) by that attribute ('torch_linear':
    U(+-1/sqrt(fan_in)), the torch default; 'kaiming_normal':
    N(0, 2/fan_in)), biases U(+-1/sqrt(fan_in)), embeddings N(0, 1), norms
    to the identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)) or \
                    hasattr(m, "kernel_init"):
                bound = m.weight[0].numel() ** -0.5  # 1 / sqrt(fan_in)
                if getattr(m, "kernel_init", None) == "kaiming_normal":
                    nn.init.kaiming_normal_(m.weight, generator=generator)
                else:
                    nn.init.uniform_(m.weight, -bound, bound,
                                     generator=generator)
                if m.bias is not None:
                    nn.init.uniform_(m.bias, -bound, bound,
                                     generator=generator)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, generator=generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
