"""Layers shared by the generator: activations, norms, MLP, resampling.

Counterparts of ``sg2im_tpu/nn/layers.py``, in PyTorch idiom: NCHW
tensors, ``nn.Sequential`` stacks whose integer indices are the upstream
parameter names (``box_net.0.weight``, ...), so reference-layout state dicts
load without a converter.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sg2im_tpu_torch.ops import resample
from sg2im_tpu_torch.parallel import collectives


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
    """BatchNorm with torch's semantics, as the JAX package's ``_BNCore``
    has them: eps 1e-5, momentum 0.1.  Channels are dim 1 of a 4-D (NCHW)
    input and the last dim otherwise (the MLPs' (..., C) rows).

    Eval mode: ``(x - running_mean) / sqrt(running_var + eps) * weight +
    bias``.  Train mode: the mean and biased variance of the batch
    normalise x, and the running statistics move by 0.1 towards the mean
    and the unbiased variance, written into the buffers during the call.
    ``mask`` (the leading axes of x: (N,) for NCHW, (N, T) for rows)
    weights each sample's share of the statistics, so padded slots stay out
    of them: n = max(sum(mask) * spatial, 1).  Inside
    ``parallel.collectives.global_batch(group)`` the statistics are those
    of the global batch, over every rank of the group.

    State: ``weight``, ``bias``, ``running_mean``, ``running_var``, the
    upstream names; a ``num_batches_tracked`` entry in a loaded state dict
    is accepted and dropped."""

    eps = 1e-5
    momentum = 0.1
    takes_mask = True  # see run_masked

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, phases: int = 1, mask=None):
        """``phases`` > 1: x is packed (N, phases * C, R, Rw), channel
        p * C + c being phase p of channel c, and every phase of channel c
        takes channel c's statistics and affine parameters (in train mode
        the phases are positions of the reduction)."""
        if self.training:
            return self._train_forward(x, phases, mask)
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

    def _train_forward(self, x, phases, mask):
        C = self.weight.shape[0]
        if x.ndim == 4:
            N, _, H, W = x.shape
            xs = x.reshape(N, phases, C, H, W)
            dims, cshape = (0, 1, 3, 4), (1, 1, C, 1, 1)
        else:
            xs, dims, cshape = x, tuple(range(x.ndim - 1)), (C,)
        if collectives.group() is not None:
            mean, var, n = _global_moments(xs, dims, cshape, mask, C)
            bessel = n / (n - 1.0).clamp_min(1.0)
        elif mask is None:
            var, mean = torch.var_mean(xs, dim=dims, correction=0,
                                       keepdim=True)
            n = xs.numel() // C
            bessel = n / max(n - 1, 1)
        else:
            w = mask.to(x.dtype).reshape(
                mask.shape + (1,) * (xs.ndim - mask.ndim))
            spatial = math.prod(xs.shape[mask.ndim:]) // C
            n = (mask.to(x.dtype).sum() * spatial).clamp_min(1.0)
            mean = (xs * w).sum(dim=dims, keepdim=True) / n
            var = (((xs - mean) ** 2) * w).sum(dim=dims, keepdim=True) / n
            bessel = n / (n - 1.0).clamp_min(1.0)
        with torch.no_grad():
            unbiased = var.reshape(C) * bessel
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean
                                    + m * mean.reshape(C))
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        y = (xs - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.reshape(cshape) + self.bias.reshape(cshape)
        return y.reshape(x.shape)


def _global_moments(xs, dims, cshape, mask, C):
    """Mean, biased variance and count of ``xs`` over ``dims`` and over
    every rank of the data-parallel group (``parallel.collectives``): the
    global count and sum in one all-reduce, then the global sum of squared
    deviations from the global mean in a second, two-pass as the one-rank
    statistics are.  Both sums carry gradients back across the ranks."""
    if mask is None:
        w = None
        s = xs.sum(dim=dims)
        n = torch.full((1,), float(xs.numel() // C), dtype=xs.dtype,
                       device=xs.device)
    else:
        w = mask.to(xs.dtype).reshape(
            mask.shape + (1,) * (xs.ndim - mask.ndim))
        spatial = math.prod(xs.shape[mask.ndim:]) // C
        s = (xs * w).sum(dim=dims)
        n = (mask.to(xs.dtype).sum() * spatial).reshape(1)
    tot = collectives.global_sum(torch.cat([s.reshape(C), n]))
    n = tot[C].clamp_min(1.0)
    mean = (tot[:C] / n).reshape(cshape)
    d = (xs - mean) ** 2
    if w is not None:
        d = d * w
    var = collectives.global_sum(d.sum(dim=dims)).reshape(cshape) / n
    return mean, var, n


def run_masked(layers, x, mask=None):
    """Apply ``layers`` in order, handing ``mask`` (which samples count) to
    the ones whose train-mode statistics take it (``takes_mask``)."""
    for layer in layers:
        x = (layer(x, mask=mask) if getattr(layer, "takes_mask", False)
             else layer(x))
    return x


class MLPSpec(NamedTuple):
    """One layer of an MLP: 'linear', 'bn', 'act' or 'dropout', at its
    upstream Sequential index."""
    kind: str
    torch_idx: int
    din: int = 0
    dout: int = 0


def parse_mlp(dim_list: Sequence[int], activation: str = "relu",
              batch_norm: str = "none", dropout: float = 0.0,
              final_nonlinearity: bool = True) -> list[MLPSpec]:
    """The layers and Sequential indices of upstream ``build_mlp``
    (``sg2im/layers.py:216-232``): per step a Linear, then, unless it is
    the last step without ``final_nonlinearity``, a BatchNorm when
    ``batch_norm == 'batch'`` and the activation when it is 'relu' or
    'leakyrelu' (other names add none), then a Dropout when ``dropout >
    0``."""
    specs: list[MLPSpec] = []
    idx = 0
    for i in range(len(dim_list) - 1):
        din, dout = dim_list[i], dim_list[i + 1]
        specs.append(MLPSpec("linear", idx, din, dout))
        idx += 1
        if i < len(dim_list) - 2 or final_nonlinearity:
            if batch_norm == "batch":
                specs.append(MLPSpec("bn", idx, dout, dout))
                idx += 1
            if activation in ("relu", "leakyrelu"):
                specs.append(MLPSpec("act", idx))
                idx += 1
        if dropout > 0:
            specs.append(MLPSpec("dropout", idx))
            idx += 1
    return specs


class MLP(nn.Sequential):
    """Upstream ``build_mlp`` at the Sequential indices of
    :func:`parse_mlp`.  ``activation`` 'relu' is a true ReLU and
    'leakyrelu' slope 0.01 (``build_mlp`` checks its own strings, unlike
    :func:`parse_activation`); the generator's MLPs take the defaults, so
    the final layer ends in a ReLU too, which is why the box head's
    outputs are non-negative.  ``dropout`` acts in train mode only.

    ``kernel_init``: 'torch_linear' (nn.Linear's default) or
    'kaiming_normal' (the GCN's), applied by :func:`init_weights`."""

    def __init__(self, dim_list: Sequence[int], activation: str = "relu",
                 batch_norm: str = "none", dropout: float = 0.0,
                 final_nonlinearity: bool = True,
                 kernel_init: str = "torch_linear"):
        layers = []
        for spec in parse_mlp(dim_list, activation, batch_norm, dropout,
                              final_nonlinearity):
            if spec.kind == "linear":
                layer = nn.Linear(spec.din, spec.dout)
                layer.kernel_init = kernel_init
            elif spec.kind == "bn":
                layer = BatchNorm(spec.dout)
            elif spec.kind == "act":
                layer = nn.ReLU() if activation == "relu" else nn.LeakyReLU()
            else:
                layer = nn.Dropout(dropout)
            layers.append(layer)
        super().__init__(*layers)

    def forward(self, x, mask=None):
        """``mask``: validity of x's leading axes, for train-mode
        BatchNorm statistics."""
        return run_masked(self, x, mask)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW by an integer factor.

    A factor of 2 takes the resampling kernel where
    ``ops/resample.takes_kernel`` says so (on the card, bf16 or float32,
    whole 16-byte vectors of channels, no gradient recorded).  Integer
    tensors (the int8 turbo tier) go by index expansion, which
    ``F.interpolate`` does not implement for them; the result is
    channels_last, as the int8 conv kernel reads it."""
    if x.is_floating_point():
        if factor != 2:
            return F.interpolate(x, scale_factor=factor, mode="nearest")
        return (resample.upsample2(x) if resample.takes_kernel(x)
                else resample.upsample2_ref(x))
    N, C, H, W = x.shape
    nhwc = x.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    up = nhwc.expand(N, H, factor, W, factor, C).reshape(
        N, H * factor, W * factor, C)
    return up.permute(0, 3, 1, 2)


def avg_pool_2d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average pool with kernel = stride = factor, NCHW."""
    return F.avg_pool2d(x, factor)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) -> (N, C): the mean over every axis after the channels
    (upstream ``GlobalAvgPool``)."""
    return x.mean(dim=tuple(range(2, x.ndim)))


class GlobalAvgPool(nn.Module):
    def forward(self, x):
        return global_avg_pool(x)


# ---------------------------------------------------------------------------
# Arch-string CNN (upstream build_cnn), as the discriminators use it.
# ---------------------------------------------------------------------------

class ArchSpec(NamedTuple):
    # 'conv' | 'norm' | 'act' | 'pool' | 'upsample' | 'flatten' | 'fc' | 'res'
    kind: str
    torch_idx: int
    in_ch: int = 0
    out_ch: int = 0
    kernel: int = 0
    stride: int = 1
    pad: int = 0
    factor: int = 0
    norm_kind: str = "none"   # for 'norm' and 'res'; the pooling for 'pool'


def _get_padding(K: int, mode: str) -> int:
    if mode == "valid":
        return 0
    if mode == "same" and K % 2 == 0:
        raise ValueError(f"kernel {K} cannot take 'same' padding")
    return (K - 1) // 2


def parse_arch(arch, normalization: str = "batch", activation: str = "relu",
               padding: str = "same", pooling: str = "max"):
    """Parse upstream's CNN arch strings with upstream's Sequential indices.

    ``IX`` input channels, ``CK-X[-S]`` conv, ``R`` residual block, ``UX``
    upsample, ``PX`` pool, ``FC-X-Y`` flatten + linear.  A norm and an
    activation precede every conv but the first; 'none' norms take no
    index, instance norms take one and hold no parameters.

    Returns (specs, out_channels)."""
    if isinstance(arch, str):
        arch = arch.split(",")
    arch = list(arch)
    cur_c = 3
    if arch and arch[0][0] == "I":
        cur_c = int(arch[0][1:])
        arch = arch[1:]
    specs: list[ArchSpec] = []
    idx = 0
    first_conv = True
    flat = False
    for i, s in enumerate(arch):
        if s[0] == "C":
            if not first_conv:
                if normalization != "none":
                    specs.append(ArchSpec("norm", idx, cur_c, cur_c,
                                          norm_kind=normalization))
                    idx += 1
                specs.append(ArchSpec("act", idx))
                idx += 1
            first_conv = False
            vals = [int(v) for v in s[1:].split("-")]
            K, next_c = vals[0], vals[1]
            stride = vals[2] if len(vals) == 3 else 1
            specs.append(ArchSpec("conv", idx, cur_c, next_c, kernel=K,
                                  stride=stride, pad=_get_padding(K, padding)))
            idx += 1
            cur_c = next_c
        elif s[0] == "R":
            norm = "none" if first_conv else normalization
            specs.append(ArchSpec("res", idx, cur_c, cur_c, kernel=3,
                                  pad=_get_padding(3, padding),
                                  norm_kind=norm))
            idx += 1
            first_conv = False
        elif s[0] == "U":
            specs.append(ArchSpec("upsample", idx, factor=int(s[1:])))
            idx += 1
        elif s[0] == "P":
            specs.append(ArchSpec("pool", idx, factor=int(s[1:]),
                                  norm_kind=pooling))
            idx += 1
        elif s[:2] == "FC":
            _, din, dout = s.split("-")
            if not flat:
                specs.append(ArchSpec("flatten", idx))
                idx += 1
            flat = True
            specs.append(ArchSpec("fc", idx, int(din), int(dout)))
            idx += 1
            if i + 1 < len(arch):
                specs.append(ArchSpec("act", idx))
                idx += 1
            cur_c = int(dout)
        else:
            raise ValueError(f'Invalid layer "{s}"')
    return specs, cur_c


def _norm_layer(kind: str, channels: int):
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return None
    raise ValueError(f'Invalid normalization "{kind}"')


class ResidualBlock(nn.Module):
    """[norm, activation, 3x3 conv] twice plus the identity (upstream
    ``ResidualBlock``, its layers in ``net`` at upstream's indices), with
    the JAX package's fixes of its two bugs: the shortcut is cropped when
    the padding is 'valid', and the body runs once."""

    takes_mask = True

    def __init__(self, channels: int, normalization: str = "batch",
                 activation: str = "relu", pad: int = 1,
                 init: str = "default"):
        super().__init__()
        act = activation_module(parse_activation(activation))
        layers = []
        for _ in range(2):
            conv = nn.Conv2d(channels, channels, 3, padding=pad)
            if init == "kaiming-normal":
                conv.kernel_init = "kaiming_normal"
            layers += [_norm_layer(normalization, channels), act, conv]
        self.pad = pad
        self.net = nn.Sequential(*(m for m in layers if m is not None))

    def forward(self, x, mask=None):
        shortcut = x if self.pad else x[:, :, 2:-2, 2:-2]
        return shortcut + run_masked(self.net, x, mask)


class ArchCNN(nn.Sequential):
    """The CNN of an upstream arch string, its layers at upstream's
    Sequential indices (``cnn.{i}.weight``).  ``forward(x, sample_mask)``
    hands ``sample_mask`` ((N,), which samples count) to the train-mode
    BatchNorm statistics.  'FC' flattens in NHWC order, as the JAX package
    does."""

    def __init__(self, arch, normalization: str = "batch",
                 activation: str = "relu", padding: str = "same",
                 pooling: str = "max", init: str = "default"):
        specs, self.out_channels = parse_arch(arch, normalization, activation,
                                              padding, pooling)
        act = parse_activation(activation)
        layers = []
        for spec in specs:
            if spec.kind == "conv":
                layer = nn.Conv2d(spec.in_ch, spec.out_ch, spec.kernel,
                                  stride=spec.stride, padding=spec.pad)
                if init == "kaiming-normal":
                    layer.kernel_init = "kaiming_normal"
            elif spec.kind == "norm":
                layer = _norm_layer(spec.norm_kind, spec.out_ch)
            elif spec.kind == "act":
                layer = activation_module(act)
            elif spec.kind == "pool":
                pool = (nn.MaxPool2d if spec.norm_kind == "max"
                        else nn.AvgPool2d)
                layer = pool(spec.factor)
            elif spec.kind == "upsample":
                layer = nn.Upsample(scale_factor=spec.factor, mode="nearest")
            elif spec.kind == "flatten":
                layer = _FlattenNHWC()
            elif spec.kind == "fc":
                layer = nn.Linear(spec.in_ch, spec.out_ch)
            else:
                layer = ResidualBlock(spec.in_ch, spec.norm_kind, activation,
                                      pad=spec.pad, init=init)
            layers.append(layer)
        super().__init__(*layers)

    def forward(self, x, sample_mask=None):
        return run_masked(self, x, sample_mask)


class _FlattenNHWC(nn.Module):
    def forward(self, x):
        return x.permute(0, 2, 3, 1).flatten(1) if x.ndim == 4 else x


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
