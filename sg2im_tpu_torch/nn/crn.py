"""Cascaded Refinement Network (Chen & Koltun, ICCV 2017), NCHW.

Counterpart of ``sg2im_tpu/nn/crn.py`` in its 'legacy' and 'split' conv0
modes.  Each stage nearest-2x upsamples its features, meets the layout
average-pooled to its resolution, and applies two conv-norm-act blocks;
the features start as zeros of one channel at H / 2^stages.  Parameters
keep the upstream names: ``refinement_modules.{k}.net.{i}`` (convs at 0 and
3, norms at 1 and 4 with normalization) and ``output_conv.{0,2}``.

``compute_dtype=torch.bfloat16`` runs the convolutions and the tensors
between them in bf16 while norm and activation run in f32, as the JAX
package does; the layout pyramid is kept in the compute dtype.

``quant='int8'`` is the turbo serving tier (the JAX package's
``crn_quant``): the stages whose layout resolution lies in [quant_min_res,
quant_max_res] run their feats-branch and second convolutions as int8 x
int8 with exact int32 sums (``ops/conv_kernel.conv3x3_int8``, the Hopper
kernel for CUDA tensors), weights quantized per output channel from the
f32 parameters at each call, activations per tensor at calibrated scales.
The stages are int8-resident: a quantized epilogue writes int8 and the
next quantized conv reads it.  The scales live in ``act_scales``, outside
the state dict, keyed by the JAX package's tag paths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sg2im_tpu_torch.nn.layers import (
    BatchNorm,
    InstanceNorm,
    activation_module,
    apply_activation,
    avg_pool_2d,
    parse_activation,
    upsample_nearest,
)
from sg2im_tpu_torch.ops.conv_kernel import conv3x3_int8

CONV0_MODES = ("legacy", "split")
_UNPORTED_MODES = ("phase", "packed", "split_noise")


def check_conv0_mode(mode: str) -> None:
    if mode in _UNPORTED_MODES:
        raise NotImplementedError(
            f"CRN mode {mode!r} is not ported: ROADMAP Queue 1 item 14 "
            "(retired modes) decides whether it comes")
    if mode not in CONV0_MODES:
        raise ValueError(f"unknown CRN mode {mode!r}; one of {CONV0_MODES}")


def _conv3x3(x, weight, bias=None):
    return F.conv2d(x, weight, bias, padding=1)


# ---------------------------------------------------------------------------
# The int8 turbo tier: symmetric quantization, per-output-channel weight
# scales, calibrated per-tensor activation scales, int32 sums, f32 dequant.
# ---------------------------------------------------------------------------

def _div127(t):
    # Divide by a tensor on t's device: a CUDA tensor divided by a Python
    # scalar may be multiplied by the reciprocal instead, one ulp away
    # from the JAX package's division.
    return t / torch.full((), 127.0, dtype=torch.float32, device=t.device)


def _quant_weight_int8(weight):
    """f32 (co, cin, 3, 3) -> (int8 weight, f32 per-channel scale (co,))."""
    kf = weight.float()
    sw = _div127(kf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-30))
    kq = torch.round(kf / sw[:, None, None, None]).clamp(-127, 127)
    return kq.to(torch.int8), sw


def _quant_act(x, s):
    """x / s rounded half to even, clipped to +-127, as int8."""
    return torch.round(x.float() / s).clamp(-127, 127).to(torch.int8)


def _conv_int8(xq, weight, s_x):
    """int8 conv of an input already quantized at per-tensor scale ``s_x``;
    returns f32 without bias: f32(int32 sum) * (s_x * sw)."""
    kq, sw = _quant_weight_int8(weight)
    return conv3x3_int8(xq, kq, s_x * sw)


class ActScales:
    """The turbo tier's calibrated activation scales: {tag: 0-dim float32
    tensor}, tags being the JAX package's flattened 'quant' collection
    paths (``refinement_net/refinement_modules_2/act_mid``).

    ``values`` is None until calibrated.  With ``calibrating`` set, each
    call records a running max of max|x| / 127 under its tag and returns
    the fresh batch value; otherwise it returns the stored value.  Both
    are floored at 1e-30 when used."""

    def __init__(self):
        self.values = None
        self.calibrating = False

    def __call__(self, tag: str, x):
        if self.calibrating:
            cur = _div127(x.float().abs().amax())
            prev = self.values.get(tag)
            self.values[tag] = cur if prev is None else torch.maximum(prev,
                                                                      cur)
            return cur.clamp_min(1e-30)
        if self.values is None or tag not in self.values:
            raise RuntimeError(f"int8 activation scale {tag!r} is not "
                               "calibrated")
        return self.values[tag].clamp_min(1e-30)


class QuantConv3x3(nn.Conv2d):
    """A 3x3 'same' Conv2d (same ``weight`` and ``bias``) that can also run
    on the int8 path: ``forward(x, dtype=...)`` is the plain conv in
    ``dtype``; ``forward(xq, s_in=s)`` takes int8 ``xq`` at per-tensor
    scale ``s`` and returns ``_conv_int8(xq, weight, s) + bias`` in f32."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__(input_dim, output_dim, 3, padding=1)
        self.kernel_init = "kaiming_normal"
        nn.init.kaiming_normal_(self.weight)

    def forward(self, x, s_in=None, dtype=None):
        if s_in is not None:
            return (_conv_int8(x, self.weight, s_in)
                    + self.bias[:, None, None])
        dtype = dtype or x.dtype
        return _conv3x3(x, self.weight.to(dtype), self.bias.to(dtype))


class FusedUpsampleConv(nn.Module):
    """``conv3x3(concat(layout, upsample2(feats)))`` with the parameters of
    the one Conv2d it stands for: ``weight`` (co, layout_dim + feats_dim, 3,
    3) and ``bias``.

    mode 'legacy' builds the concat and runs one conv; 'split' runs
    conv(layout, W[:, :layout_dim]) + conv(up, W[:, layout_dim:]), exact up
    to the order of the sums, so the wide concat is never stored.  A stage
    whose feats already match the layout resolution takes the concat in
    both modes.
    """

    def __init__(self, layout_dim: int, feats_dim: int, output_dim: int,
                 mode: str = "legacy"):
        super().__init__()
        check_conv0_mode(mode)
        self.layout_dim = layout_dim
        self.mode = mode
        self.weight = nn.Parameter(
            torch.empty(output_dim, layout_dim + feats_dim, 3, 3))
        self.bias = nn.Parameter(torch.zeros(output_dim))
        self.kernel_init = "kaiming_normal"
        nn.init.kaiming_normal_(self.weight)

    def forward(self, layout, feats, dtype, act_scales=None, tag="",
                feats_scale=None):
        """With ``act_scales`` (a quantized stage) the feats branch runs
        int8: ``feats`` arrives int8 at ``feats_scale`` from the previous
        stage, or is quantized here at the coarse resolution under
        ``<tag>/act_up``; the layout branch stays a ``dtype`` conv and the
        bias f32.  Both modes compute the branches apart then."""
        w = self.weight.to(dtype)
        b = self.bias.to(dtype)
        layout = layout.to(dtype)
        Dl = self.layout_dim
        same_res = feats.shape[2] == layout.shape[2]
        if act_scales is None:
            feats = feats.to(dtype)
        else:
            if feats_scale is None and not same_res:
                feats_scale = act_scales(f"{tag}/act_up", feats)
                feats = _quant_act(feats, feats_scale)
            if not same_res:
                up = upsample_nearest(feats, 2)
                out = _conv_int8(up, self.weight[:, Dl:], feats_scale)
                return (out + _conv3x3(layout, w[:, :Dl])
                        + self.bias[:, None, None])
            # Equal resolution: dequantize and take the concat conv.
            if feats_scale is not None:
                feats = feats.float() * feats_scale
            feats = feats.to(dtype)
        if same_res:
            return _conv3x3(torch.cat([layout, feats], 1), w, b)
        up = upsample_nearest(feats, 2)
        if self.mode == "legacy":
            return _conv3x3(torch.cat([layout, up], 1), w, b)
        return _conv3x3(layout, w[:, :Dl]) + _conv3x3(up, w[:, Dl:], b)


def _norm_module(normalization: str, dim: int):
    if normalization == "batch":
        return BatchNorm(dim)
    if normalization == "instance":
        return InstanceNorm()
    if normalization == "none":
        return None
    raise ValueError(f'Invalid normalization "{normalization}"')


class RefinementModule(nn.Module):
    """One CRN stage (upstream ``crn.py:35-65``).  ``net`` holds the layers
    at their upstream Sequential indices; forward drives them itself
    because conv0 takes the layout and the half-resolution feats
    separately."""

    def __init__(self, layout_dim: int, input_dim: int, output_dim: int,
                 normalization: str = "instance",
                 activation: str = "leakyrelu", conv0_mode: str = "legacy"):
        super().__init__()
        self.normalization = normalization
        self.act = parse_activation(activation)
        conv1 = QuantConv3x3(output_dim, output_dim)
        layers = [FusedUpsampleConv(layout_dim, input_dim, output_dim,
                                    conv0_mode),
                  _norm_module(normalization, output_dim),
                  activation_module(self.act),
                  conv1,
                  _norm_module(normalization, output_dim),
                  activation_module(self.act)]
        self.net = nn.Sequential(*(m for m in layers if m is not None))

    def forward(self, layout, feats, compute_dtype=None, act_scales=None,
                tag="", emit_q=False, feats_scale=None):
        """layout (N, Dl, HH, WW); feats (N, C, H, W) at half the stage's
        resolution (or at it) -> (N, output_dim, 2H, 2W).

        With ``act_scales`` the stage is quantized (int8 turbo tier): the
        conv0 epilogue writes int8 at ``<tag>/act_mid`` for conv1, and
        with ``emit_q`` the stage returns (int8 output, scale) at
        ``<tag>/act_out`` for a quantized consumer.  ``feats_scale`` marks
        ``feats`` as int8 handed over by the previous stage."""
        HH = layout.shape[2]
        H = feats.shape[2]
        target = 2 * H if 2 * H <= HH else H
        if HH > target:
            layout = avg_pool_2d(layout, HH // target)
        dtype = compute_dtype or layout.dtype
        has_norm = self.normalization != "none"
        conv0, conv1 = self.net[0], self.net[3 if has_norm else 2]
        norms = ((self.net[1], self.net[4]) if has_norm else (None, None))
        x = conv0(layout, feats, dtype, act_scales, f"{tag}/layer0",
                  feats_scale)
        for k, norm in enumerate(norms):
            if k == 1:
                x = (conv1(x, dtype=dtype) if act_scales is None
                     else conv1(x, s_in=s_mid))
            if compute_dtype is not None:
                x = x.float()  # norm and activation run in f32
            if norm is not None:
                x = norm(x)
            x = apply_activation(self.act, x)
            if act_scales is not None and k == 0:
                s_mid = act_scales(f"{tag}/act_mid", x)
                x = _quant_act(x, s_mid)
            elif act_scales is not None and emit_q:
                s_out = act_scales(f"{tag}/act_out", x)
                return _quant_act(x, s_out), s_out
            elif compute_dtype is not None:
                x = x.to(compute_dtype)
        return x


class RefinementNetwork(nn.Module):
    """The full CRN (upstream ``crn.py:68-111``).  ``dims[0]`` is the layout
    channel count and ``dims[1:]`` the stage widths; the head is conv3x3 +
    activation + conv1x1 to RGB.

    ``quant='int8'``: the stages whose layout level has a resolution in
    [quant_min_res, quant_max_res] are quantized; a stage whose consumer
    is quantized too (the next stage, or the head's 3x3 conv when
    ``quant_head``) hands its output over as int8.  The scale tags in
    ``act_scales`` carry the generator's prefix, ``refinement_net``."""

    SCALE_PREFIX = "refinement_net"

    def __init__(self, dims, normalization: str = "instance",
                 activation: str = "leakyrelu", conv0_mode: str = "legacy",
                 quant=None, quant_min_res: int = 32,
                 quant_max_res: int = 1 << 30, quant_head: bool = True):
        super().__init__()
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quantization tier {quant!r}")
        self.dims = tuple(dims)
        self.act = parse_activation(activation)
        self.quant = quant
        self.quant_min_res = quant_min_res
        self.quant_max_res = quant_max_res
        self.quant_head = quant_head
        self.act_scales = ActScales()
        layout_dim = self.dims[0]
        self.refinement_modules = nn.ModuleList(
            RefinementModule(layout_dim, 1 if i == 1 else self.dims[i - 1],
                             self.dims[i], normalization, activation,
                             conv0_mode)
            for i in range(1, len(self.dims)))
        head = [QuantConv3x3(self.dims[-1], self.dims[-1]),
                activation_module(self.act),
                nn.Conv2d(self.dims[-1], 3, 1)]
        head[2].kernel_init = "kaiming_normal"
        nn.init.kaiming_normal_(head[2].weight)
        self.output_conv = nn.Sequential(*head)

    def quant_plan(self, H: int) -> list[tuple[bool, bool, bool]]:
        """Per stage, for an H-row layout: (quantized, emits int8, quantizes
        its incoming feats under act_up).  The forward follows it, and the
        calibration tags derive from it."""
        n_mods = len(self.refinement_modules)
        levels = [H]
        for _ in range(n_mods - 1):
            levels.append(levels[-1] // 2)  # avg_pool_2d floors
        levels = levels[::-1]
        q = [self.quant == "int8"
             and self.quant_min_res <= lv <= self.quant_max_res
             for lv in levels]
        plan, h, handed_over = [], H >> n_mods, False
        for i, lv in enumerate(levels):
            target = 2 * h if 2 * h <= lv else h
            emit = q[i] and (q[i + 1] if i + 1 < n_mods else self.quant_head)
            plan.append((q[i], emit, q[i] and not handed_over and target != h))
            h, handed_over = target, emit
        return plan

    def quant_tags(self, H: int) -> list[str]:
        """The scale tags a calibration pass records for an H-row layout."""
        tags = []
        for i, (quant, emit, act_up) in enumerate(self.quant_plan(H)):
            stage = f"{self.SCALE_PREFIX}/refinement_modules_{i}"
            if act_up:
                tags.append(f"{stage}/layer0/act_up")
            if quant:
                tags.append(f"{stage}/act_mid")
            if emit:
                tags.append(f"{stage}/act_out")
        return sorted(tags)

    def forward(self, layout, compute_dtype=None):
        """layout (N, dims[0], H, W) -> images (N, 3, H, W) in f32."""
        N, _, H, W = layout.shape
        n_mods = len(self.refinement_modules)
        h0, w0 = H >> n_mods, W >> n_mods
        if h0 <= 0 or w0 <= 0:
            raise ValueError("Too many refinement modules for image size")
        # The layout pyramid by successive halving: averages of equal-size
        # blocks compose, so each level equals pooling the full layout.
        pyramid = [layout if compute_dtype is None
                   else layout.to(compute_dtype)]
        for _ in range(n_mods - 1):
            pyramid.append(avg_pool_2d(pyramid[-1], 2))
        pyramid = pyramid[::-1]
        feats = torch.zeros((N, 1, h0, w0), dtype=pyramid[0].dtype,
                            device=layout.device)
        feats_scale = None
        plan = self.quant_plan(H)
        for i, (module, level) in enumerate(zip(self.refinement_modules,
                                                pyramid)):
            quant, emit, _ = plan[i]
            out = module(level, feats, compute_dtype,
                         self.act_scales if quant else None,
                         f"{self.SCALE_PREFIX}/refinement_modules_{i}", emit,
                         feats_scale)
            feats, feats_scale = out if emit else (out, None)
        conv0, conv2 = self.output_conv[0], self.output_conv[2]
        if feats_scale is not None:
            # The last stage handed over int8: the head's 3x3 conv takes
            # it (the 1x1 RGB projection stays float32).
            x = conv0(feats, s_in=feats_scale)
        else:
            x = conv0(feats, dtype=compute_dtype or feats.dtype)
        x = apply_activation(self.act, x.float())
        return conv2(x)
