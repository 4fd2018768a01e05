"""Cascaded Refinement Network (Chen & Koltun, ICCV 2017), NCHW.

Counterpart of ``sg2im_tpu/nn/crn.py`` in every conv0 mode, in eval and in
train mode (the BatchNorms' batch statistics; the packed stages fold the four
phases into each channel's reduction).  Each
stage nearest-2x upsamples its features, meets the layout average-pooled
to its resolution, and applies two conv-norm-act blocks; the features start
as zeros of one channel at H / 2^stages.  Parameters keep the upstream
names: ``refinement_modules.{k}.net.{i}`` (convs at 0 and 3, norms at 1 and
4 with normalization) and ``output_conv.{0,2}``; no mode changes them.

conv0 modes (``conv0_mode``):

* 'legacy' builds concat(layout, upsample2(feats)) and runs one conv;
* 'split' convolves the layout and the upsampled feats with their slices
  of the kernel and sums, so the wide concat is never stored; with a
  separate ``noise`` tensor (the generator's 'split_noise') the trailing
  noise channels of the layout block get their own pyramid and slice too;
* 'phase' factors the feats branch into four phase kernels applied at the
  coarse resolution, whose outputs ``depth_to_space`` interleaves;
* 'packed' runs each stage at a layout resolution >= ``packed_min_res``
  in the space-to-depth domain (half the resolution, four times the
  channels, 2x2 convs with kernels derived from the stock ones), the
  head too; ``space_to_depth`` packs each such stage's layout level and
  ``depth_to_space`` unpacks the features at each boundary and after the
  head.  The two relayouts are the Hopper kernel of ``ops/relayout.py``
  for CUDA tensors.
All are exact up to the order of the sums.

After each convolution of a stage, and after the head's 3x3 conv, the
chain sum -> f32 -> norm -> activation -> cast runs as one pass where the
tensors lie on a card, compute is bf16, the norm is an eval BatchNorm or
none and no gradient is recorded: ``ops/crn_epilogue.crn_epilogue``, the
Hopper kernel (conv0 hands it the convolutions it would add, ``addends``;
parts that are not channels_last are made so first, and counted).
Everywhere else (the CPU, float32 compute, train mode, a recorded
gradient, instance norm) and in the int8 tier and 'packed' it runs
eagerly, op for op, as ``crn_epilogue_ref`` does.

The layout pyramid (every mode) and the nearest-2x upsample of the feats
('legacy', 'split' and the int8 tier's float stages) take
``ops/resample``, the Hopper resampling kernel, where its rule says so
(on the card, bf16 or float32, whole 16-byte vectors of channels, no
gradient recorded): one launch for the whole pyramid, one an upsample,
bit-equal to the eager ``avg_pool2d`` and ``interpolate`` they replace.

``compute_dtype=torch.bfloat16`` runs the convolutions and the tensors
between them in bf16 while norm and activation run in f32, as the JAX
package does; the layout pyramid is kept in the compute dtype.  Derived
kernels (packed, phase) are computed in float32 from the float32
parameters at each call and cast once.

``quant='int8'`` is the turbo serving tier (the JAX package's
``crn_quant``), inference only, in the 'legacy' and 'split' modes: the
stages whose layout resolution lies in [quant_min_res, quant_max_res] run
their feats-branch and second convolutions as int8 x int8 with exact int32
sums
(``ops/conv_kernel.conv3x3_int8``, the Hopper kernel for CUDA tensors),
weights quantized per output channel from the f32 parameters at each call,
activations per tensor at calibrated scales.  The stages are int8-resident:
a quantized epilogue writes int8 and the next quantized conv reads it.  The
scales live in ``act_scales``, outside the state dict, keyed by the JAX
package's tag paths.
"""

from __future__ import annotations

import functools

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
from sg2im_tpu_torch.ops import resample
from sg2im_tpu_torch.ops.conv_kernel import conv3x3_int8
from sg2im_tpu_torch.ops.crn_epilogue import (
    add_parts,
    channels_last_parts,
    crn_epilogue,
)
from sg2im_tpu_torch.ops.relayout import depth_to_space, space_to_depth

CONV0_MODES = ("legacy", "phase", "split", "packed")
QUANT_MODES = ("legacy", "split")


def check_conv0_mode(mode: str) -> None:
    if mode not in CONV0_MODES:
        raise ValueError(f"unknown CRN mode {mode!r}; one of {CONV0_MODES}")


def _conv3x3(x, weight, bias=None):
    return F.conv2d(x, weight, bias, padding=1)


def _channels_last(x):
    """The relayout kernels read NHWC memory: no copy when x already is."""
    return x.contiguous(memory_format=torch.channels_last)


# The device type on which the post-convolution chain takes the kernel.
EPILOGUE_DEVICE = "cuda"


def _fuses(parts, norm, compute_dtype) -> bool:
    """Whether the chain after a convolution takes the kernel: ``parts``
    (the tensors it sums) on the card; the compute dtype bf16; ``norm`` an
    eval BatchNorm or None; no gradient recorded.  The kernel's wrapper
    refuses parts it cannot take."""
    if (compute_dtype != torch.bfloat16
            or parts[0].device.type != EPILOGUE_DEVICE
            or not (norm is None or (isinstance(norm, BatchNorm)
                                     and not norm.training))):
        return False
    return not (torch.is_grad_enabled() and (
        any(p.requires_grad for p in parts)
        or (norm is not None and norm.weight.requires_grad)))


def _bn_vectors(norm):
    """An eval BatchNorm's (running_mean, running_var, weight, bias)."""
    if norm is None:
        return None
    return (norm.running_mean, norm.running_var, norm.weight, norm.bias)


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


# ---------------------------------------------------------------------------
# The packed (space-to-depth) domain.  Fine pixel (2i + a, 2j + b) is phase
# (a, b) of packed pixel (i, j).  A 3x3 'same' conv on the fine grid is a
# 2x2 conv over the packed grid padded by one, whose output phase (a, b)
# at (i, j) is the conv output at (i + a, j + b) in that phase's channels.
# ---------------------------------------------------------------------------

@functools.cache
def _phase_select(device) -> torch.Tensor:
    """S[a, u, p, d] = 1 where output phase ``a``, packed-window row ``u``
    and source phase ``p`` take the stock kernel's row tap ``d``: source
    fine row 2i + a + (d - 1) = 2(i + a - 1 + u) + p."""
    S = torch.zeros(2, 2, 2, 3)
    for a in range(2):
        for u in range(2):
            for p in range(2):
                d = a + 2 * u + p - 1
                if 0 <= d <= 2:
                    S[a, u, p, d] = 1.0
    return S.to(device)


def _packed_kernel_distinct(w):
    """Stock (co, cin, 3, 3) float32 -> packed (4co, 4cin, 2, 2) for an
    input whose four phases hold distinct fine-grid values; channel orders
    (a, b, c) out and (p, q, l) in."""
    co, cin = w.shape[:2]
    S = _phase_select(w.device)
    k = torch.einsum("aupd,bvqe,clde->abcpqluv", S, S, w)
    return k.reshape(4 * co, 4 * cin, 2, 2)


def _packed_kernel_aliased(w):
    """Stock (co, cin, 3, 3) float32 -> packed (4co, cin, 2, 2) for an
    input whose four phases alias one value (a nearest-2x-upsampled map):
    the taps that land on one source pixel sum, 16 instead of 36 products
    per 2x2 output block."""
    co, cin = w.shape[:2]
    S2 = _phase_select(w.device).sum(dim=2)  # (a, u, d)
    k = torch.einsum("aud,bve,clde->abcluv", S2, S2, w)
    return k.reshape(4 * co, cin, 2, 2)


def _packed_conv_apply(x, k_packed, co, bias=None):
    """Pad-1 2x2 conv of a packed (N, Cin, R, Rw) input, then each phase's
    shifted slice: -> (N, 4co, R, Rw)."""
    R, Rw = x.shape[2:]
    y = F.conv2d(x, k_packed, bias, padding=1)  # (N, 4co, R + 1, Rw + 1)
    return torch.cat([y[:, (2 * a + b) * co:(2 * a + b + 1) * co,
                        a:a + R, b:b + Rw]
                      for a in (0, 1) for b in (0, 1)], 1)


def packed_instance_norm(x, co: int, eps: float = 1e-5):
    """Instance norm of a packed (N, 4co, R, Rw) tensor: the statistics of
    channel c reduce over the packed positions and the four phases, i.e.
    over the fine grid, as ``instance_norm_2d`` of the unpacked tensor."""
    N, _, R, Rw = x.shape
    xs = x.reshape(N, 4, co, R, Rw)
    mean = xs.mean(dim=(1, 3, 4), keepdim=True)
    var = ((xs - mean) ** 2).mean(dim=(1, 3, 4), keepdim=True)
    return ((xs - mean) * torch.rsqrt(var + eps)).reshape(x.shape)


def packed_conv1x1(conv: nn.Conv2d, x):
    """The head's RGB projection in the packed domain (the JAX package's
    ``PackedConv1x1``): ``conv``'s 1x1 kernel on each phase of x (N,
    4cin, R, Rw), a grouped conv, then ``depth_to_space`` -> (N, co, 2R,
    2Rw)."""
    y = F.conv2d(x, conv.weight.repeat(4, 1, 1, 1), conv.bias.repeat(4),
                 groups=4)
    return depth_to_space(_channels_last(y))


class QuantConv3x3(nn.Conv2d):
    """A 3x3 'same' Conv2d (same ``weight`` and ``bias``) that can also run
    on the int8 path: ``forward(x, dtype=...)`` is the plain conv in
    ``dtype``; ``forward(xq, s_in=s)`` takes int8 ``xq`` at per-tensor
    scale ``s`` and returns ``_conv_int8(xq, weight, s) + bias`` in f32.
    :meth:`packed` is the same conv in the packed domain."""

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

    def packed(self, x, dtype=None):
        """This conv on a packed (N, 4cin, R, Rw) input -> packed (N, 4co,
        R, Rw), in ``dtype`` (the JAX package's ``PackedConv3x3``)."""
        dtype = dtype or x.dtype
        kp = _packed_kernel_distinct(self.weight.float()).to(dtype)
        return _packed_conv_apply(x.to(dtype), kp, self.out_channels,
                                  self.bias.to(dtype).repeat(4))


class FusedUpsampleConv(nn.Module):
    """``conv3x3(concat(layout, upsample2(feats)))`` with the parameters of
    the one Conv2d it stands for: ``weight`` (co, layout_dim + feats_dim, 3,
    3) and ``bias``.

    mode 'legacy' builds the concat and runs one conv; 'split' runs
    conv(layout, W[:, :layout_dim]) + conv(up, W[:, layout_dim:]), so the
    wide concat is never stored; 'phase' runs the feats branch as four
    phase kernels at the coarse resolution, interleaved by
    ``depth_to_space``.  A stage whose feats already match the layout
    resolution takes the concat in every mode.  :meth:`packed` is the
    conv in the packed domain.
    """

    def __init__(self, layout_dim: int, feats_dim: int, output_dim: int,
                 mode: str = "legacy"):
        super().__init__()
        check_conv0_mode(mode)
        if mode == "packed":
            raise ValueError("'packed' is a network mode: its stages call "
                             "FusedUpsampleConv.packed")
        self.layout_dim = layout_dim
        self.mode = mode
        self.weight = nn.Parameter(
            torch.empty(output_dim, layout_dim + feats_dim, 3, 3))
        self.bias = nn.Parameter(torch.zeros(output_dim))
        self.kernel_init = "kaiming_normal"
        nn.init.kaiming_normal_(self.weight)

    def _layout_convs(self, layout, noise, w):
        """The layout block's share of a split conv0, as the convolutions
        it adds: [conv(layout, W[:, :layout_dim])], or, with the trailing
        noise channels apart, [conv(layout, its slice), conv(noise, its
        slice)]."""
        Dl = self.layout_dim
        if noise is None:
            return [_conv3x3(layout, w[:, :Dl])]
        Dn = noise.shape[1]
        return [_conv3x3(layout, w[:, :Dl - Dn]),
                _conv3x3(noise, w[:, Dl - Dn:Dl])]

    def forward(self, layout, feats, dtype, act_scales=None, tag="",
                feats_scale=None, noise=None):
        """The conv: :meth:`addends` added left to right."""
        return add_parts(self.addends(layout, feats, dtype, act_scales, tag,
                                      feats_scale, noise))

    def addends(self, layout, feats, dtype, act_scales=None, tag="",
                feats_scale=None, noise=None):
        """The conv as the tensors whose sum, left to right, it is: one
        for 'legacy' and the concat, two for 'split' and 'phase', three
        for 'split' with ``noise`` apart, one for a quantized stage.

        With ``act_scales`` (a quantized stage) the feats branch runs
        int8: ``feats`` arrives int8 at ``feats_scale`` from the previous
        stage, or is quantized here at the coarse resolution under
        ``<tag>/act_up``; the layout branch stays a ``dtype`` conv and the
        bias f32.  Both quantized modes compute the branches apart then.

        ``noise`` (split mode only): the trailing channels of the layout
        block, supplied apart with their own kernel slice."""
        w = self.weight.to(dtype)
        b = self.bias.to(dtype)
        layout = layout.to(dtype)
        Dl = self.layout_dim
        if noise is not None:
            if self.mode != "split":
                raise ValueError("a separate noise tensor needs conv0 mode "
                                 f"'split', not {self.mode!r}")
            if layout.shape[1] + noise.shape[1] != Dl:
                raise ValueError(f"layout {layout.shape[1]} + noise "
                                 f"{noise.shape[1]} channels != {Dl}")
            noise = noise.to(dtype)
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
                return [out + add_parts(self._layout_convs(layout, noise, w))
                        + self.bias[:, None, None]]
            # Equal resolution: dequantize and take the concat conv.
            if feats_scale is not None:
                feats = feats.float() * feats_scale
            feats = feats.to(dtype)
        if same_res:
            parts = [layout] + ([noise] if noise is not None else [])
            return [_conv3x3(torch.cat(parts + [feats], 1), w, b)]
        if self.mode == "phase":
            kb = _packed_kernel_aliased(self.weight[:, Dl:].float()).to(dtype)
            up = _packed_conv_apply(feats, kb, self.weight.shape[0])
            return [_conv3x3(layout, w[:, :Dl], b),
                    depth_to_space(_channels_last(up))]
        up = upsample_nearest(feats, 2)
        if self.mode == "legacy":
            return [_conv3x3(torch.cat([layout, up], 1), w, b)]
        return self._layout_convs(layout, noise, w) + [
            _conv3x3(up, w[:, Dl:], b)]

    def packed(self, layout_packed, feats, dtype):
        """This conv in the packed domain (the JAX package's
        ``PackedUpsampleConv``): ``layout_packed`` (N, 4 * layout_dim, R,
        Rw) with distinct phases, ``feats`` (N, feats_dim, R, Rw) on the
        coarse grid, whose upsample aliases the phases -> packed (N, 4co,
        R, Rw)."""
        Dl = self.layout_dim
        w = self.weight.float()
        kp = torch.cat([_packed_kernel_distinct(w[:, :Dl]),
                        _packed_kernel_aliased(w[:, Dl:])], 1).to(dtype)
        x = torch.cat([layout_packed.to(dtype), feats.to(dtype)], 1)
        return _packed_conv_apply(x, kp, self.weight.shape[0],
                                  self.bias.to(dtype).repeat(4))


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
    separately.  :meth:`packed` runs the stage in the packed domain."""

    def __init__(self, layout_dim: int, input_dim: int, output_dim: int,
                 normalization: str = "instance",
                 activation: str = "leakyrelu", conv0_mode: str = "legacy"):
        super().__init__()
        self.normalization = normalization
        self.output_dim = output_dim
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

    def _layers(self):
        """(conv0, conv1, (norm0, norm1)); norms None without
        normalization."""
        if self.normalization == "none":
            return self.net[0], self.net[2], (None, None)
        return self.net[0], self.net[3], (self.net[1], self.net[4])

    def forward(self, layout, feats, compute_dtype=None, act_scales=None,
                tag="", emit_q=False, feats_scale=None, noise=None,
                eager=False):
        """layout (N, Dl, HH, WW); feats (N, C, H, W) at half the stage's
        resolution (or at it) -> (N, output_dim, 2H, 2W).  ``noise``: the
        layout block's trailing channels apart (split mode), pooled with
        the layout.  ``eager``: keep both chains eager, as the network
        asks for the stages of the int8 tier and of 'packed' (whose
        low-resolution stages are 'legacy' ones); everything else that
        keeps a chain eager the stage sees itself.

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
            if noise is not None:
                noise = avg_pool_2d(noise, HH // target)
        dtype = compute_dtype or layout.dtype
        conv0, conv1, norms = self._layers()
        fuse = not eager and act_scales is None
        parts = conv0.addends(layout, feats, dtype, act_scales,
                              f"{tag}/layer0", feats_scale, noise)
        for k, norm in enumerate(norms):
            if k == 1:
                parts = [conv1(x, dtype=dtype) if act_scales is None
                         else conv1(x, s_in=s_mid)]
            if fuse and _fuses(parts, norm, compute_dtype):
                x = crn_epilogue(channels_last_parts(parts), self.act[1],
                                 compute_dtype, _bn_vectors(norm),
                                 BatchNorm.eps)
                continue
            x = add_parts(parts)
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

    def packed(self, layout_packed, feats, compute_dtype=None):
        """The stage in the packed domain (the JAX package's
        ``PackedRefinementModule``): ``layout_packed`` (N, 4Dl, R, Rw) is
        ``space_to_depth`` of the stage's layout level, ``feats`` (N, C,
        R, Rw) the fine-grid features at half the stage's resolution ->
        the stage output packed, (N, 4 * output_dim, R, Rw).  Norms reduce
        each channel over its four phases."""
        dtype = compute_dtype or layout_packed.dtype
        co = self.output_dim
        conv0, conv1, norms = self._layers()
        x = conv0.packed(layout_packed, feats, dtype)
        for k, norm in enumerate(norms):
            if k == 1:
                x = conv1.packed(x, dtype)
            if compute_dtype is not None:
                x = x.float()
            if isinstance(norm, BatchNorm):
                x = norm(x, phases=4)
            elif norm is not None:
                x = packed_instance_norm(x, co)
            x = apply_activation(self.act, x)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
        return x


class RefinementNetwork(nn.Module):
    """The full CRN (upstream ``crn.py:68-111``).  ``dims[0]`` is the layout
    channel count and ``dims[1:]`` the stage widths; the head is conv3x3 +
    activation + conv1x1 to RGB.

    ``conv0_mode='packed'``: the stages whose layout level has a
    resolution >= ``packed_min_res`` (and even height and width) run
    packed, and so does the head when the last stage did; the others run
    'legacy'.

    ``quant='int8'`` ('legacy' and 'split' only): the stages whose layout
    level has a resolution in [quant_min_res, quant_max_res] are
    quantized; a stage whose consumer is quantized too (the next stage, or
    the head's 3x3 conv when ``quant_head``) hands its output over as int8.
    The scale tags in ``act_scales`` carry the generator's prefix,
    ``refinement_net``."""

    SCALE_PREFIX = "refinement_net"

    def __init__(self, dims, normalization: str = "instance",
                 activation: str = "leakyrelu", conv0_mode: str = "legacy",
                 packed_min_res: int = 32, quant=None,
                 quant_min_res: int = 32, quant_max_res: int = 1 << 30,
                 quant_head: bool = True):
        super().__init__()
        check_conv0_mode(conv0_mode)
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quantization tier {quant!r}")
        if quant is not None and conv0_mode not in QUANT_MODES:
            raise ValueError(f"int8 quant runs the conv0 modes {QUANT_MODES}"
                             f", not {conv0_mode!r}")
        self.dims = tuple(dims)
        self.act = parse_activation(activation)
        self.conv0_mode = conv0_mode
        self.packed_min_res = packed_min_res
        self.quant = quant
        self.quant_min_res = quant_min_res
        self.quant_max_res = quant_max_res
        self.quant_head = quant_head
        self.act_scales = ActScales()
        layout_dim = self.dims[0]
        stage_mode = "legacy" if conv0_mode == "packed" else conv0_mode
        self.refinement_modules = nn.ModuleList(
            RefinementModule(layout_dim, 1 if i == 1 else self.dims[i - 1],
                             self.dims[i], normalization, activation,
                             stage_mode)
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

    def _stage_packed(self, level) -> bool:
        H, W = level.shape[2:]
        return (self.conv0_mode == "packed" and H >= self.packed_min_res
                and H % 2 == 0 and W % 2 == 0)

    def forward(self, layout, compute_dtype=None, noise=None):
        """layout (N, dims[0], H, W) -> images (N, 3, H, W) in f32.

        ``noise`` (split mode): the trailing ``noise.shape[1]`` channels of
        the ``dims[0]``-wide layout block, supplied apart; they ride their
        own pyramid and kernel slice, so concat(layout, noise) is never
        stored at any resolution."""
        N, _, H, W = layout.shape
        if self.training and self.quant is not None:
            raise ValueError("the int8 tier is inference only: call .eval() "
                             "or build the network without quant")
        if noise is not None:
            if self.conv0_mode != "split":
                raise ValueError("a separate noise tensor needs CRN mode "
                                 f"'split', not {self.conv0_mode!r}")
            if layout.shape[1] + noise.shape[1] != self.dims[0]:
                raise ValueError(
                    f"layout {layout.shape[1]} + noise {noise.shape[1]} "
                    f"channels != {self.dims[0]}")
        n_mods = len(self.refinement_modules)
        h0, w0 = H >> n_mods, W >> n_mods
        if h0 <= 0 or w0 <= 0:
            raise ValueError("Too many refinement modules for image size")

        def build_pyramid(t):
            # By successive halving, each level rounded to the compute
            # dtype before the next is pooled from it; on the card in one
            # launch of the resampling kernel where it takes the tensor.
            t = t if compute_dtype is None else t.to(compute_dtype)
            pool = (resample.pool_pyramid
                    if resample.pyramid_takes_kernel(t, n_mods - 1)
                    else resample.pool_pyramid_ref)
            return ([t] + pool(t, n_mods - 1))[::-1]

        pyramid = build_pyramid(layout)
        noise_pyramid = (build_pyramid(noise) if noise is not None
                         else [None] * n_mods)
        feats = torch.zeros((N, 1, h0, w0), dtype=pyramid[0].dtype,
                            device=layout.device)
        feats_scale = None
        packed = False  # does `feats` hold a packed stage output?
        plan = self.quant_plan(H)
        # The int8 tier and 'packed' keep every chain eager.
        eager = self.quant is not None or self.conv0_mode == "packed"
        for i, module in enumerate(self.refinement_modules):
            level = pyramid[i]
            if packed:
                feats = depth_to_space(_channels_last(feats))
                packed = False
            if self._stage_packed(level):
                feats = module.packed(space_to_depth(_channels_last(level)),
                                      feats, compute_dtype)
                packed = True
                continue
            quant, emit, _ = plan[i]
            out = module(level, feats, compute_dtype,
                         self.act_scales if quant else None,
                         f"{self.SCALE_PREFIX}/refinement_modules_{i}", emit,
                         feats_scale, noise_pyramid[i], eager)
            feats, feats_scale = out if emit else (out, None)
        conv0, conv2 = self.output_conv[0], self.output_conv[2]
        if packed:
            x = conv0.packed(feats, compute_dtype or feats.dtype)
            return packed_conv1x1(conv2, apply_activation(self.act,
                                                          x.float()))
        if feats_scale is not None:
            # The last stage handed over int8: the head's 3x3 conv takes
            # it (the 1x1 RGB projection stays float32).
            x = conv0(feats, s_in=feats_scale)
        else:
            x = conv0(feats, dtype=compute_dtype or feats.dtype)
        if (not (eager or self.training)
                and _fuses([x], None, compute_dtype)):
            # The 1x1 RGB projection takes float32.
            return conv2(crn_epilogue(channels_last_parts([x]), self.act[1],
                                      torch.float32))
        x = apply_activation(self.act, x.float())
        return conv2(x)
