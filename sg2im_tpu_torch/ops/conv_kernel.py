"""3x3 'same' convolution: the Hopper kernel's wrappers, their plain versions
and their launch counters.

``conv3x3`` (bf16 in, f32 sums, optional per-channel ``scale * acc + bias``
-> LeakyReLU(0.2) epilogue, f32 or bf16 out) is the port of the TPU kernel
of ``scripts/proto_pallas_conv.py`` (``make_conv_kernel``).  ``conv3x3_int8``
(int8 in, exact int32 sums, out ``f32(acc) * dq[co]``) is the same kernel's
int8 entry, the convolution of the turbo tier (``_conv_int8`` of the JAX
package's ``nn/crn.py``).  The CUDA source is ``csrc/conv3x3.cu``; its header
says what bounds the kernel and what the design does about it.

Tensors are NCHW with channels_last memory (the kernel reads NHWC) and
weights OIHW; outputs are NCHW views of NHWC storage.  For a CUDA tensor
each wrapper launches the kernel or raises; for a CPU tensor it computes
the plain version (``conv3x3_ref``, ``conv3x3_int8_ref``).
``<wrapper>.launches`` counts kernel launches and nothing else.

The kernel takes its weights as tiles laid out for its shared memory:
``pack_weights`` builds them from the OIHW weight on every call (the turbo
tier quantizes its weights per call), by the plan of ``tile_plan``, which
the wrapper also hands to the kernel.  The kernel reads its input through a
TMA tensor map, which needs a 16-byte aligned base and a channel row of a
multiple of 16 bytes; an input without them (no shape of the CRN's paths)
goes through one zero-padded copy, counted in ``<wrapper>.padded_copies``.

The int8 plain version convolves in float64, which is exact here: a sum
of 9 * Cin products of int8 values stays far below 2^53.  (A float32
convolution is not exact once |acc| passes 2^24, and ``F.conv2d`` on int8
tensors returns int8 and wraps.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.2
_OUT_DTYPES = (torch.float32, torch.bfloat16)
# The kernel's tiles (kTileM, kChunkBytes and the BN it is built for in
# csrc/conv3x3.cu): output pixels per block, input-channel bytes per K step
# (one row of the 128-byte swizzle), output-channel tile widths.
TILE_M = 128
CHUNK_BYTES = 128
_BN = (128, 256)


def _epilogue(y, scale, bias):
    """scale * y + bias per channel (dim 1), then LeakyReLU(0.2)."""
    y = y * scale[:, None, None] + bias[:, None, None]
    return torch.where(y > 0, y, LEAKY_SLOPE * y)


def conv3x3_ref(x, weight, scale=None, bias=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the bf16 entry: ``F.conv2d`` in float32 (TF32 off)
    of the inputs upcast from bf16, then the optional epilogue."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.float(), weight.float(), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    if scale is not None:
        y = _epilogue(y, scale.float(), bias.float())
    return y.to(out_dtype)


def conv3x3_int8_acc(xq, wq) -> torch.Tensor:
    """The exact int32 sums of the int8 convolution, through float64."""
    acc = F.conv2d(xq.double(), wq.double(), padding=1)
    return torch.round(acc).to(torch.int32)


def conv3x3_int8_ref(xq, wq, dq) -> torch.Tensor:
    """Plain version of the s8 entry: exact int32 sums, ``f32(acc) * dq``."""
    return conv3x3_int8_acc(xq, wq).float() * dq[:, None, None]


def _on_cpu(*tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"conv3x3 runs on CPU or CUDA, not {device}")
    return False


def _check_shapes(x, weight):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, Cin, H, W), got {tuple(x.shape)}")
    if weight.ndim != 4 or weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"weight must be (Co, {x.shape[1]}, 3, 3), got "
                         f"{tuple(weight.shape)}")


def _check_kernel_inputs(x, weight, dtype, vectors: dict):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, *vectors.values())):
        raise RuntimeError("the conv3x3 kernel is forward only; run under "
                           "torch.no_grad() or torch.inference_mode()")
    for name, t in (("x", x), ("weight", weight)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} for the kernel, "
                            f"got {t.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (NHWC memory)")
    Co = weight.shape[0]
    for name, t in vectors.items():
        if t.dtype != torch.float32 or t.shape != (Co,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({Co},) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    N, Cin, H, W = x.shape
    if min(N, Cin, H, W, Co) < 1:
        raise ValueError(f"empty convolution: x {tuple(x.shape)}, "
                         f"Co {Co}")
    if N * H * W * max(Cin, Co) >= 2 ** 62:
        raise ValueError("tensor too large for the kernel's indexing")


class TilePlan(NamedTuple):
    """How the kernel cuts one convolution: blocks of TH x TW output pixels
    (TH * TW <= TILE_M) by BN output channels, K walked in steps of one
    chunk of ``chunk`` input channels (CHUNK_BYTES) by one tap."""
    TH: int
    TW: int
    tiles_h: int
    tiles_w: int
    BN: int
    co_tiles: int
    chunk: int
    n_chunks: int


def tile_plan(H, W, Cin, Co, elem_size) -> TilePlan:
    """The kernel's tile plan for an (H, W) image, Cin -> Co channels of
    ``elem_size`` bytes: whole image rows up to TILE_M pixels, and all of
    Co in one tile up to 256 channels."""
    TW = min(W, TILE_M)
    TH = min(TILE_M // TW, H)
    BN = next((b for b in _BN if Co <= b), _BN[-1])
    chunk = CHUNK_BYTES // elem_size
    return TilePlan(TH, TW, -(-H // TH), -(-W // TW), BN, -(-Co // BN),
                    chunk, -(-Cin // chunk))


@functools.lru_cache(maxsize=64)
def _pack_index(Co, Cin, plan: TilePlan, device) -> torch.Tensor:
    """For every element of the packed tiles, its index in the flattened
    OIHW weight, or Co * Cin * 9 (a zero appended to it) past Co or Cin."""
    ct, nch, BN, ch = plan.co_tiles, plan.n_chunks, plan.BN, plan.chunk
    unit = ch // 8                      # elements per 16 bytes
    co = torch.arange(ct * BN).reshape(ct, 1, 1, BN, 1)
    chunk = torch.arange(nch).reshape(1, nch, 1, 1, 1)
    tap = torch.arange(9).reshape(1, 1, 9, 1, 1)
    pos = torch.arange(ch).reshape(1, 1, 1, 1, ch)
    # Stored 16-byte unit k of row r holds logical unit k ^ (r % 8).
    ci = chunk * ch + ((pos // unit) ^ (co % BN % 8)) * unit + pos % unit
    src = (co * Cin + ci) * 9 + tap
    src = torch.where((co < Co) & (ci < Cin), src, Co * Cin * 9)
    return src.to(device)


def pack_weights(weight, plan: TilePlan) -> torch.Tensor:
    """OIHW -> the kernel's weight tiles (co_tiles, n_chunks, 9, BN, chunk)
    in weight's dtype: tap = 3 * ky + kx, zero past Co and Cin, and each
    (BN, 128-byte) tile in the 128-byte swizzle, so that one bulk copy
    lands it in shared memory as wgmma reads it.  One gather through an
    index cached per shape and device."""
    Co, Cin = weight.shape[:2]
    flat = F.pad(weight.reshape(-1), (0, 1))
    return flat[_pack_index(Co, Cin, plan, weight.device)]


def _tma_input(x, wrapper):
    """x's NHWC data as the kernel's tensor map takes it: a 16-byte aligned
    base and a row of Cin channels a multiple of 16 bytes.  Otherwise one
    zero-padded copy, counted in ``wrapper.padded_copies``.  Returns
    (tensor, channels)."""
    N, Cin, H, W = x.shape
    unit = 16 // x.element_size()
    if Cin % unit == 0 and x.data_ptr() % 16 == 0:
        return x, Cin
    xp = x.new_zeros((N, H, W, -(-Cin // unit) * unit))
    xp[..., :Cin] = x.permute(0, 2, 3, 1)
    wrapper.padded_copies += 1
    return xp, xp.shape[-1]


def _nhwc_out(x, Co, dtype):
    N, _, H, W = x.shape
    out = torch.empty((N, H, W, Co), dtype=dtype, device=x.device)
    return out, out.permute(0, 3, 1, 2)


def conv3x3(x, weight, scale=None, bias=None,
            out_dtype=torch.float32) -> torch.Tensor:
    """3x3 'same' conv, no conv bias: x (N, Cin, H, W) bf16 channels_last,
    weight (Co, Cin, 3, 3) bf16 -> (N, Co, H, W) in ``out_dtype`` (float32
    or bfloat16), sums in float32.  With ``scale`` and ``bias`` ((Co,)
    float32) the output is LeakyReLU_0.2(scale * acc + bias)."""
    if (scale is None) != (bias is None):
        raise ValueError("the epilogue takes both scale and bias, or neither")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}, "
                        f"got {out_dtype}")
    _check_shapes(x, weight)
    extra = () if scale is None else (scale, bias)
    if _on_cpu(x, weight, *extra):
        return conv3x3_ref(x, weight, scale, bias, out_dtype)
    vectors = {} if scale is None else {"scale": scale, "bias": bias}
    _check_kernel_inputs(x, weight, torch.bfloat16, vectors)
    from sg2im_tpu_torch.ops._build import load_library

    lib = load_library()
    N, Cin, H, W = x.shape
    Co = weight.shape[0]
    plan = tile_plan(H, W, Cin, Co, 2)
    w = pack_weights(weight, plan)
    xk, cin_k = _tma_input(x, conv3x3)
    out, view = _nhwc_out(x, Co, out_dtype)
    with torch.cuda.device(x.device):
        rc = lib.sg2im_conv3x3_bf16(
            xk.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            N, H, W, cin_k, Co, plan.TH, plan.TW, plan.BN,
            int(scale is not None), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sg2im_conv3x3_bf16 launch failed: cudaError {rc}")
    conv3x3.launches += 1
    return view


def conv3x3_int8(xq, wq, dq) -> torch.Tensor:
    """int8 3x3 'same' conv with an f32 dequant: xq (N, Cin, H, W) int8
    channels_last, wq (Co, Cin, 3, 3) int8, dq (Co,) float32 ->
    (N, Co, H, W) float32 = f32(exact int32 sum) * dq[co]."""
    _check_shapes(xq, wq)
    if _on_cpu(xq, wq, dq):
        for name, t in (("xq", xq), ("wq", wq)):
            if t.dtype != torch.int8:
                raise TypeError(f"{name} must be int8, got {t.dtype}")
        return conv3x3_int8_ref(xq, wq, dq)
    _check_kernel_inputs(xq, wq, torch.int8, {"dq": dq})
    from sg2im_tpu_torch.ops._build import load_library

    lib = load_library()
    N, Cin, H, W = xq.shape
    Co = wq.shape[0]
    plan = tile_plan(H, W, Cin, Co, 1)
    w = pack_weights(wq, plan)
    xk, cin_k = _tma_input(xq, conv3x3_int8)
    out, view = _nhwc_out(xq, Co, torch.float32)
    with torch.cuda.device(xq.device):
        rc = lib.sg2im_conv3x3_s8(
            xk.data_ptr(), w.data_ptr(), dq.data_ptr(), out.data_ptr(),
            N, H, W, cin_k, Co, plan.TH, plan.TW, plan.BN,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sg2im_conv3x3_s8 launch failed: cudaError {rc}")
    conv3x3_int8.launches += 1
    return view


conv3x3.launches = 0
conv3x3_int8.launches = 0
conv3x3.padded_copies = 0
conv3x3_int8.padded_copies = 0
