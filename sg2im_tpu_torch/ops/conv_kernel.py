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

The int8 plain version convolves in float64, which is exact here: a sum
of 9 * Cin products of int8 values stays far below 2^53.  (A float32
convolution is not exact once |acc| passes 2^24, and ``F.conv2d`` on int8
tensors returns int8 and wraps.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.2
_OUT_DTYPES = (torch.float32, torch.bfloat16)


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


def _tap_major(weight) -> torch.Tensor:
    """OIHW -> (9 * Cin, Co), tap-major: the kernel's weight layout."""
    Co, Cin = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9 * Cin, Co).contiguous()


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
    w = _tap_major(weight)
    out, view = _nhwc_out(x, Co, out_dtype)
    with torch.cuda.device(x.device):
        rc = lib.sg2im_conv3x3_bf16(
            x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            N, H, W, Cin, Co, int(scale is not None),
            int(out_dtype == torch.bfloat16),
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
    w = _tap_major(wq)
    out, view = _nhwc_out(xq, Co, torch.float32)
    with torch.cuda.device(xq.device):
        rc = lib.sg2im_conv3x3_s8(
            xq.data_ptr(), w.data_ptr(), dq.data_ptr(), out.data_ptr(),
            N, H, W, Cin, Co, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sg2im_conv3x3_s8 launch failed: cudaError {rc}")
    conv3x3_int8.launches += 1
    return view


conv3x3.launches = 0
conv3x3_int8.launches = 0
