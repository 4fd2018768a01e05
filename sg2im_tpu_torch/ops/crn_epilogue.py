"""The CRN's post-convolution chain in one pass: the Hopper kernel's wrapper,
its plain version and its launch counter.

After each CRN convolution in bf16 the eager chain is

    sum(addends) -> float() -> batch_norm (eval) -> leaky_relu -> to(dtype)

five passes over the activations where conv0 sums two convolutions
('split', 'phase'), six with three ('split' with the noise apart), four
after conv1, two at the head (no norm, a float32 output).
:func:`crn_epilogue` computes the same function in one pass
(``csrc/crn_epilogue.cu``): it reads each bf16 addend once and writes the
output once.  Its arithmetic is the chain's: the partial sums rounded to
bf16 where the chain rounds them, ``bf16(bf16(a0 + a1) + a2)``; BatchNorm
from the raw running mean and variance, weight and bias in float32; the
LeakyReLU in float32.  Only the BatchNorm's float32 roundings may differ
from the eager chain's, which come from cuDNN: by one bf16 step of the
output, or near 0 by the float32 roundings of its terms.  It replaces no TPU kernel: XLA fused this chain into the
convolutions' consumers.  The source's header says what bounds the kernel.

For a CUDA tensor the wrapper launches the kernel or raises: the addends
must be bf16 of one shape, channels_last contiguous (the layout the CRN's
convolutions write), and the BatchNorm's four vectors float32 of C on the
same card.  For a CPU tensor it computes the plain version,
:func:`crn_epilogue_ref`, the eager chain op for op.  ``crn_epilogue.launches``
counts kernel launches and nothing else.  Which calls take the kernel is
the CRN's choice (``nn/crn.py``); nothing here has a gradient.  A caller
whose parts may not be channels_last hands them through
:func:`channels_last_parts`, which makes them so and counts each copy in
``crn_epilogue.layout_copies``.

The launch follows :func:`epilogue_plan`, cached per shape: units of 8
channels (16-byte loads) where C is a multiple of 8 and every pointer is
16-byte aligned, else of one channel; blocks whose threads are a multiple
of the C / unit channel groups, a grid that covers the tensor in one trip
of its threads.  The host's part of a launch is kept short (the cached
plan as one struct pointer, the raw stream): at the first CRN stage it is
near the kernel's time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sg2im_tpu_torch.ops.relayout import _current_device, _stream

MAX_ADDENDS = 3
MAX_THREADS = 512   # the kernel's launch bound
BLOCK = 256         # threads a block, rounded down to whole channel groups


def unroll(out_f32) -> int:
    """Units a thread takes (the kernel's kUnroll): 4 with a bf16 output, 1
    with a float32 one."""
    return 1 if out_f32 else 4


class EpiloguePlan(NamedTuple):
    """How one epilogue launches: ``grid`` blocks of ``threads`` threads
    (a multiple of ``channels // vec``) over ``units`` units of ``vec``
    channels, :func:`unroll` units a thread; ``addends`` bf16 inputs, a
    float32 output or bf16 (``out_f32``), eval BatchNorm or none
    (``bn``)."""
    units: int
    addends: int
    vec: int
    out_f32: int
    bn: int
    channels: int
    threads: int
    grid: int
    slope: float
    eps: float


class PlanStruct(ctypes.Structure):
    """A plan as the C entry reads it (``struct Plan`` of
    ``csrc/crn_epilogue.cu``)."""
    _fields_ = ([("units", ctypes.c_int64)]
                + [(name, ctypes.c_int32)
                   for name in EpiloguePlan._fields[1:8]]
                + [("slope", ctypes.c_float), ("eps", ctypes.c_float)])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def epilogue_plan(numel, channels, addends, out_f32, bn, slope, eps,
                  aligned) -> EpiloguePlan:
    """The launch for ``numel`` elements of ``channels`` channels;
    ``aligned``: every pointer 16-byte aligned.  The grid covers the
    tensor in one trip of its threads."""
    if not 1 <= addends <= MAX_ADDENDS:
        raise ValueError(f"{addends} addends; the kernel takes 1 to "
                         f"{MAX_ADDENDS}")
    vec = 8 if channels % 8 == 0 and aligned else 1
    groups = channels // vec
    if groups > MAX_THREADS:
        raise ValueError(f"{channels} channels exceed the kernel's block")
    threads = groups * max(1, BLOCK // groups)
    units = numel // vec
    grid = _cdiv(units, threads * unroll(out_f32))
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{numel} elements exceed the kernel's grid")
    return EpiloguePlan(units, addends, vec, int(out_f32), int(bn), channels,
                        threads, grid, float(slope), float(eps))


@functools.lru_cache(maxsize=512)
def _plan_address(*key) -> tuple:
    """(the PlanStruct of ``epilogue_plan(*key)``, its address), cached per
    shape: the cache keeps the struct alive."""
    struct = PlanStruct(*epilogue_plan(*key))
    return struct, ctypes.addressof(struct)


def add_parts(parts):
    """The parts added left to right, as the eager chain adds them."""
    x = parts[0]
    for p in parts[1:]:
        x = x + p
    return x


def channels_last_parts(parts):
    """``parts`` as the kernel reads them: on the card each one that is not
    channels_last contiguous is copied so, and the copy counted in
    ``crn_epilogue.layout_copies``.  CPU tensors pass as they are."""
    out = []
    for p in parts:
        if p.device.type != "cpu" and not p.is_contiguous(
                memory_format=torch.channels_last):
            crn_epilogue.layout_copies += 1
            p = p.contiguous(memory_format=torch.channels_last)
        out.append(p)
    return out


def crn_epilogue_ref(addends, slope, out_dtype=torch.bfloat16, norm=None,
                     eps=1e-5) -> torch.Tensor:
    """Plain version: the eager chain, op for op."""
    x = add_parts(addends).float()
    if norm is not None:
        x = F.batch_norm(x, *norm, False, 0.0, eps)
    return F.leaky_relu(x, negative_slope=slope).to(out_dtype)


def _check(addends, norm, out_dtype):
    x = addends[0]
    if x.ndim != 4 or x.device.type != "cuda":
        raise ValueError(f"crn_epilogue takes 4-D CPU or CUDA tensors, not "
                         f"{tuple(x.shape)} on {x.device}")
    for a in addends:
        if (a.dtype != torch.bfloat16 or a.shape != x.shape
                or a.device != x.device or not a.is_contiguous(
                    memory_format=torch.channels_last)):
            raise ValueError("the addends must be bf16 tensors of one shape "
                             "on one card, channels_last contiguous; got "
                             f"{[(tuple(t.shape), t.dtype) for t in addends]}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"crn_epilogue writes bf16 or float32, not "
                         f"{out_dtype}")
    if norm is not None:
        C = x.shape[1]
        for t in norm:
            if (t.dtype != torch.float32 or t.device != x.device
                    or t.numel() != C or not t.is_contiguous()):
                raise ValueError("the BatchNorm's vectors must be float32 "
                                 f"of {C} on {x.device}, contiguous")


def crn_epilogue(addends, slope, out_dtype=torch.bfloat16, norm=None,
                 eps=1e-5) -> torch.Tensor:
    """``leaky_relu(batch_norm(sum(addends)))`` in one pass: ``addends``
    1 to 3 bf16 (N, C, H, W) tensors, summed left to right with each
    partial sum rounded to bf16; ``norm`` None or the eval BatchNorm's
    (running_mean, running_var, weight, bias) with ``eps``; the LeakyReLU's
    ``slope``; the result in ``out_dtype`` (bf16 or float32), channels_last
    on CUDA."""
    if not 1 <= len(addends) <= MAX_ADDENDS:
        raise ValueError(f"{len(addends)} addends; 1 to {MAX_ADDENDS}")
    x = addends[0]
    if x.device.type == "cpu":
        return crn_epilogue_ref(addends, slope, out_dtype, norm, eps)
    _check(addends, norm, out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device,
                      memory_format=torch.channels_last)
    ptrs = [a.data_ptr() for a in addends]
    op = out.data_ptr()
    aligned = not any(p % 16 for p in ptrs + [op])
    index = x.get_device()
    _, addr = _plan_address(x.numel(), x.shape[1], len(addends),
                            out_dtype == torch.float32, norm is not None,
                            slope, eps, aligned)
    ptrs += [None] * (MAX_ADDENDS - len(ptrs))
    stats = ([t.data_ptr() for t in norm] if norm is not None
             else [None] * 4)
    from sg2im_tpu_torch.ops._build import load_library

    fn = load_library().sg2im_crn_epilogue
    if index == _current_device():
        rc = fn(*ptrs, *stats, op, addr, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*ptrs, *stats, op, addr, _stream(index))
    if rc != 0:
        raise RuntimeError(f"sg2im_crn_epilogue launch failed: cudaError "
                           f"{rc}")
    crn_epilogue.launches += 1
    return out


crn_epilogue.launches = 0
crn_epilogue.layout_copies = 0
