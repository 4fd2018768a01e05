"""The mask head's eval forward as one kernel launch a step: the Hopper
kernel's wrapper, its plain version, the weight folding and the launch
counter.

The head (``models/sg2im.py`` ``MaskNet``) runs, for each doubling step,
``Upsample(2, nearest) -> BatchNorm -> Conv3x3(pad 1) -> ReLU`` from the
objects' (B, C) vectors to (B, M, M, C) grids, then ``Conv1x1(C -> 1)``
and, in the generator, the sigmoid.  In eval mode the BatchNorm is a
per-channel affine map, which commutes with nearest upsampling; and a 3x3
conv of a nearest-2x upsampled grid is four 2x2 convs on the coarse grid,
one per output phase (a, b), with the 3x3 kernel's rows and columns summed
as :data:`FOLD` says (``csrc/mask_head.cu`` derives it).  Both are exact in
real arithmetic.  :func:`mask_step` computes one step so, in float32 FMAs
only (no TF32): it reads the coarse grid (NHWC), applies the BatchNorm as
it loads, and writes the fine grid with its phases interleaved; the last
step (``final``, the 1x1 conv's weight and bias) writes the masks, after
the 1x1 conv and the sigmoid, and never the grid.

For a CUDA tensor the wrapper launches the kernel or raises: C must be
:data:`CHANNELS`, every tensor float32 and contiguous on one card.  For a
CPU tensor it computes the plain version, :func:`mask_step_ref`, the same
phase form in PyTorch (one matmul a phase on the coarse grid's unfolded
2x2 patches).  ``mask_head.launches`` counts kernel launches (one a
step) and nothing else.  :func:`phase_weights` folds a step's 3x3
weight; the head folds once per weight version (``MaskNet``).  Which forwards take the kernel is
the head's choice; nothing here has a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sg2im_tpu_torch.ops.relayout import _current_device, _stream

CHANNELS = 128   # the kernel's only width
ROWS = 128       # rows (coarse positions) a block
THREADS = 256

# FOLD[a, t, k]: whether row k of the 3x3 kernel adds into tap t of phase
# a.  Phase 0 reads the coarse rows i - 1 (kernel row 0) and i (rows 1, 2);
# phase 1 reads i (rows 0, 1) and i + 1 (row 2).  Columns alike.
FOLD = torch.tensor([[[1., 0., 0.], [0., 1., 1.]],
                     [[1., 1., 0.], [0., 0., 1.]]])


def tap_offset(phase: int, tap: int) -> int:
    """The coarse offset that tap ``tap`` of phase ``phase`` reads, along
    one axis: -1 or 0 for phase 0, 0 or +1 for phase 1."""
    return phase + tap - 1


def phase_weights(weight: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv weight (C_out, C_in, 3, 3) folded into the phase form:
    (4 phases a * 2 + b, 4 taps ti * 2 + tj, C_in, C_out), contiguous."""
    fold = FOLD.to(weight)
    wf = torch.einsum("atk,bul,oikl->abtuio", fold, fold, weight)
    co, ci = weight.shape[:2]
    return wf.reshape(4, 4, ci, co).contiguous()


def mask_step_ref(x, norm, folded, bias, eps=1e-5, final=None):
    """Plain version of one step: ``x`` (B, S, S, C) NHWC -> (B, 2S, 2S, C)
    = relu(the phase convs of bn(x) + bias) interleaved, or with ``final``
    = (w1 (C,), b1 (1,)) the masks sigmoid(grid @ w1 + b1), (B, 2S, 2S)."""
    B, S, _, C = x.shape
    mean, var, weight, bn_bias = norm
    scale = weight * torch.rsqrt(var + eps)  # the terms the kernel forms
    xp = F.pad(x * scale + (bn_bias - mean * scale), (0, 0, 1, 1, 1, 1))
    out = x.new_empty(B, 2 * S, 2 * S, C)
    for a in (0, 1):
        for b in (0, 1):
            patches = torch.cat(
                [xp[:, 1 + tap_offset(a, ti):1 + tap_offset(a, ti) + S,
                    1 + tap_offset(b, tj):1 + tap_offset(b, tj) + S]
                 for ti in (0, 1) for tj in (0, 1)], dim=-1)
            y = patches @ folded[2 * a + b].reshape(4 * C, C) + bias
            out[:, a::2, b::2] = torch.relu(y)
    if final is None:
        return out
    w1, b1 = final
    return torch.sigmoid(out @ w1.reshape(C) + b1)


def mask_head_ref(x, steps, final, eps=1e-5):
    """Plain version of the whole head: ``x`` (B, C) -> masks (B, M, M);
    ``steps`` [(norm, folded, bias)] a doubling step each."""
    return mask_head(x, steps, final, eps, step=mask_step_ref)


class StepPlan(NamedTuple):
    """How one step launches: ``grid`` x 4 (the phases) blocks of
    ``threads`` over ``rows`` coarse positions (slots x side^2) of
    ``channels``; ``last`` the 1x1 conv and sigmoid epilogue."""
    rows: int
    side: int
    log2_side: int
    channels: int
    last: int
    grid: int
    threads: int
    eps: float


class PlanStruct(ctypes.Structure):
    """A plan as the C entry reads it (``struct Plan`` of
    ``csrc/mask_head.cu``)."""
    _fields_ = ([("rows", ctypes.c_int64)]
                + [(name, ctypes.c_int32) for name in StepPlan._fields[1:7]]
                + [("eps", ctypes.c_float)])


def step_plan(slots, side, channels, last, eps) -> StepPlan:
    """The launch of a step over ``slots`` grids of ``side`` x ``side``."""
    if channels != CHANNELS:
        raise ValueError(f"the mask head kernel takes {CHANNELS} channels, "
                         f"not {channels}")
    log2 = side.bit_length() - 1
    if side < 1 or side != 1 << log2:
        raise ValueError(f"side {side} is not a power of 2")
    rows = slots * side * side
    if rows < 1:
        raise ValueError("no slots")
    grid = -(-rows // ROWS)
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    return StepPlan(rows, side, log2, channels, int(last), grid, THREADS,
                    float(eps))


@functools.lru_cache(maxsize=256)
def _plan_address(*key) -> tuple:
    """(the PlanStruct of ``step_plan(*key)``, its address), cached per
    shape: the cache keeps the struct alive."""
    struct = PlanStruct(*step_plan(*key))
    return struct, ctypes.addressof(struct)


def _check(x, tensors):
    if x.ndim != 4 or x.shape[1] != x.shape[2] or x.device.type != "cuda":
        raise ValueError(f"mask_step takes a (B, S, S, C) CPU or CUDA grid, "
                         f"not {tuple(x.shape)} on {x.device}")
    for t in (x,) + tuple(tensors):
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError("the mask head's tensors must be float32 and "
                             f"contiguous on {x.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def mask_step(x, norm, folded, bias, eps=1e-5, final=None):
    """One step of the eval head (see :func:`mask_step_ref`): ``x`` (B, S,
    S, C) float32 NHWC, ``norm`` the eval BatchNorm's (running_mean,
    running_var, weight, bias), ``folded`` :func:`phase_weights` of the
    conv's weight, ``bias`` its bias; ``final`` None or the 1x1 conv's
    (w1, b1)."""
    if x.device.type == "cpu":
        return mask_step_ref(x, norm, folded, bias, eps, final)
    _check(x, tuple(norm) + (folded, bias) + tuple(final or ()))
    B, S, _, C = x.shape
    if folded.shape != (4, 4, C, C) or bias.numel() != C or any(
            t.numel() != C for t in norm):
        raise ValueError(f"the step's weights do not match {C} channels")
    if final is None:
        out = x.new_empty(B, 2 * S, 2 * S, C)
        w1 = b1 = None
    else:
        out = x.new_empty(B, 2 * S, 2 * S)
        w1, b1 = (t.data_ptr() for t in final)
    _, addr = _plan_address(B, S, C, final is not None, eps)
    args = (x.data_ptr(), *(t.data_ptr() for t in norm), folded.data_ptr(),
            bias.data_ptr(), w1, b1, out.data_ptr(), addr)
    from sg2im_tpu_torch.ops._build import load_library

    fn = load_library().sg2im_mask_head_step
    index = x.get_device()
    if index == _current_device():
        rc = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _stream(index))
    if rc != 0:
        raise RuntimeError(f"sg2im_mask_head_step launch failed: cudaError "
                           f"{rc}")
    mask_head.launches += 1
    return out


def mask_head(x, steps, final, eps=1e-5, step=None):
    """The eval head: ``x`` (B, C) vectors -> masks (B, M, M) in [0, 1],
    one :func:`mask_step` a doubling step (``step`` another step function,
    e.g. :func:`mask_step_ref`)."""
    step = step or mask_step
    B, C = x.shape
    g = x.reshape(B, 1, 1, C)
    for k, (norm, folded, bias) in enumerate(steps):
        g = step(g, norm, folded, bias, eps,
                 final if k == len(steps) - 1 else None)
    return g


mask_head.launches = 0
