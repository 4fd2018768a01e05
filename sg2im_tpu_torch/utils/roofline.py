"""The card's roofline: published peaks, the closed-form bounds of the hand
kernels, FLOP counting and per-section rows.

One source for ``chip_smoke.py`` and the measurement tools
(``sg2im_tpu_torch.tools``).  XLA's cost model gave the JAX package each
section's operations and bytes; PyTorch has none, so here

* **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode``'s
  formulas for the work that passes through the dispatcher (cuDNN
  convolutions, cuBLAS matmuls, their backward), kept apart by the type
  whose peak each runs at (:data:`TYPE_PEAKS`), plus, per launch, the
  closed form of a hand kernel, which the dispatcher does not see
  (:class:`FlopCounter`'s ``per_launch``: the tools give K1's, the only
  hand kernel with operations on a counted section; K3 has none).  On the
  CPU a wrapper runs its kernel's plain version, whose matmuls the
  dispatcher counts as the closed form, so a forward counts the same on
  either device.  K1's backward recomputes its forward in plain PyTorch
  before the vector-Jacobian product, on the card as in the JAX
  package's ``custom_vjp``, and both are counted; autograd of the CPU's
  plain path has no recompute.  Elementwise work, norms and reductions
  count 0 operations.  A 'same' convolution counts its padded taps
  (2 N H W Cin Co k^2), where XLA's ``cost_analysis()`` leaves them out
  (17.33 against 18.87 MFLOP for a 3x3 conv at 2x16x16x32 -> 64); a
  matmul counts the same in both;
* **bytes** are a lower bound (:func:`tensor_bytes`): the section's inputs,
  parameters and outputs, each read or written once, as
  ``memory_analysis()`` gave the JAX package's train-step roofline.

:func:`section_row` turns (ms, FLOPs by type, bytes) into a row with the
keys of a ``PERF.json`` row beside the speed of light of
``scripts/roofline_train.py`` against both the data sheet's peaks and peaks
measured in the same run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# device memory bytes/s, bf16 tensor FLOP/s, int8 tensor OP/s, TF32 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BYTES = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# The peak of each operation type FlopCounter keeps apart.
TYPE_PEAKS = {"bf16": BF16_FLOPS, "int8": INT8_OPS, "tf32": TF32_FLOPS,
              "f32": F32_FLOPS}

_ELEM_SIZE = {"bfloat16": 2, "float32": 4, "int8": 1}


def roofline_ms(nbytes, ops, peak):
    """The least time for moving ``nbytes`` and doing ``ops`` at ``peak``
    per second: (ms, "bytes" or "operations", whichever bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def layout_bounds(N, O, M, H, W, D, weights, out_elem=4):
    """(bytes, f32 operations) of one layout compose: boxes (or the warp
    weights Wy, Wx), masks and vecs read once in f32, the layout written
    once in elements of ``out_elem`` bytes (4 for f32, 2 for bf16); per
    object the coefficients Wy . mask . Wx^T, then their sum of the object
    vectors."""
    inputs = N * O * (M * M + D) + (N * O * (H + W) * M if weights
                                    else N * O * 4)
    nbytes = 4 * inputs + out_elem * N * H * W * D
    ops = 2 * N * O * (H * M * M + H * W * M) + 2 * N * O * H * W * D
    return nbytes, ops


def relayout_bounds(cases):
    """{entry: (bound ms, bound by)} of K3 summed over ``cases``, each
    (entry, NCHW shape, dtype name, ...): each tensor read once and
    written once."""
    out = {}
    for entry, shape, dtype, *_ in cases:
        nbytes = 2 * _ELEM_SIZE[dtype] * int(np.prod(shape))
        out[entry] = out.get(entry, 0.0) + roofline_ms(nbytes, 0, 1.0)[0]
    return {entry: (ms, "bytes") for entry, ms in out.items()}


# Addends of a CRN stage's conv0 epilogue by conv0 mode ('split_noise' is
# 'split' with the noise's convolution apart).
CONV0_ADDENDS = {"legacy": 1, "split": 2, "phase": 2, "split_noise": 3}


def crn_epilogue_bytes(N, H, W, dims, conv0_addends):
    """Bytes the CRN's fused post-convolution chains of one bf16 forward
    must move (``csrc/crn_epilogue.cu``): at each stage s of C_s channels
    at H_s x W_s (H / 2^(stages - 1 - s)), conv0's ``conv0_addends`` bf16
    addends read and the bf16 output written, 2 (addends + 1) bytes an
    element, and conv1's one addend, 4 bytes; the head's bf16 input read
    and float32 output written at the last width, 6 bytes an element."""
    n = len(dims)
    nbytes = 0
    for s, C in enumerate(dims):
        elems = N * C * (H >> (n - 1 - s)) * (W >> (n - 1 - s))
        nbytes += 2 * (conv0_addends + 1) * elems + 4 * elems
    return nbytes + 6 * N * dims[-1] * H * W


def crn_resample_bytes(N, H, W, dims, layout_dim, elem):
    """Bytes the CRN's 2x resampling of one forward must move
    (``csrc/resample.cu``), in ``elem``-byte elements: the layout pyramid's
    level 0 (``layout_dim`` channels at H x W) read once and its pooled
    levels 1 .. stages - 1 written once; and each stage whose feats
    (``dims[s - 1]`` channels at H_s / 2 x W_s / 2) are coarser than its
    layout level and fill whole 16-byte vectors, their coarse read and
    their 2x upsample written, 5 times the coarse bytes.  The first
    stage's one-channel feats fill no vector."""
    n = len(dims)
    nbytes = elem * N * layout_dim * H * W
    for level in range(1, n):
        nbytes += elem * N * layout_dim * (H >> level) * (W >> level)
    for s in range(1, n):
        C = dims[s - 1]
        if C * elem % 16 == 0:
            nbytes += 5 * elem * N * C * (H >> (n - s)) * (W >> (n - s))
    return nbytes


def mask_head_flops(slots, C, M):
    """Float32 operations of the eval mask head in the phase form
    (``csrc/mask_head.cu``) over ``slots`` object slots of C channels to
    M x M masks: a slot's first step is four matrix-vector products of the
    summed taps (2 x 4 C^2), each later step from side S four phases of
    four taps on the coarse grid (2 x 16 C^2 S^2, off-grid taps counted),
    then the 1x1 conv (2 C M^2)."""
    ops, side = 8 * C * C, 2
    while side < M:
        ops += 32 * C * C * side * side
        side *= 2
    return slots * (ops + 2 * C * M * M)


def mask_head_bytes(slots, C, M):
    """Bytes the eval mask head must move: the slots' float32 vectors read
    and their masks written once, and per step the folded weights (16 C^2),
    the conv's bias and the BatchNorm's four vectors, then the 1x1 conv."""
    steps = M.bit_length() - 1
    return 4 * (slots * (C + M * M) + steps * (16 * C * C + 5 * C) + C + 1)


def conv_bounds(N, H, W, Cin, Co, elem_size):
    """(bytes, operations) of one 3x3 conv: x and the weight read once, the
    f32 output written once (the scale / bias / dq vectors are noise)."""
    nbytes = N * H * W * Cin * elem_size + 9 * Cin * Co * elem_size \
        + N * H * W * Co * 4
    return nbytes, 2 * N * H * W * 9 * Cin * Co


# Hopper's 32-bit integer ALU lanes per SM (16 in each of its 4
# sub-partitions), and the thread instructions an SM issues a clock (one
# warp instruction in each sub-partition).
INT32_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
# SASS opcodes (before the first '.') that run on the integer pipes.
INT_OPCODES = frozenset((
    "IADD3", "IADD", "IMAD", "LEA", "LOP3", "LOP", "SHF", "SHL", "SHR",
    "ISETP", "IMNMX", "IABS", "SEL", "PRMT", "POPC", "FLO", "BREV", "BMSK",
    "SGXT", "IDP", "I2I", "I2IP", "VIADD", "VIMNMX"))


def sass_mix(sass: str, function_part: str) -> dict:
    """{opcode: count} of the SASS functions whose (mangled) name holds
    ``function_part``, from ``cuobjdump -sass`` output; opcodes without
    their modifiers (``IADD3.X`` counts as ``IADD3``), predicates
    dropped.  Summed over every matching function."""
    import re

    mix: dict[str, int] = {}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function_part in line.split("Function :", 1)[1]
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            op = m.group(1).split(".")[0]
            mix[op] = mix.get(op, 0) + 1
    return mix


class ThreefryOps(NamedTuple):
    """The least instructions one threefry value needs on this ISA: all of
    them (each takes an issue slot) and those that only the integer ALU
    can run."""
    instructions: float
    alu: float


# The least that one threefry value needs on Hopper's ISA, whatever the
# kernel.  The threefry2x32-20 hash: 20 rounds of an add, a rotate (one
# funnel shift, SHF.L.W) and an xor (LOP3): 60; the key's adds: the
# counter's hi word plus k0 is the same for 2^32 values and k1 folds into
# the counter's own add, the first four x0 injections fold into the next
# round's add (IADD3 takes three operands), the fifth does not, and each
# x1 injection is its own add (the next round rotates it): 6; the output
# words' xor: 1.  The uniform's mantissa: float32's (b >> 9) | 0x3F800000
# is one funnel shift of (0x7F : b); bfloat16's as float32 bits,
# ((b & 0xFE) << 15) | 0x3F800000, an and and a multiply-add: 68 and 69
# integer instructions.  Float, on every value (the central polynomial;
# the tail's extra work, the compare, the branch, counters, addresses and
# stores are not counted): x * -x, log1p (one MUFU.LG2 at least), w - 2.5,
# 8 Horner FMAs and the product with x, 12 in float32; the uniform's
# f - 1 and its fused affine map and the product with sqrt(2), 3 in
# float32, 1.5 in bfloat16 (two values share a packed instruction) plus
# half a packed rounding to bfloat16: 15 and 14.  Only the xors (20 in
# the rounds, 1 at the end) are bound to the ALU: an add runs as an IMAD
# on the FMA pipe, a rotate as two (the low and high words of x * 2^r),
# and a shift-or as one IMAD.HI.  split(key) writes a key a hash, without
# the final xor and with no uniform: 66 and 20.  The parameter init's
# uniform (float32): the hash, the xor and the mantissa (68), then f - 1,
# the fused affine map, the max with minval and the product with the
# scale (4): 72, 21 on the ALU.
THREEFRY_OPS = {"f32": ThreefryOps(68 + 15, 21),
                "bf16": ThreefryOps(69 + 14, 21),
                "split": ThreefryOps(66, 20),
                "uniform": ThreefryOps(68 + 4, 21)}


def threefry_bounds(values: int, out_bytes: int, ops: ThreefryOps,
                    sms: int, clock_hz: float):
    """(bound ms, "bytes" or "operations") of one threefry draw of
    ``values`` values: the larger of its output's ``out_bytes`` written
    once at the card's memory rate, the ``ops.instructions`` a value
    issued on ``sms`` SMs at ``clock_hz``, and the ``ops.alu`` a value on
    their integer ALU lanes (:data:`THREEFRY_OPS`, the least this ISA
    needs)."""
    t_bytes = out_bytes / HBM_BYTES
    t_ops = values * max(ops.instructions / ISSUE_LANES_PER_SM,
                         ops.alu / INT32_LANES_PER_SM) / (sms * clock_hz)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _op_type(func_packet, args) -> str:
    """The peak an operation is held to, from its first tensor argument's
    type: 'bf16' (bf16 and f16), 'int8', or for float32 'tf32' where the
    backend may round it to TF32 (cuDNN's flag for convolutions, the
    matmul flag for the rest) and 'f32' otherwise.  float64 (only the
    CPU's plain int8 conv) counts as 'f32'."""
    t = next((a for a in args if isinstance(a, torch.Tensor)), None)
    dtype = torch.float32 if t is None else t.dtype
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.int8:
        return "int8"
    if dtype == torch.float32:
        tf32 = (torch.backends.cudnn.allow_tf32
                if "convolution" in str(func_packet)
                else torch.backends.cuda.matmul.allow_tf32)
        if tf32:
            return "tf32"
    return "f32"


class FlopCounter(FlopCounterMode):
    """Operations of the work inside the block, by the type whose peak they
    are held to (:data:`TYPE_PEAKS`): ``FlopCounterMode``'s formulas for
    the dispatcher's matmuls and convolutions, and per launch of a hand
    kernel the closed form the caller gives for it.

        with FlopCounter({layout_compose: (ops, "f32")}) as fc:
            section()
        fc.by_type   # {"bf16": ..., "f32": ...}
        fc.kernels   # {"layout_compose": launches x ops}

    ``per_launch`` maps a kernel's wrapper (its ``launches`` count) to
    (operations of one launch, type).  A wrapper on the CPU runs its
    plain version instead, which the dispatcher counts: each plain version
    does its kernel's closed form in matmuls and convolutions, so a
    forward counts the same on either device.
    """

    def __init__(self, per_launch: dict | None = None):
        super().__init__(display=False)
        self._per_launch = dict(per_launch or {})
        self.by_type: dict[str, int] = {}
        self.kernels: dict[str, int] = {}

    def _add(self, kind: str, ops: int) -> None:
        self.by_type[kind] = self.by_type.get(kind, 0) + int(ops)

    def _count_flops(self, func_packet, out, args, kwargs):
        # FlopCounterMode's hook for each operation it dispatches; its own
        # per-module totals are not kept.
        formula = self.flop_registry.get(func_packet)
        if formula is not None:
            self._add(_op_type(func_packet, args),
                      formula(*args, **kwargs, out_val=out))
        return out

    def __enter__(self):
        self._before = {w: w.launches for w in self._per_launch}
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for w, (ops, kind) in self._per_launch.items():
            n = w.launches - self._before[w]
            if n:
                self.kernels[w.__name__] = n * int(ops)
                self._add(kind, n * int(ops))
        return out

    @property
    def total(self) -> int:
        return sum(self.by_type.values())


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (tensors, modules, dicts, lists,
    tuples, dataclass-like objects with ``__dict__``), each storage region
    counted once."""
    seen, total = set(), 0

    def visit(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            n = x.numel() * x.element_size()
            key = (x.data_ptr(), n) if n else (id(x), 0)
            if key not in seen:
                seen.add(key)
                total += n
        elif isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                visit(t)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            for v in vars(x).values():
                visit(v)

    for tree in trees:
        visit(tree)
    return total


def peaks(measured: dict | None = None) -> dict:
    """The peaks a section is held to: the data sheet's rate of each
    operation type and its memory rate, with the run's measured rates
    beside them (``measured``: ``tools._measure.measured_peaks``' dict, or
    None)."""
    out = {"sheet": {"flops": dict(TYPE_PEAKS), "bytes": HBM_BYTES},
           "measured": None}
    if measured:
        out["measured"] = {
            "flops": {"bf16": measured["bf16_matmul_flops"],
                      "f32": measured["f32_matmul_flops"]},
            "bytes": measured["scale_add_bytes"]}
    return out


def section_row(name: str, ms: float, flops: dict, min_bytes: float,
                peaks: dict) -> dict:
    """One section's row.  ``flops``: {operation type: operations}, as
    :class:`FlopCounter` gives them.  ``PERF.json``'s keys: section, ms,
    gflops, mbytes (``min_bytes`` / 1e6), tflops_s, gb_s, pct_mxu_peak
    (the time the section's operations take at their types' peaks, each
    type at its own, as a share of ms), pct_hbm_peak and bound ('mxu' or
    'hbm', whichever share is larger), against the data sheet; then
    ``scripts/roofline_train.py``'s speed of light, sol_ms = max(sum over
    types of flops / its peak, bytes / bytes peak), pct_sol = 100 sol_ms /
    ms and headroom_x = ms / sol_ms; and the same shares and speed of
    light against the run's measured peaks under ``*_measured`` keys (None
    when none were measured, or not for every type the section has)."""
    s = ms / 1e3
    total = sum(flops.values())
    row = {"section": name, "ms": ms, "gflops": total / 1e9,
           "gflops_by_type": {k: v / 1e9 for k, v in flops.items()},
           "mbytes": min_bytes / 1e6,
           "tflops_s": total / s / 1e12 if s > 0 else None,
           "gb_s": min_bytes / s / 1e9 if s > 0 else None}
    for tag, pk in (("", peaks["sheet"]),
                    ("_measured", peaks.get("measured"))):
        if not pk or s <= 0 or any(k not in pk["flops"]
                                   for k, v in flops.items() if v):
            for k in ("pct_mxu_peak", "pct_hbm_peak", "sol_ms", "pct_sol",
                      "headroom_x"):
                row[k + tag] = None
            continue
        t_ops = sum(v / pk["flops"][k] for k, v in flops.items() if v)
        t_bytes = min_bytes / pk["bytes"]
        sol = max(t_ops, t_bytes) * 1e3
        row["pct_mxu_peak" + tag] = 100 * t_ops / s
        row["pct_hbm_peak" + tag] = 100 * t_bytes / s
        row["sol_ms" + tag] = sol
        row["pct_sol" + tag] = 100 * sol / ms
        row["headroom_x" + tag] = ms / sol if sol > 0 else math.inf
        if not tag:
            row["bound"] = "mxu" if t_ops >= t_bytes else "hbm"
    row.setdefault("bound", None)
    return row


def max_share(row: dict, tag: str = "") -> float:
    """The largest share of a peak or of the speed of light in ``row``, in
    percent: against the data sheet (``tag`` ""), which a physical reading
    cannot pass, or against the run's measured peaks ("_measured")."""
    vals = [row.get(k + tag) for k in ("pct_mxu_peak", "pct_hbm_peak",
                                       "pct_sol")]
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else 0.0
