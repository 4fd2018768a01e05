"""The yardstick's numbers: one H100 SXM's published peaks and the closed
forms of the hand kernels' least work, frozen copies of
``sg2im_tpu_torch/utils/roofline.py``'s (``layout_bounds``,
``THREEFRY_OPS``, ``threefry_bounds``), and FLOPs counted on the
benchmark's own reference, so that a count reads the same work whatever
implements it."""

from __future__ import annotations

import contextlib

from torch.utils.flop_counter import FlopCounterMode

# NVIDIA's data sheet, H100 SXM at 700 W, dense: bytes/s of device memory,
# bf16 tensor FLOP/s, float32 FLOP/s outside the tensor cores (the rate of
# a float32 matmul or convolution with TF32 off).
HBM_BYTES = 3.35e12
PEAKS = {"bf16": 989e12, "f32": 67e12}
# Issue width and integer ALU lanes of a Hopper SM; SMs and boost clock of
# the H100 SXM.
ISSUE_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64
SMS = 132
CLOCK_HZ = 1.98e9
# The least instructions one threefry value needs (all, and on the integer
# ALU): a float32 normal, a split key.
THREEFRY_OPS = {"f32": (68 + 15, 21), "split": (66, 20)}


def layout_bound_s(objects: int, images: int, M: int, H: int, W: int,
                   D: int, out_elem: int) -> float:
    """Least seconds of a layout compose of ``objects`` real objects into
    ``images`` layouts: the boxes, masks and vectors read once in float32
    and the layout written once (``out_elem`` bytes an element), or the
    float32 operations of the warp and the weighted sum at the f32 peak,
    whichever is larger."""
    nbytes = 4 * objects * (M * M + D + 4) + out_elem * images * H * W * D
    ops = 2 * objects * (H * M * M + H * W * M) + 2 * objects * H * W * D
    return max(nbytes / HBM_BYTES, ops / PEAKS["f32"])


def threefry_bound_s(values: int, out_bytes: int, kind: str) -> float:
    """Least seconds of a threefry draw: its output written once, or its
    instructions issued on every SM at the boost clock, or its integer
    ALU work, whichever is larger."""
    instructions, alu = THREEFRY_OPS[kind]
    t_ops = values * max(instructions / ISSUE_LANES_PER_SM,
                         alu / INT32_LANES_PER_SM) / (SMS * CLOCK_HZ)
    return max(out_bytes / HBM_BYTES, t_ops)


class FlopCount:
    """FLOPs of matmuls and convolutions (forward and backward), by the
    peak each is held to: ``section(kind)`` counts the work inside it as
    ``kind`` ('f32' or 'bf16')."""

    def __init__(self):
        self.by_type: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, kind: str):
        counter = FlopCounterMode(display=False)
        with counter:
            yield
        self.by_type[kind] = (self.by_type.get(kind, 0)
                              + int(counter.get_total_flops()))

    def seconds_at_peak(self) -> float:
        return sum(v / PEAKS[k] for k, v in self.by_type.items())
