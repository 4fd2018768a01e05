"""M1, the eval mask head (``csrc/mask_head.cu``): its least time for a
unit's real object slots, the larger of the phase form's float32
operations at the float32 peak and the bytes it must move at the card's
memory rate.  Per slot of C channels to M x M masks: the first step's four
matrix-vector products (2 x 4 C^2), each later step from side S four
phases of four taps on the coarse grid (2 x 16 C^2 S^2), the 1x1 conv
(2 C M^2); the bytes are the slots' vectors in and masks out and, per
step, the folded weights and the step's vectors
(``sg2im_tpu_torch/utils/roofline.py``'s ``mask_head_flops`` and
``mask_head_bytes``, frozen here).  The kernel computes every slot, padded
ones too, so against this bound it reads low by the share of padded
slots.  A configuration without a mask head gives None."""

from benchmark.harness import peaks

NAME = "mask_head_kernel"


def LAUNCHES(cfg):
    """The kernel's launches a forward: one a doubling step, log2 of
    ``mask_size``."""
    return cfg["model"]["mask_size"].bit_length() - 1


def bound_s(unit, cfg):
    m = cfg["model"]
    M = m.get("mask_size")
    if "objects" not in unit or not M:
        return None
    C, slots = m["gconv_dim"], unit["objects"]
    ops, side = 8 * C * C, 2
    while side < M:
        ops += 32 * C * C * side * side
        side *= 2
    flops = slots * (ops + 2 * C * M * M)
    nbytes = 4 * (slots * (C + M * M) + LAUNCHES(cfg) * (16 * C * C + 5 * C)
                  + C + 1)
    return max(flops / peaks.PEAKS["f32"], nbytes / peaks.HBM_BYTES)
