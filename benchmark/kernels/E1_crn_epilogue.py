"""E1, the CRN's post-convolution chain (``csrc/crn_epilogue.cu``): its
least time for a unit's images, the bytes it must move over the card's
memory rate.  At each CRN stage s (C_s channels at H / 2^(stages - 1 - s)
a side) conv0's bf16 addends are read and its bf16 output written, 2
(addends + 1) bytes an element, and conv1's, 4 bytes; at the head the bf16
input is read and the float32 output written, 6 bytes an element
(``sg2im_tpu_torch/utils/roofline.py``'s ``crn_epilogue_bytes``, frozen
here).  Configurations that never take the kernel (float32, 'packed') give
None."""

from benchmark.harness import peaks

NAME = "crn_epilogue_kernel"
# conv0's addends by CRN mode.
ADDENDS = {"legacy": 1, "split": 2, "phase": 2, "split_noise": 3}


def bound_s(unit, cfg):
    s = cfg["serving"]
    if ("images" not in unit or s["compute_dtype"] != "bfloat16"
            or s["crn_mode"] not in ADDENDS):
        return None
    m = cfg["model"]
    H, W = m["image_size"]
    dims = m["refinement_dims"]
    n, N = len(dims), unit["images"]
    nbytes = 6 * N * dims[-1] * H * W
    for i, C in enumerate(dims):
        elems = N * C * (H >> (n - 1 - i)) * (W >> (n - 1 - i))
        nbytes += (2 * (ADDENDS[s["crn_mode"]] + 1) + 4) * elems
    return nbytes / peaks.HBM_BYTES
