"""R1, the CRN's 2x resampling (``csrc/resample.cu``): its least time for
a unit's images, the bytes it must move over the card's memory rate.  The
layout pyramid's level 0 (gconv_dim + layout_noise_dim channels at the
image's size) is read once and its pooled levels 1 .. stages - 1 written
once; each stage whose feats are coarser than its layout level and fill
whole 16-byte vectors (every stage but the first, whose feats are one
channel) has its coarse feats read once and their 2x upsample written
once, 5 times the coarse bytes; 2 bytes an element in bf16, 4 in float32
(``sg2im_tpu_torch/utils/roofline.py``'s ``crn_resample_bytes``, frozen
here).  Modes it does not describe ('phase', whose feats are never
upsampled, 'packed', the int8 tier) give None."""

from benchmark.harness import peaks

NAME = "crn_resample_kernel"
# The CRN modes whose forward takes the pyramid and every upsample.
MODES = ("legacy", "split", "split_noise")
ELEM = {"bfloat16": 2, "float32": 4}


def _stages(cfg):
    """(the upsampled stages' (channels, coarse side shift) list, the
    element size), or None for a mode this file does not describe."""
    s = cfg["serving"]
    if (s["crn_mode"] not in MODES or s.get("quantize")
            or s["compute_dtype"] not in ELEM):
        return None
    elem = ELEM[s["compute_dtype"]]
    dims = cfg["model"]["refinement_dims"]
    n = len(dims)
    return [(dims[i - 1], n - i) for i in range(1, n)
            if dims[i - 1] * elem % 16 == 0], elem


def LAUNCHES(cfg):
    """The kernel's launches a forward: one a pyramid ('split_noise' pools
    the layout and the noise apart) and one an upsampled stage."""
    stages = _stages(cfg)
    if stages is None:
        return None
    pyramids = 2 if (cfg["serving"]["crn_mode"] == "split_noise"
                     and cfg["model"]["layout_noise_dim"] > 0) else 1
    return pyramids + len(stages[0])


def bound_s(unit, cfg):
    stages = _stages(cfg)
    if "images" not in unit or stages is None:
        return None
    ups, elem = stages
    m = cfg["model"]
    H, W = m["image_size"]
    N, n = unit["images"], len(m["refinement_dims"])
    D = m["gconv_dim"] + m["layout_noise_dim"]
    nbytes = elem * N * D * H * W
    for level in range(1, n):
        nbytes += elem * N * D * (H >> level) * (W >> level)
    for C, k in ups:
        nbytes += 5 * elem * N * C * (H >> k) * (W >> k)
    return nbytes / peaks.HBM_BYTES
