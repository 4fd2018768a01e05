"""K1, the layout compose (``csrc/layout_compose.cu``): its least time for
a unit's real objects and images (``harness.peaks.layout_bound_s``)."""

from benchmark.harness import peaks

NAME = "compose_boxes_kernel"


def bound_s(unit, cfg):
    if "objects" not in unit:
        return None
    m = cfg["model"]
    H, W = m["image_size"]
    return peaks.layout_bound_s(unit["objects"], unit["images"],
                                m["mask_size"], H, W, m["gconv_dim"],
                                unit["layout_elem"])
