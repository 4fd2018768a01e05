"""T2, the threefry key split (``csrc/threefry.cu``): its least time for a
unit's splits of a key into two (16 bytes written each)."""

from benchmark.harness import peaks

NAME = "threefry_split_kernel"


def bound_s(unit, cfg):
    if "splits" not in unit:
        return None
    return unit["splits"] * peaks.threefry_bound_s(2, 16, "split")
