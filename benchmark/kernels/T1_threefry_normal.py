"""T1, the threefry normal draw (``csrc/threefry.cu``): its least time for a
unit's float32 layout noise (``harness.peaks.threefry_bound_s``)."""

from benchmark.harness import peaks

NAME = "threefry_normal_kernel"


def bound_s(unit, cfg):
    if "noise_values" not in unit:
        return None
    v = unit["noise_values"]
    return peaks.threefry_bound_s(v, 4 * v, "f32")
