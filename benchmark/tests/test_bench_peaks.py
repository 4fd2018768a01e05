"""The yardstick's frozen arithmetic equals the port's
``utils/roofline.py`` on today's tree."""

import pytest

from benchmark.harness import peaks


def test_peaks_equal_the_ports():
    from sg2im_tpu_torch.utils import roofline

    assert peaks.HBM_BYTES == roofline.HBM_BYTES
    assert peaks.PEAKS == {"bf16": roofline.BF16_FLOPS,
                           "f32": roofline.F32_FLOPS}
    assert peaks.ISSUE_LANES_PER_SM == roofline.ISSUE_LANES_PER_SM
    assert peaks.INT32_LANES_PER_SM == roofline.INT32_LANES_PER_SM
    for kind in ("f32", "split"):
        assert peaks.THREEFRY_OPS[kind] == tuple(roofline.THREEFRY_OPS[kind])


@pytest.mark.parametrize("shape", [(128, 16, 16, 128, 128, 128),
                                   (32, 16, 16, 64, 64, 128), (2, 3, 8, 9, 7, 5)])
@pytest.mark.parametrize("out_elem", [2, 4])
def test_layout_bound_equals_the_ports(shape, out_elem):
    from sg2im_tpu_torch.utils import roofline

    N, O, M, H, W, D = shape
    nbytes, ops = roofline.layout_bounds(N, O, M, H, W, D, weights=False,
                                         out_elem=out_elem)
    want = max(nbytes / roofline.HBM_BYTES, ops / roofline.F32_FLOPS)
    assert peaks.layout_bound_s(N * O, N, M, H, W, D, out_elem) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("values", [2, 4096, 128 * 128 * 128 * 32])
@pytest.mark.parametrize("kind", ["f32", "split"])
def test_threefry_bound_equals_the_ports(values, kind):
    from sg2im_tpu_torch.utils import roofline

    out = 4 * values if kind == "f32" else 16
    ms, _ = roofline.threefry_bounds(values, out, roofline.THREEFRY_OPS[kind],
                                     peaks.SMS, peaks.CLOCK_HZ)
    assert peaks.threefry_bound_s(values, out, kind) * 1e3 == \
        pytest.approx(ms, rel=1e-12)
