"""E1's frozen arithmetic (``kernels/E1_crn_epilogue.py``) equals the
port's ``utils/roofline.py`` on today's tree, and ``crn_fused_pct.gen``
reads the kernel's launches per forward."""

import pytest

from benchmark.harness import files, peaks


def _e1():
    return files.load_file(files.BENCH_DIR / "kernels" / "E1_crn_epilogue.py")


@pytest.mark.parametrize("config", ["vg128", "coco64"])
@pytest.mark.parametrize("mode", ["legacy", "split", "phase", "split_noise"])
@pytest.mark.parametrize("images", [1, 128])
def test_e1_bound_equals_the_ports(config, mode, images):
    from sg2im_tpu_torch.utils import roofline

    cfg = files.config(files.benchmark(), config)
    cfg = dict(cfg, serving=dict(cfg["serving"], crn_mode=mode))
    m = cfg["model"]
    H, W = m["image_size"]
    nbytes = roofline.crn_epilogue_bytes(images, H, W,
                                         tuple(m["refinement_dims"]),
                                         roofline.CONV0_ADDENDS[mode])
    assert peaks.HBM_BYTES == roofline.HBM_BYTES
    assert _e1().bound_s({"images": images}, cfg) == pytest.approx(
        nbytes / roofline.HBM_BYTES, rel=1e-12)


@pytest.mark.parametrize("serving", [{"compute_dtype": "float32",
                                      "crn_mode": "split"},
                                     {"compute_dtype": "bfloat16",
                                      "crn_mode": "packed"}])
def test_e1_has_no_bound_where_the_kernel_never_runs(serving):
    cfg = dict(files.config(files.benchmark(), "vg128"), serving=serving)
    assert _e1().bound_s({"images": 128}, cfg) is None


class _Record:
    def __init__(self, kernels, units, cfg):
        self.slice = type("S", (), {"kernels": kernels, "units": units})()
        self.cfg, self.bench_dir = cfg, files.BENCH_DIR


@pytest.mark.parametrize("per_forward", [0, 5, 11])
def test_crn_fused_pct_counts_launches_per_forward(per_forward):
    cfg = files.config(files.benchmark(), "coco64")
    kernels = ([(f"void {_e1().NAME}<1, 8, true, false>", 1e-6)]
               * (3 * per_forward) + [("elementwise_kernel", 1e-6)] * 40)
    got = files.reader("crn_fused_pct.gen")(
        _Record(kernels, [{"images": 128}] * 3, cfg))
    assert got == pytest.approx(100.0 * per_forward / 11)
