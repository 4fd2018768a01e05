"""The CRN's 2x resampling, R1 (ops/resample.py): its plain versions
against aten's calls, the rule that chooses the kernel, the CRN's calls to
it, its launch plans and a walk of its pyramid emulated on the CPU, and
the benchmark's bound and engagement metric of the kernel.

The kernel itself runs only on a card: the ``cuda``-marked tests here
compare it with aten at the benchmark's b128 shapes and run CRN forwards
with it and without it.  On the CPU the dispatch is driven by taking the
CPU for the kernel's device and watching the calls made to the wrappers,
which on the CPU compute the plain versions.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import files, peaks
from sg2im_tpu_torch.nn import crn as tcrn
from sg2im_tpu_torch.nn import layers
from sg2im_tpu_torch.ops import resample as rs
from sg2im_tpu_torch.utils import roofline

BF16 = torch.bfloat16
DTYPES = {"bf16": BF16, "f32": torch.float32}
# (N, C, H, W): channels filling whole vectors in both types.
SHAPES = {"N2 C16 16x16": (2, 16, 16, 16), "N3 C24 8x24": (3, 24, 8, 24)}


def _x(shape, dtype, seed=0, channels_last=True):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=g)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last \
        else x


# --- the plain versions -------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_plain_versions_are_atens_calls(dtype, shape):
    x = _x(SHAPES[shape], DTYPES[dtype])
    levels = 3
    want, level = [], x
    for _ in range(levels):
        level = F.avg_pool2d(level, 2)
        want.append(level)
    got = rs.pool_pyramid_ref(x, levels)
    assert len(got) == levels
    assert all(g.dtype == x.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    assert torch.equal(rs.upsample2_ref(x), up)
    # On the CPU the wrappers are the plain versions.
    before = rs.launches
    assert all(torch.equal(g, w)
               for g, w in zip(rs.pool_pyramid(x, levels), want))
    assert torch.equal(rs.upsample2(x), up)
    assert rs.launches == before


def _emulate_pyramid(x, levels):
    """The pyramid kernel's walk on the CPU: each thread's 2^levels tile
    of one vector in Z order, a 4x4 block a load (2x2 at one level),
    float32 sums from 0 in window order, / 4, rounded to x's type, each
    value stored once.  -> the levels, and how often each element was
    stored."""
    N, C, H, W = x.shape
    plan = rs.pool_plan(N, H, W, C * x.element_size() // 16, levels,
                        x.dtype == torch.float32)
    per = 16 // x.element_size()
    src = x.permute(0, 2, 3, 1).float().numpy()
    outs = [np.zeros((N, H >> l, W >> l, C), np.float32)
            for l in range(1, levels + 1)]
    stores = [np.zeros(o.shape, np.int64) for o in outs]

    def rounded(v):
        return torch.from_numpy(v).to(x.dtype).float().numpy()

    def store(l, y, xx, c0, v):
        outs[l - 1][n, y, xx, c0:c0 + per] = v
        stores[l - 1][n, y, xx, c0:c0 + per] += 1

    def mean(vals):
        s = np.zeros(per, np.float32)
        for v in vals:
            s = (s + v).astype(np.float32)
        return rounded((s / np.float32(4)).astype(np.float32))

    def zorder(p, bits):
        return (sum(((p >> (2 * d + 1)) & 1) << d for d in range(bits)),
                sum(((p >> (2 * d)) & 1) << d for d in range(bits)))

    blk = min(2, levels)
    tiles_h, tiles_w = H >> levels, W >> levels
    for t in range(plan.tasks):
        v, r = t % plan.vecs, t // plan.vecs
        tx, r = r % tiles_w, r // tiles_w
        ty, n = r % tiles_h, r // tiles_h
        c0 = v * per
        acc = [[] for _ in range(levels - blk)]
        for q in range(1 << (2 * (levels - blk))):
            qy, qx = zorder(q, levels - blk)
            y0, x0 = (ty << levels) + (qy << blk), (tx << levels) + (qx << blk)
            # The block: its level-1 windows, then (block 2) level 2.
            l1 = []
            for k in range(1 << (2 * (blk - 1))):
                wy, wx = zorder(4 * k, blk)
                vals = [src[n, y0 + wy + i, x0 + wx + j, c0:c0 + per]
                        for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
                l1.append(mean(vals))
                store(1, (y0 + wy) >> 1, (x0 + wx) >> 1, c0, l1[-1])
            val = l1[0]
            if blk == 2:
                val = mean(l1)
                store(2, y0 >> 2, x0 >> 2, c0, val)
            for d in range(levels - blk):
                acc[d].append(val)
                if (q >> (2 * d)) & 3 != 3:
                    break
                val, acc[d] = mean(acc[d]), []
                l = blk + d + 1
                store(l, y0 >> l, x0 >> l, c0, val)
    return outs, stores


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_pyramid_walk_stores_each_level_once_bit_equal(dtype, levels):
    x = _x((2, 16, 16, 8), DTYPES[dtype], seed=levels)
    outs, stores = _emulate_pyramid(x, levels)
    for got, n, want in zip(outs, stores, rs.pool_pyramid_ref(x, levels)):
        assert (n == 1).all()
        assert np.array_equal(got, want.permute(0, 2, 3, 1).float().numpy())


@pytest.mark.parametrize("shape", [(2, 16, 3, 5), (1, 8, 4, 4)])
def test_the_upsample_walk_stores_each_fine_vector_once(shape):
    """The upsample kernel's index arithmetic, emulated: unit u of the
    coarse tensor (vectors in NHWC order) goes to its four fine pixels,
    and every fine vector is written once."""
    N, C, H, W = shape
    vecs = C * 2 // 16
    p = rs.up_plan(N, H, W, vecs)
    coarse = np.arange(p.units).reshape(N, H, W, vecs)
    fine = np.full((N * 2 * H * 2 * W * vecs,), -1)
    for u in range(p.units):
        row, t = divmod(u, p.row_units)
        x = t // p.vecs
        o = 4 * row * p.row_units + t + x * p.vecs
        for off in (0, p.vecs, 2 * p.row_units, 2 * p.row_units + p.vecs):
            assert fine[o + off] == -1
            fine[o + off] = u
    want = coarse.repeat(2, axis=1).repeat(2, axis=2).reshape(-1)
    assert np.array_equal(fine, want)
    assert p.grid * p.threads >= p.units


def test_the_plan_structs_are_the_c_structs():
    # An int64 and 7 int32: 36 bytes, padded to 40; an int64 and 4 int32.
    assert ctypes.sizeof(rs.PoolPlanStruct) == 40
    assert rs.PoolPlanStruct.grid.offset == 32
    assert ctypes.sizeof(rs.UpPlanStruct) == 24
    assert rs.UpPlanStruct.grid.offset == 20


def test_the_plans_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="levels"):
        rs.pool_plan(2, 64, 64, 2, rs.MAX_LEVELS + 1, False)
    with pytest.raises(ValueError, match="halve"):
        rs.pool_plan(2, 24, 24, 2, 4, False)
    with pytest.raises(ValueError, match="index"):
        rs.up_plan(2 ** 16, 2 ** 8, 2 ** 8, 1)


# --- the rule and the CRN's calls ---------------------------------------

class Calls:
    """Counts the calls made to a wrapper, which then runs as it would."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args, **kwargs):
        self.n += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def on_the_cpu(monkeypatch):
    """The CPU taken for the kernel's device -> (the pyramid's calls, the
    upsample's calls)."""
    pool, up = Calls(rs.pool_pyramid), Calls(rs.upsample2)
    monkeypatch.setattr(rs, "RESAMPLE_DEVICE", "cpu")
    monkeypatch.setattr(rs, "pool_pyramid", pool)
    monkeypatch.setattr(rs, "upsample2", up)
    return SimpleNamespace(pool=pool, up=up)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_rule_takes_floating_whole_vectors_without_a_gradient(
        on_the_cpu, dtype, shape):
    x = _x(SHAPES[shape], DTYPES[dtype])
    assert rs.takes_kernel(x) and rs.pyramid_takes_kernel(x, 3)
    assert torch.equal(layers.upsample_nearest(x, 2),
                       F.interpolate(x, scale_factor=2, mode="nearest"))
    assert on_the_cpu.up.n == 1
    # Another factor, too many levels, sides that do not halve enough.
    layers.upsample_nearest(x, 4)
    assert on_the_cpu.up.n == 1
    assert not rs.pyramid_takes_kernel(x, rs.MAX_LEVELS + 1)
    assert not rs.pyramid_takes_kernel(x[:, :, :-1], 1)


def _cases(dtype, shape):
    x = _x(shape, dtype)
    N, C, H, W = shape
    grad = x.clone().requires_grad_(True)
    odd = _x((N, C + 1, H, W), dtype)
    return {"a CPU tensor": (x, "cuda"),
            "a recorded gradient": (grad, "cpu"),
            "int8": ((x.float().clamp(-127, 127)).to(torch.int8), "cpu"),
            "channels off a vector": (odd, "cpu")}


@pytest.mark.parametrize("case", ["a CPU tensor", "a recorded gradient",
                                  "int8", "channels off a vector"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_dispatch_keeps_the_eager_call(monkeypatch, dtype, shape,
                                           case):
    x, device = _cases(DTYPES[dtype], SHAPES[shape])[case]
    pool, up = Calls(rs.pool_pyramid), Calls(rs.upsample2)
    monkeypatch.setattr(rs, "RESAMPLE_DEVICE", device)
    monkeypatch.setattr(rs, "pool_pyramid", pool)
    monkeypatch.setattr(rs, "upsample2", up)
    assert not rs.takes_kernel(x) and not rs.pyramid_takes_kernel(x, 2)
    out = layers.upsample_nearest(x, 2)
    assert out.shape[2:] == (2 * x.shape[2], 2 * x.shape[3])
    assert up.n == 0 and pool.n == 0


DIMS = (16, 16, 8, 8)  # layout channels, then three stages
H = 16


def _network(mode="split", **kw):
    torch.manual_seed(5)
    net = tcrn.RefinementNetwork(DIMS, "batch", "leakyrelu-0.2",
                                 conv0_mode=mode, **kw).eval()
    return net.to(memory_format=torch.channels_last)


def _layout(noise_dim=0, seed=6):
    g = torch.Generator().manual_seed(seed)

    def t(c):
        return torch.randn(2, c, H, H, generator=g).contiguous(
            memory_format=torch.channels_last)

    if noise_dim:
        return t(DIMS[0] - noise_dim), t(noise_dim)
    return t(DIMS[0]), None


def _calibrated_int8():
    net = _network(quant="int8", quant_min_res=8)
    layout, _ = _layout()
    net.act_scales.values, net.act_scales.calibrating = {}, True
    with torch.no_grad():
        net(layout, BF16)
    net.act_scales.calibrating = False
    return net


# mode: (network, noise channels apart, pyramids, upsamples) of one eval
# bf16 forward.  Stage 0's one-channel feats fill no vector; 'phase'
# upsamples no feats; 'packed' runs its stages at resolution >= 8 packed,
# the first 'legacy'; the int8 tier's stages >= 8 quantized, their feats
# int8.
FORWARDS = {
    "split": (lambda: _network("split"), 0, 1, 2),
    "legacy": (lambda: _network("legacy"), 0, 1, 2),
    "phase": (lambda: _network("phase"), 0, 1, 0),
    "split_noise": (lambda: _network("split"), 8, 2, 2),
    "packed": (lambda: _network("packed", packed_min_res=8), 0, 1, 0),
    "int8 tier": (_calibrated_int8, 0, 1, 0),
}


@pytest.mark.parametrize("mode", sorted(FORWARDS))
def test_an_eval_forward_takes_the_kernel_where_the_rule_says(
        on_the_cpu, mode, monkeypatch):
    make, noise_dim, pyramids, upsamples = FORWARDS[mode]
    net = make()
    on_the_cpu.pool.n = on_the_cpu.up.n = 0  # the int8 tier's calibration
    layout, noise = _layout(noise_dim)
    with torch.no_grad():
        got = net(layout, BF16, noise=noise)
        assert (on_the_cpu.pool.n, on_the_cpu.up.n) == (pyramids, upsamples)
        monkeypatch.setattr(rs, "RESAMPLE_DEVICE", "cuda")
        want = net(layout, BF16, noise=noise)
    assert (on_the_cpu.pool.n, on_the_cpu.up.n) == (pyramids, upsamples)
    assert torch.equal(got, want)


@pytest.mark.parametrize("grad", [False, True], ids=["train mode",
                                                     "recorded gradient"])
def test_training_keeps_the_eager_calls(on_the_cpu, grad):
    net = _network("split")
    if not grad:
        net.train()
    layout, _ = _layout()
    layout.requires_grad_(grad)
    with torch.set_grad_enabled(True):
        out = net(layout, BF16 if grad else None)
    assert torch.isfinite(out).all()
    # Train mode without a gradient through the layout takes the kernel;
    # a layout that records one, and the feats after it, never do.
    if grad:
        assert (on_the_cpu.pool.n, on_the_cpu.up.n) == (0, 0)
    else:
        assert on_the_cpu.up.n == 0


# --- the roofline and the benchmark's bound and metric ------------------

def _r1():
    return files.load_file(files.BENCH_DIR / "kernels" / "R1_crn_resample.py")


@pytest.mark.parametrize("config", ["vg128", "coco64"])
@pytest.mark.parametrize("mode", ["legacy", "split", "split_noise"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("images", [1, 128])
def test_the_bound_equals_the_ports(config, mode, dtype, images):
    cfg = files.config(files.benchmark(), config)
    cfg = dict(cfg, serving=dict(cfg["serving"], crn_mode=mode,
                                 compute_dtype=dtype))
    m = cfg["model"]
    nbytes = roofline.crn_resample_bytes(
        images, *m["image_size"], tuple(m["refinement_dims"]),
        m["gconv_dim"] + m["layout_noise_dim"], 2 if dtype == "bfloat16"
        else 4)
    assert peaks.HBM_BYTES == roofline.HBM_BYTES
    assert _r1().bound_s({"images": images}, cfg) == pytest.approx(
        nbytes / roofline.HBM_BYTES, rel=1e-12)


def test_the_bound_at_vg128_b128():
    # The pyramid 893.9 MB and the four upsamples 1258.3 MB, in bf16.
    nbytes = roofline.crn_resample_bytes(128, 128, 128,
                                         (1024, 512, 256, 128, 64), 160, 2)
    assert nbytes == 671_088_640 + 222_822_400 + 1_258_291_200


@pytest.mark.parametrize("config", ["vg128", "coco64"])
def test_launches_a_forward(config):
    cfg = files.config(files.benchmark(), config)
    assert _r1().LAUNCHES(cfg) == 5
    for mode, want in (("split_noise", 6), ("legacy", 5), ("phase", None),
                       ("packed", None)):
        other = dict(cfg, serving=dict(cfg["serving"], crn_mode=mode))
        assert _r1().LAUNCHES(other) == want
        if want is None:
            assert _r1().bound_s({"images": 1}, other) is None


def _record(kernels, units, config="vg128"):
    cfg = files.config(files.benchmark(), config)
    return SimpleNamespace(
        slice=SimpleNamespace(kernels=kernels, units=units),
        cfg=cfg, bench_dir=files.BENCH_DIR)


def test_resample_fused_pct_reads_the_launches_a_forward():
    read = files.reader("resample_fused_pct.gen")
    units = [{"images": 128}] * 2
    pool = ("void (anonymous namespace)::crn_resample_kernel_pool<"
            "__nv_bfloat16, 4>((anonymous namespace)::PoolArgs)")
    up = ("(anonymous namespace)::crn_resample_kernel_up2("
          "(anonymous namespace)::UpArgs)")
    assert read(_record([(pool, 1e-4)] * 2 + [(up, 1e-4)] * 8, units)) \
        == 100.0
    aten = "void at::native::upsample_nearest2d_nhwc_out_frame"
    assert read(_record([(aten, 1e-4)] * 10, units)) == 0.0
    assert read(_record([], [])) is None
    # The kernels' roofline takes R1's time and bound.
    record = _record([(pool, 1e-4), (up, 1e-4)], units[:1])
    got = files.reader("kernels_roofline.gen")(record)
    assert got == pytest.approx(
        100 * _r1().bound_s(units[0], record.cfg) / 2e-4)


# --- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with torch.inference_mode():
        yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vg128", "coco64"])
def test_r1_is_bit_equal_to_aten_at_the_cells_b128_shapes(card, cell):
    import chip_smoke

    for case in chip_smoke.resample_cases(cell):
        assert chip_smoke.check_resample_case(torch, *case) == 0


def _vg128_crn_forwards(mode, monkeypatch, seed=0):
    """A vg128-wide bf16 CRN (layout 160 channels, stages 1024 .. 64) in
    ``mode`` on a b128 128x128 layout, eval, channels_last, cuDNN
    deterministic: (its output with R1, its output on aten's calls, R1's
    launches and layout copies in the first).  'split_noise' hands the
    last 32 channels apart.  (The generator's own forward, the layout and
    noise concatenated, is chip_smoke.check_epilogue_generate's, run by
    tests/test_torch_cuda.py.)"""
    import chip_smoke

    N, D, side = chip_smoke.RESAMPLE_CELLS["vg128"]
    torch.manual_seed(seed)
    net = tcrn.RefinementNetwork(
        (D,) + chip_smoke.RESAMPLE_STAGES + (64,), "batch", "leakyrelu-0.2",
        conv0_mode="split" if mode == "split_noise" else mode).to(
        "cuda", memory_format=torch.channels_last).eval()
    layout = chip_smoke.resample_input(torch, (N, D, side, side), "bf16",
                                       True, seed)
    noise = None
    if mode == "split_noise":
        noise = layout[:, D - 32:].contiguous(
            memory_format=torch.channels_last)
        layout = layout[:, :D - 32].contiguous(
            memory_format=torch.channels_last)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    before = rs.launches, rs.layout_copies
    got = net(layout, BF16, noise=noise)
    counts = rs.launches - before[0], rs.layout_copies - before[1]
    monkeypatch.setattr(rs, "RESAMPLE_DEVICE", "none")
    want = net(layout, BF16, noise=noise)
    torch.cuda.synchronize()
    assert rs.launches == before[0] + counts[0]
    return got, want, counts


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split", "legacy", "phase",
                                  "split_noise"])
def test_a_b128_crn_forward_equals_the_one_without_r1(card, mode,
                                                      monkeypatch):
    import chip_smoke

    got, want, counts = _vg128_crn_forwards(mode, monkeypatch)
    assert counts == (chip_smoke.R1_GENERATE[mode], 0)
    assert torch.equal(got, want)
