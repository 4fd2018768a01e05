"""The CRN's fused post-convolution chain (ops/crn_epilogue.py) on the CPU:
its plain version against the eager chain the CRN ran before it, the CRN's
dispatch to it, its launch plan, and the benchmark's bound and engagement
metric of its kernel.

The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py).  Here the dispatch is driven by taking the CPU for the
kernel's device and watching the calls the CRN makes to the wrapper,
which on the CPU computes the plain version.
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import files
from sg2im_tpu_torch.nn import crn as tcrn
from sg2im_tpu_torch.nn.layers import BatchNorm, apply_activation
from sg2im_tpu_torch.ops import crn_epilogue as ce
from sg2im_tpu_torch.utils import roofline

BF16 = torch.bfloat16


def _addends(n, shape=(2, 16, 5, 6), channels_last=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        t = (3 * torch.randn(shape, generator=g)).to(BF16)
        out.append(t.contiguous(memory_format=torch.channels_last)
                   if channels_last else t.contiguous())
    return out


def _batch_norm(C, seed=1):
    """An eval BatchNorm with statistics and affine parameters away from
    (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C).eval()
    with torch.no_grad():
        bn.running_mean.copy_(0.5 * torch.randn(C, generator=g))
        bn.running_var.copy_(torch.rand(C, generator=g) * 3 + 0.05)
        bn.weight.copy_(1 + 0.3 * torch.randn(C, generator=g))
        bn.bias.copy_(0.3 * torch.randn(C, generator=g))
    return bn


def _todays_chain(parts, bn, out_dtype):
    """The CRN's chain after a convolution as it ran before the kernel:
    the parts added, float32, the BatchNorm module, LeakyReLU 0.2, the
    cast."""
    x = parts[0]
    for p in parts[1:]:
        x = x + p
    x = x.float()
    if bn is not None:
        x = bn(x)
    return apply_activation(("leakyrelu", 0.2), x).to(out_dtype)


@pytest.mark.parametrize("channels_last", [True, False],
                         ids=["channels_last", "nchw"])
@pytest.mark.parametrize("out_dtype", [BF16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("norm", [True, False], ids=["bn", "no_norm"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_plain_version_is_the_eager_chain(n, norm, out_dtype,
                                          channels_last):
    parts = _addends(n, channels_last=channels_last, seed=n)
    bn = _batch_norm(16) if norm else None
    want = _todays_chain(parts, bn, out_dtype)
    vectors = tcrn._bn_vectors(bn)
    got = ce.crn_epilogue_ref(parts, 0.2, out_dtype, vectors)
    assert got.dtype == out_dtype and torch.equal(got, want)
    # On the CPU the wrapper is the plain version.
    assert torch.equal(ce.crn_epilogue(parts, 0.2, out_dtype, vectors), want)
    assert ce.crn_epilogue.launches == 0


def test_the_partial_sums_round_to_bf16_in_order():
    # 1 + 2^-8 + 2^-8: the first add rounds to 1 (ties to even), so does
    # the second; the sum in float32 would be 1 + 2^-7.
    one = torch.ones(1, 8, 1, 1, dtype=BF16)
    eps = torch.full((1, 8, 1, 1), 2.0 ** -8, dtype=BF16)
    got = ce.crn_epilogue_ref([one, eps, eps], 1.0, torch.float32)
    assert torch.equal(got, torch.ones(1, 8, 1, 1))


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = _addends(4)
    for parts in ([], x):
        with pytest.raises(ValueError, match="addends"):
            ce.crn_epilogue(parts, 0.2)


# --- the CRN's stages against their convolutions and the eager chain ----

def _stage(mode, seed=3, L=6, cin=5, co=16):
    torch.manual_seed(seed)
    m = tcrn.RefinementModule(L, cin, co, "batch", "leakyrelu-0.2",
                              conv0_mode=mode).eval()
    m.net[1].load_state_dict(_batch_norm(co, seed).state_dict())
    m.net[4].load_state_dict(_batch_norm(co, seed + 1).state_dict())
    return m


def _todays_stage(m, layout, feats, noise):
    """A bf16 stage as the CRN ran it before the kernel: conv0's
    convolutions written out, then the eager chain after each conv."""
    conv0, conv1 = m.net[0], m.net[3]
    w, b = conv0.weight.to(BF16), conv0.bias.to(BF16)
    Dl = conv0.layout_dim
    layout, feats = layout.to(BF16), feats.to(BF16)
    up = F.interpolate(feats, scale_factor=2, mode="nearest")
    if conv0.mode == "legacy":
        parts = [F.conv2d(torch.cat([layout, up], 1), w, b, padding=1)]
    elif noise is None:
        parts = [F.conv2d(layout, w[:, :Dl], padding=1),
                 F.conv2d(up, w[:, Dl:], b, padding=1)]
    else:
        Dn = noise.shape[1]
        parts = [F.conv2d(layout, w[:, :Dl - Dn], padding=1),
                 F.conv2d(noise.to(BF16), w[:, Dl - Dn:Dl], padding=1),
                 F.conv2d(up, w[:, Dl:], b, padding=1)]
    x = _todays_chain(parts, m.net[1], BF16)
    x = F.conv2d(x, conv1.weight.to(BF16), conv1.bias.to(BF16), padding=1)
    return _todays_chain([x], m.net[4], BF16)


@pytest.mark.parametrize("mode", ["legacy", "split", "split_noise"])
def test_a_bf16_stage_is_todays_chain_bit_for_bit(mode):
    g = torch.Generator().manual_seed(4)
    layout = torch.randn(2, 6, 8, 8, generator=g)
    feats = torch.randn(2, 5, 4, 4, generator=g)
    noise = None
    if mode == "split_noise":
        mode, noise = "split", layout[:, 4:]
        layout = layout[:, :4]
    m = _stage(mode)
    with torch.no_grad():
        got = m(layout, feats, BF16, noise=noise)
        want = _todays_stage(m, layout, feats, noise)
    assert got.dtype == BF16 and torch.equal(got, want)


# --- dispatch -----------------------------------------------------------

class Calls:
    """Counts the CRN's calls to the wrapper, which then runs as it
    would."""

    def __init__(self):
        self.n = 0

    def __call__(self, *args, **kwargs):
        self.n += 1
        return ce.crn_epilogue(*args, **kwargs)


@pytest.fixture
def on_the_cpu(monkeypatch):
    """The CPU taken for the kernel's device: -> the wrapper's calls."""
    calls = Calls()
    monkeypatch.setattr(tcrn, "EPILOGUE_DEVICE", "cpu")
    monkeypatch.setattr(tcrn, "crn_epilogue", calls)
    return calls


DIMS = (8, 16, 8, 8)  # layout channels, then three stages
CHAINS = 2 * (len(DIMS) - 1) + 1


def _network(mode="split", normalization="batch", **kw):
    torch.manual_seed(5)
    net = tcrn.RefinementNetwork(DIMS, normalization, "leakyrelu-0.2",
                                 conv0_mode=mode, **kw).eval()
    for i, m in enumerate(net.refinement_modules):
        if normalization == "batch":
            for k in (1, 4):
                m.net[k].load_state_dict(
                    _batch_norm(m.output_dim, 10 * i + k).state_dict())
    # NHWC convolutions, as the engine runs them on a card.
    return net.to(memory_format=torch.channels_last)


def _layout(noise=False, seed=6):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, DIMS[0], 16, 16, generator=g).contiguous(
        memory_format=torch.channels_last)
    if noise:
        return x[:, :6], x[:, 6:]
    return x, None


@pytest.mark.parametrize("mode", ["legacy", "split", "phase", "split_noise"])
def test_an_eval_bf16_forward_takes_the_kernel_at_every_chain(on_the_cpu,
                                                              mode,
                                                              monkeypatch):
    layout, noise = _layout(noise=mode == "split_noise")
    net = _network("split" if mode == "split_noise" else mode)
    with torch.no_grad():
        got = net(layout, BF16, noise=noise)
        assert on_the_cpu.n == CHAINS
        monkeypatch.setattr(tcrn, "EPILOGUE_DEVICE", "cuda")
        want = net(layout, BF16, noise=noise)
    assert on_the_cpu.n == CHAINS
    assert torch.equal(got, want)
    assert ce.crn_epilogue.launches == 0


def _calibrated_int8():
    net = _network(quant="int8", quant_min_res=8)
    layout, _ = _layout()
    net.act_scales.values, net.act_scales.calibrating = {}, True
    with torch.no_grad():
        net(layout, BF16)
    net.act_scales.calibrating = False
    return net


CASES = {
    "train mode": lambda: (_network().train(), BF16, False),
    "recorded gradient": lambda: (_network(), BF16, True),
    "int8 tier": lambda: (_calibrated_int8(), BF16, False),
    "packed": lambda: (_network("packed", packed_min_res=8), BF16, False),
    "f32 compute": lambda: (_network(), None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_these_forwards_keep_the_eager_chain(on_the_cpu, case):
    net, dtype, grad = CASES[case]()
    layout, _ = _layout()
    with torch.set_grad_enabled(grad):
        out = net(layout, dtype)
    assert torch.isfinite(out).all()
    assert on_the_cpu.n == 0 and ce.crn_epilogue.launches == 0


def test_instance_norm_keeps_the_stages_eager_and_fuses_the_head(on_the_cpu):
    layout, _ = _layout()
    with torch.no_grad():
        _network(normalization="instance")(layout, BF16)
    assert on_the_cpu.n == 1


def test_an_nchw_network_takes_the_kernel_at_every_chain(on_the_cpu,
                                                         monkeypatch):
    """The layout of the parts does not choose the path: a network left in
    NCHW takes the wrapper at every chain, as the channels_last one does,
    and gives what its eager chains give."""
    layout = _layout()[0].contiguous()
    net = _network().to(memory_format=torch.contiguous_format)
    with torch.no_grad():
        got = net(layout, BF16)
        assert on_the_cpu.n == CHAINS
        monkeypatch.setattr(tcrn, "EPILOGUE_DEVICE", "cuda")
        want = net(layout, BF16)
    assert on_the_cpu.n == CHAINS
    assert torch.equal(got, want)


def test_channels_last_parts_copies_and_counts_what_is_not():
    """On a device other than the CPU (here 'meta') a part that is not
    channels_last is copied so and counted; one that is passes as it is,
    and CPU tensors always do."""
    before = ce.crn_epilogue.layout_copies
    nhwc = torch.empty(2, 16, 4, 4, device="meta").contiguous(
        memory_format=torch.channels_last)
    nchw = torch.empty(2, 16, 4, 4, device="meta")
    got = ce.channels_last_parts([nhwc, nchw])
    assert got[0] is nhwc and got[1] is not nchw
    assert got[1].is_contiguous(memory_format=torch.channels_last)
    assert ce.crn_epilogue.layout_copies == before + 1
    cpu = torch.zeros(2, 16, 4, 4)
    assert ce.channels_last_parts([cpu])[0] is cpu
    assert ce.crn_epilogue.layout_copies == before + 1


# --- the launch plan ----------------------------------------------------

def test_the_plan_struct_is_the_c_struct():
    # An int64, 7 int32, 2 floats: 44 bytes, padded to 48.
    assert ctypes.sizeof(ce.PlanStruct) == 48
    assert ce.PlanStruct.units.offset == 0
    assert ce.PlanStruct.grid.offset == 32 and ce.PlanStruct.eps.offset == 40


@pytest.mark.parametrize("C,aligned,vec", [(1024, True, 8), (64, True, 8),
                                           (64, False, 1), (20, True, 1),
                                           (3, True, 1)])
def test_the_plan_picks_its_unit(C, aligned, vec):
    p = ce.epilogue_plan(4 * C * 9, C, 2, False, True, 0.2, 1e-5, aligned)
    assert p.vec == vec and p.units * vec == 4 * C * 9
    assert p.threads % (C // vec) == 0 and p.threads <= ce.MAX_THREADS


def test_the_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="addends"):
        ce.epilogue_plan(64, 8, 4, False, True, 0.2, 1e-5, True)
    with pytest.raises(ValueError, match="channels"):
        ce.epilogue_plan(2 * 4104, 4104, 1, False, True, 0.2, 1e-5, True)
    with pytest.raises(ValueError, match="grid"):
        ce.epilogue_plan(2 ** 31 * 1024, 8, 1, True, True, 0.2, 1e-5, False)


@pytest.mark.parametrize("numel,C,addends,out_f32", [
    (128 * 8 * 8 * 1024, 1024, 2, False), (7 * 5 * 64, 64, 1, False),
    (3 * 13 * 20, 20, 3, False), (6 * 96, 96, 2, False),
    (128 * 128 * 128 * 64, 64, 1, True), (2 * 5 * 3, 3, 1, True),
    (3 * 600, 600, 1, False)])
def test_the_walk_covers_the_tensor_in_one_trip_by_channel_group(
        numel, C, addends, out_f32):
    """The kernel's walk, emulated: thread t of the grid takes units t + k
    stride (k < unroll) on each trip; every unit's channel group is the
    one its thread formed its BatchNorm terms for, and one trip covers the
    tensor."""
    p = ce.epilogue_plan(numel, C, addends, out_f32, True, 0.2, 1e-5, True)
    per_thread = ce.unroll(out_f32)
    stride = p.grid * p.threads
    assert stride * per_thread >= p.units > (stride - p.threads) * per_thread
    u = np.arange(p.units)
    c0 = (u % stride) % p.threads % (C // p.vec)
    assert (c0 == u % (C // p.vec)).all()


# --- the benchmark's bound and engagement metric ------------------------

def _config(name):
    b = files.benchmark()
    return files.config(b, name)


def _e1():
    return files.load_file(files.BENCH_DIR / "kernels" /
                           "E1_crn_epilogue.py")


@pytest.mark.parametrize("name", ["vg128", "coco64"])
def test_the_benchmarks_bound_is_the_ports(name):
    cfg = _config(name)
    m = cfg["model"]
    H, W = m["image_size"]
    mode = cfg["serving"]["crn_mode"]
    want = roofline.crn_epilogue_bytes(
        128, H, W, tuple(m["refinement_dims"]),
        roofline.CONV0_ADDENDS[mode]) / roofline.HBM_BYTES
    assert _e1().bound_s({"images": 128}, cfg) == pytest.approx(
        want, rel=1e-12)
    assert _e1().ADDENDS == roofline.CONV0_ADDENDS


def test_the_bound_at_vg128_is_the_byte_count():
    # 2 x 260 M stage elements (6 and 4 bytes) and 134 M head elements (6
    # bytes) a b128 call: 3.41 GB.
    assert roofline.crn_epilogue_bytes(128, 128, 128, (1024, 512, 256, 128,
                                                       64), 2) == 3405774848


class _Slice:
    def __init__(self, kernels, units):
        self.kernels, self.units = kernels, units


class _Record:
    def __init__(self, sl, cfg):
        self.slice, self.cfg, self.bench_dir = sl, cfg, files.BENCH_DIR


@pytest.mark.parametrize("launches,want", [(0, 0.0), (11, 50.0),
                                           (22, 100.0)])
def test_crn_fused_pct_reads_the_kernels_launches(launches, want):
    read = files.reader("crn_fused_pct.gen")
    name = f"void (anonymous namespace)::{_e1().NAME}<2, 8, false, true>"
    kernels = [(name, 1e-5)] * launches + [("cudnn_conv", 1e-4)] * 7
    rec = _Record(_Slice(kernels, [{"images": 128}] * 2), _config("vg128"))
    assert read(rec) == pytest.approx(want)
    assert read(_Record(None, _config("vg128"))) is None
    assert read(_Record(_Slice(kernels, []), _config("vg128"))) is None
