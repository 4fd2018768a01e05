"""M1, the eval mask head as one kernel launch a step (ops/mask_head.py),
on the CPU: the phase form's weight folding and its plain version against
the eager MaskNet, the generator's dispatch to it, its launch plan, and the
benchmark's bound and engagement metric of its kernel.

The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py).  Here the dispatch is driven by taking the CPU for the
kernel's device and watching the head's calls to the step wrapper, which
on the CPU computes the plain version.
"""

import ctypes

import pytest
import torch

from benchmark.harness import files, peaks
from sg2im_tpu_torch.models import Sg2ImGenerator
from sg2im_tpu_torch.models import sg2im
from sg2im_tpu_torch.models.sg2im import MaskNet
from sg2im_tpu_torch.ops import mask_head as mh
from sg2im_tpu_torch.utils import roofline

EXACT = 2e-5  # the suite's bar for exact reformulations in float32


def _mask_net(C, M, seed=0):
    """An eval MaskNet with BatchNorm statistics and affine parameters away
    from (0, 1)."""
    torch.manual_seed(seed)
    net = MaskNet(C, M).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k in range(net.steps):
            bn = net[4 * k + 1]
            bn.running_mean.copy_(0.5 * torch.randn(C, generator=g))
            bn.running_var.copy_(torch.rand(C, generator=g) * 3 + 0.05)
            bn.weight.copy_(1 + 0.3 * torch.randn(C, generator=g))
            bn.bias.copy_(0.3 * torch.randn(C, generator=g))
    return net


def _vectors(B, C, seed=2):
    """(B, C, 1, 1) object vectors, the last quarter as a padded batch's
    empty slots give them: zeros and one repeated vector."""
    x = torch.randn(B, C, 1, 1, generator=torch.Generator().manual_seed(seed))
    x[-B // 4:] = 0.0
    x[-1] = x[0]
    return x


# --- the phase form against the eager head ------------------------------

@pytest.mark.parametrize("M", [2, 4, 8, 16])
@pytest.mark.parametrize("C", [8, 128])
def test_the_plain_version_is_the_eager_head(C, M):
    net = _mask_net(C, M)
    x = _vectors(12, C)
    with torch.no_grad():
        want = torch.sigmoid(net(x)).squeeze(1)
        got = mh.mask_head_ref(x.reshape(12, C), net._phase_steps(),
                               net._final(), net[1].eps)
    assert got.shape == want.shape == (12, M, M)
    assert (got - want).abs().max().item() <= EXACT


@pytest.mark.parametrize("S", [1, 2, 4])
def test_a_step_is_upsample_batchnorm_conv_relu(S):
    """One step of the phase form against the eager layers it replaces, on
    an NHWC grid of side S."""
    net = _mask_net(8, 2 * S if S > 1 else 2, seed=S)
    bn, conv = net[1], net[2]
    x = torch.randn(3, 8, S, S, generator=torch.Generator().manual_seed(S))
    with torch.no_grad():
        want = torch.relu(conv(bn(net[0](x)))).permute(0, 2, 3, 1)
        (norm, folded, bias), *_ = net._phase_steps()
        got = mh.mask_step_ref(x.permute(0, 2, 3, 1), norm, folded, bias,
                               bn.eps)
    assert (got - want).abs().max().item() <= EXACT


def test_the_folded_taps_sum_the_kernels_rows_and_columns():
    w = torch.randn(5, 3, 3, 3, generator=torch.Generator().manual_seed(0))
    wf = mh.phase_weights(w)
    assert wf.shape == (4, 4, 3, 5) and wf.is_contiguous()
    # Each phase's four taps hold the nine weights between them once.
    for phase in range(4):
        assert torch.allclose(wf[phase].sum(0), w.sum((2, 3)).T, atol=1e-6)
    # Phase (0, 1), tap (1, 0): coarse offset (0, 0), kernel rows 1 and 2,
    # column 0 and 1.
    assert torch.allclose(wf[1, 2], w[:, :, 1:, :2].sum((2, 3)).T,
                          atol=1e-6)
    assert [mh.tap_offset(a, t) for a in (0, 1) for t in (0, 1)] == [
        -1, 0, 0, 1]


def test_the_fold_is_kept_per_weight_version():
    net = _mask_net(8, 4)
    first = net._phase_steps()
    assert all(a[1] is b[1] for a, b in zip(first, net._phase_steps()))
    with torch.no_grad():
        net[2].weight.mul_(2.0)
    again = net._phase_steps()
    assert again[0][1] is not first[0][1]
    assert torch.allclose(again[0][1], 2 * first[0][1])
    assert torch.equal(again[1][1], first[1][1])
    net.load_state_dict(_mask_net(8, 4, seed=9).state_dict())
    assert all(a[1] is not b[1] for a, b in zip(again, net._phase_steps()))


# --- dispatch -----------------------------------------------------------

class Calls:
    """Counts the head's calls to the step wrapper, which then runs as it
    would."""

    def __init__(self):
        self.n = 0
        self.step = mh.mask_step

    def __call__(self, *args, **kwargs):
        self.n += 1
        return self.step(*args, **kwargs)


@pytest.fixture
def on_the_cpu(monkeypatch):
    """The CPU taken for the kernel's device: -> the wrapper's calls."""
    calls = Calls()
    monkeypatch.setattr(sg2im, "MASK_HEAD_DEVICE", "cpu")
    monkeypatch.setattr(mh, "mask_step", calls)
    return calls


VOCAB = {"object_idx_to_name": [f"o{i}" for i in range(10)],
         "pred_idx_to_name": [f"p{i}" for i in range(5)]}
SMALL = dict(image_size=(16, 16), embedding_dim=16, gconv_dim=128,
             gconv_hidden_dim=32, gconv_num_layers=1,
             refinement_dims=(16, 8), normalization="batch",
             activation="leakyrelu-0.2", mask_size=16, layout_noise_dim=4)
CRNS = {"f32 legacy": {},
        "bf16 split": dict(compute_dtype=torch.bfloat16, crn_mode="split"),
        "int8 tier": dict(compute_dtype=torch.bfloat16, crn_mode="split",
                          crn_quant="int8", crn_quant_min_res=8)}


def _generator(crn="f32 legacy"):
    torch.manual_seed(4)
    model = Sg2ImGenerator(VOCAB, **SMALL, **CRNS[crn])
    model.mask_net.load_state_dict(_mask_net(128, 16).state_dict())
    model = model.eval()
    if crn == "int8 tier":
        scales = model.refinement_net.act_scales
        scales.values, scales.calibrating = {}, True
        with torch.no_grad():
            model(*_inputs())
        scales.calibrating = False
    return model


def _inputs():
    g = torch.Generator().manual_seed(5)
    objs = torch.randint(0, 10, (2, 6), generator=g)
    triples = torch.stack([torch.randint(0, 6, (2, 4), generator=g),
                           torch.randint(0, 5, (2, 4), generator=g),
                           torch.randint(0, 6, (2, 4), generator=g)], -1)
    obj_mask = torch.tensor([[1., 1., 1., 1., 0., 0.],
                             [1., 1., 0., 0., 0., 0.]])
    noise = torch.randn(2, 4, 16, 16, generator=g)
    return objs, triples, obj_mask, torch.ones(2, 4), noise


@pytest.mark.parametrize("crn", sorted(CRNS))
def test_an_eval_forward_takes_the_kernel_once_a_step(on_the_cpu, crn,
                                                      monkeypatch):
    """In eval mode without a gradient, whatever the CRN runs in, the head
    calls the step wrapper once at each of its four steps, and its masks,
    padded slots included, are the eager head's."""
    model = _generator(crn)
    on_the_cpu.n = 0  # the int8 tier's calibration forward
    with torch.no_grad():
        _, _, got, _ = model(*_inputs())
        assert on_the_cpu.n == 4
        monkeypatch.setattr(sg2im, "MASK_HEAD_DEVICE", "cuda")
        _, _, want, _ = model(*_inputs())
    assert on_the_cpu.n == 4 and mh.mask_head.launches == 0
    assert got.shape == want.shape == (2, 6, 16, 16)
    assert (got - want).abs().max().item() <= EXACT


CASES = {
    "train mode": lambda: (_generator().train(), False, None),
    "recorded gradient": lambda: (_generator(), True, None),
    "not the kernel's width": lambda: (None, False, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_these_forwards_keep_the_eager_head(on_the_cpu, case):
    model, grad, width = CASES[case]()
    if model is None:
        torch.manual_seed(4)
        model = Sg2ImGenerator(VOCAB, **dict(SMALL, gconv_dim=width)).eval()
    with torch.set_grad_enabled(grad):
        masks = model(*_inputs())[2]
    assert torch.isfinite(masks).all() and masks.shape == (2, 6, 16, 16)
    assert on_the_cpu.n == 0 and mh.mask_head.launches == 0


def test_a_float64_head_keeps_the_eager_path(on_the_cpu):
    net = _mask_net(128, 4).double()
    with torch.no_grad():
        masks = net.masks(_vectors(4, 128).double())
    assert masks.dtype == torch.float64 and masks.shape == (4, 4, 4)
    assert on_the_cpu.n == 0


def test_the_cpu_keeps_the_eager_head(monkeypatch):
    calls = Calls()
    monkeypatch.setattr(mh, "mask_step", calls)
    with torch.no_grad():
        _generator()(*_inputs())
    assert calls.n == 0


def test_on_the_cpu_the_wrapper_is_the_plain_version():
    net = _mask_net(128, 4)
    (norm, folded, bias), _ = net._phase_steps()
    x = torch.randn(3, 2, 2, 128)
    got = mh.mask_step(x, norm, folded, bias, 1e-5, net._final())
    want = mh.mask_step_ref(x, norm, folded, bias, 1e-5, net._final())
    assert torch.equal(got, want) and got.shape == (3, 4, 4)
    assert mh.mask_head.launches == 0


# --- the launch plan ----------------------------------------------------

def test_the_plan_struct_is_the_c_struct():
    # An int64, 6 int32, a float: 36 bytes, padded to 40.
    assert ctypes.sizeof(mh.PlanStruct) == 40
    assert [getattr(mh.PlanStruct, f).offset for f in mh.StepPlan._fields] \
        == [0, 8, 12, 16, 20, 24, 28, 32]


@pytest.mark.parametrize("slots,side,grid", [(2048, 8, 1024), (2048, 1, 16),
                                             (37, 4, 5), (1, 1, 1)])
def test_the_plan_covers_the_rows_in_tiles(slots, side, grid):
    p = mh.step_plan(slots, side, 128, False, 1e-5)
    assert p.rows == slots * side * side and 1 << p.log2_side == side
    assert p.grid == grid and p.threads == mh.THREADS
    assert (p.grid - 1) * mh.ROWS < p.rows <= p.grid * mh.ROWS


def test_the_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="128 channels"):
        mh.step_plan(4, 2, 64, False, 1e-5)
    with pytest.raises(ValueError, match="power of 2"):
        mh.step_plan(4, 3, 128, False, 1e-5)
    with pytest.raises(ValueError, match="no slots"):
        mh.step_plan(0, 2, 128, False, 1e-5)
    with pytest.raises(ValueError, match="grid"):
        mh.step_plan(2 ** 31, 16, 128, True, 1e-5)


# --- the benchmark's bound and engagement metric ------------------------

def _m1():
    return files.load_file(files.BENCH_DIR / "kernels" / "M1_mask_head.py")


@pytest.mark.parametrize("name", ["vg128", "coco64"])
@pytest.mark.parametrize("objects", [1, 700])
def test_the_benchmarks_bound_is_the_ports(name, objects):
    cfg = files.config(files.benchmark(), name)
    m = cfg["model"]
    C, M = m["gconv_dim"], m["mask_size"]
    want = max(roofline.mask_head_flops(objects, C, M) / roofline.F32_FLOPS,
               roofline.mask_head_bytes(objects, C, M) / roofline.HBM_BYTES)
    assert peaks.PEAKS["f32"] == roofline.F32_FLOPS
    assert _m1().bound_s({"objects": objects, "images": 128}, cfg) == \
        pytest.approx(want, rel=1e-12)
    assert _m1().LAUNCHES(cfg) == 4


def test_the_bound_at_vg128_b128_is_the_flop_count():
    # 44.2 MFLOP a slot in the phase form, 2048 slots: 90.6 GFLOP, 1.35 ms
    # at the float32 peak.
    assert roofline.mask_head_flops(1, 128, 16) == 44236800
    assert roofline.mask_head_flops(2048, 128, 16) / roofline.F32_FLOPS == \
        pytest.approx(1.3522e-3, rel=1e-4)
    # The direct form: 2.27 times as many.
    direct = 2 * 9 * 128 * 128 * (4 + 16 + 64 + 256) + 2 * 128 * 256
    assert direct / roofline.mask_head_flops(1, 128, 16) == pytest.approx(
        2.2681, rel=1e-4)


def test_the_bound_needs_a_mask_head():
    cfg = files.config(files.benchmark(), "vg128")
    bare = dict(cfg, model={k: v for k, v in cfg["model"].items()
                            if k != "mask_size"})
    assert _m1().bound_s({"objects": 10, "images": 2}, bare) is None
    assert _m1().bound_s({"images": 2}, cfg) is None


class _Slice:
    def __init__(self, kernels, units):
        self.kernels, self.units = kernels, units


class _Record:
    def __init__(self, sl, cfg):
        self.slice, self.cfg, self.bench_dir = sl, cfg, files.BENCH_DIR


@pytest.mark.parametrize("launches,want", [(0, 0.0), (4, 50.0), (8, 100.0)])
def test_mask_fused_pct_reads_the_kernels_launches(launches, want):
    read = files.reader("mask_fused_pct.gen")
    cfg = files.config(files.benchmark(), "coco64")
    name = f"void (anonymous namespace)::{_m1().NAME}<false>(Args)"
    kernels = [(name, 1e-4)] * launches + [("cudnn_conv", 1e-4)] * 7
    rec = _Record(_Slice(kernels, [{"images": 128}] * 2), cfg)
    assert read(rec) == pytest.approx(want)
    assert read(_Record(None, cfg)) is None
    assert read(_Record(_Slice(kernels, []), cfg)) is None
