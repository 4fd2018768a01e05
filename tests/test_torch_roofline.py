"""The card's roofline arithmetic (``sg2im_tpu_torch.utils.roofline``) on
the CPU: no device time here, only counts.

- the closed forms ``chip_smoke.py`` prints its kernel rows' bounds from,
  moved here unchanged: K1's 1.077 GB and 0.3215 ms at ``LAYOUT_TIMED``,
  K3's 0.5259 / 0.1352 ms over the packed path's shapes, K4's 0.4909 (s8)
  and 0.9380 (bf16) ms over the turbo convs;
- ``FlopCounter``: a CRN stage's convolutions count 2 N H W Cin Co 9
  (padded taps included); operations are kept apart by the type whose peak
  they run at (bf16, f32, TF32 where the backend's flag allows it); K1
  counts the same through its plain version on the CPU as the card does
  (its closed form per launch, the dispatcher blind to the kernel), in the
  forward and, through the wrapper, in the backward, whose recompute the
  CPU's plain autograd path does not do; K3's and K4's plain versions
  count their closed forms;
- ``section_row``'s keys are ``PERF.json``'s, its speed of light is
  ``scripts/roofline_train.py``'s arithmetic, and a section holding two
  types is held to each type's peak; ``tensor_bytes`` counts each storage
  once.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from sg2im_tpu_torch.inference import full_fp32
from sg2im_tpu_torch.nn.crn import RefinementModule
from sg2im_tpu_torch.ops import conv_kernel, layout_kernel
from sg2im_tpu_torch.ops.layout import masks_to_layout
from sg2im_tpu_torch.ops.relayout import depth_to_space, space_to_depth
from sg2im_tpu_torch.utils import roofline as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_takes_its_bounds_from_utils_roofline():
    for name in ("roofline_ms", "layout_bounds", "relayout_bounds",
                 "conv_bounds", "BF16_FLOPS", "F32_FLOPS", "INT8_OPS"):
        assert getattr(chip_smoke, name) is getattr(R, name), name
    assert (R.HBM_BYTES, R.BF16_FLOPS, R.INT8_OPS, R.F32_FLOPS) == (
        3.35e12, 989e12, 1979e12, 67e12)


def test_k1_bound_at_the_timed_shape():
    nbytes, ops = R.layout_bounds(*chip_smoke.LAYOUT_TIMED, weights=False)
    assert nbytes == 1076920320  # 1.077 GB: the f32 layout's write
    ms, by = R.roofline_ms(nbytes, ops, R.F32_FLOPS)
    assert by == "bytes" and round(ms, 4) == 0.3215
    ms_w, by_w = R.roofline_ms(*R.layout_bounds(
        *chip_smoke.LAYOUT_TIMED, weights=True), R.F32_FLOPS)
    assert by_w == "bytes" and round(ms_w, 4) == 0.3315


def test_k3_and_k4_bounds_as_chip_smoke_prints_them():
    rl = R.relayout_bounds(chip_smoke.RELAYOUT_PATH.values())
    assert {k: (round(ms, 4), by) for k, (ms, by) in rl.items()} == {
        "s2d": (0.5259, "bytes"), "d2s": (0.1352, "bytes")}
    for size, peak, want in ((1, R.INT8_OPS, 0.4909),
                             (2, R.BF16_FLOPS, 0.9380)):
        total = sum(R.roofline_ms(*R.conv_bounds(128, *shape, size),
                                  peak)[0]
                    for shape in chip_smoke.TURBO_CONVS.values())
        assert round(total, 4) == want


@pytest.mark.parametrize("mode", ["legacy", "split"])
def test_a_crn_stage_counts_its_conv_flops(mode):
    N, L, C, Co, res = 2, 6, 5, 4, 8
    stage = RefinementModule(L, C, Co, "batch", "leakyrelu-0.2",
                             conv0_mode=mode).eval()
    layout = torch.randn(N, L, res, res)
    feats = torch.randn(N, C, res // 2, res // 2)
    with torch.no_grad(), full_fp32(), R.FlopCounter() as fc:
        stage(layout, feats)
    want = 2 * N * res * res * 9 * ((L + C) * Co + Co * Co)
    assert fc.total == want and fc.kernels == {}
    assert fc.by_type == {"f32": want}
    x = torch.randn(N, L + C, res, res)
    with R.FlopCounter() as fc:
        F.conv2d(x, torch.randn(Co, L + C, 3, 3), padding=1)
    assert fc.total == R.conv_bounds(N, res, res, L + C, Co, 4)[1]


def test_flop_counter_keeps_operation_types_apart():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    x, w = torch.randn(1, 3, 5, 5), torch.randn(2, 3, 3, 3)
    conv = 2 * 25 * 9 * 3 * 2
    with full_fp32(), R.FlopCounter() as fc:
        a @ b
        a.bfloat16() @ b.bfloat16()
        F.conv2d(x, w, padding=1)
        F.conv2d(x.bfloat16(), w.bfloat16(), padding=1)
    assert fc.by_type == {"f32": 2 * 8 * 16 * 4 + conv,
                          "bf16": 2 * 8 * 16 * 4 + conv}
    # Where the backend may round float32 to TF32, those operations are
    # held to the TF32 peak: cuDNN's flag for convolutions, the matmul
    # flag for matmuls.
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        with R.FlopCounter() as fc:
            a @ b
            F.conv2d(x, w, padding=1)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert fc.by_type == {"f32": 2 * 8 * 16 * 4, "tf32": conv}
    assert set(R.TYPE_PEAKS) == {"bf16", "int8", "tf32", "f32"}


def _layout_inputs(seed=0, N=2, O=3, M=4, D=5):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 0.5, (N, O, 2)).astype(np.float32)
    boxes = torch.tensor(np.concatenate([lo, lo + 0.4], -1))
    masks = torch.tensor(rng.rand(N, O, M, M).astype(np.float32))
    vecs = torch.tensor(rng.randn(N, O, D).astype(np.float32))
    return vecs, boxes, masks, torch.ones(N, O)


def _card_launch(boxes, masks, vecs, H, W, out_dtype):
    """K1's launch as a counter on the card sees it: the kernel's output,
    no dispatcher work, one launch counted."""
    from torch.utils._mode_utils import no_dispatch

    with no_dispatch():
        out = layout_kernel.layout_compose_ref(
            boxes.float(), masks.float(), vecs.float(), H, W).to(out_dtype)
    layout_kernel.layout_compose.launches += 1
    return out


@pytest.mark.parametrize("grad", [False, True], ids=["forward",
                                                     "forward_backward"])
def test_k1_counts_the_same_on_the_plain_path_and_the_wrapper(grad,
                                                              monkeypatch):
    H = W = 8
    closed = R.layout_bounds(2, 3, 4, H, W, 5, weights=False)[1]
    per_launch = {layout_kernel.layout_compose: (closed, "f32")}

    def count(backend):
        vecs, boxes, masks, om = _layout_inputs()
        vecs.requires_grad_(grad)
        masks.requires_grad_(grad)
        with R.FlopCounter(per_launch) as fc:
            out = masks_to_layout(vecs, boxes, masks, om, H, W,
                                  backend=backend)
            if grad:
                out.square().sum().backward()
        return fc.by_type, fc.kernels

    plain = count("auto")    # the CPU's plain path
    wrapper = count("cuda")  # the wrapper, its plain version on the CPU
    monkeypatch.setattr(layout_kernel, "_launch_boxes", _card_launch)
    monkeypatch.setattr(layout_kernel.layout_compose, "launches", 0)
    card = count("cuda")
    assert plain[1] == wrapper[1] == {}
    assert card[1] == {"layout_compose": closed}
    assert wrapper[0] == card[0]
    if grad:
        # The card's backward recomputes the forward in plain PyTorch
        # before its vector-Jacobian product; autograd of the CPU's plain
        # path does not.
        assert plain[0] == {"f32": card[0]["f32"] - closed}
    else:
        assert plain[0] == card[0] == {"f32": closed}


def test_k3_and_k4_count_their_closed_forms_on_the_cpu():
    x = torch.randn(2, 3, 4, 6).contiguous(memory_format=torch.channels_last)
    with R.FlopCounter() as fc:
        depth_to_space(space_to_depth(x))
    assert fc.total == 0 and fc.kernels == {}
    xq = torch.randint(-127, 128, (2, 7, 5, 6), dtype=torch.int8)
    wq = torch.randint(-127, 128, (9, 7, 3, 3), dtype=torch.int8)
    dq = torch.rand(9)
    with R.FlopCounter() as fc:  # the plain version convolves in float64
        conv_kernel.conv3x3_int8(xq, wq, dq)
    assert fc.total == R.conv_bounds(2, 5, 6, 7, 9, 1)[1]
    with R.FlopCounter() as fc:  # a nested counter sees the same
        with R.FlopCounter() as inner:
            layout_kernel.layout_compose(*_layout_inputs()[1:3],
                                         _layout_inputs()[0], 8, 8)
    assert fc.total == inner.total == R.layout_bounds(2, 3, 4, 8, 8, 5,
                                                      False)[1]


def test_section_row_has_the_perf_json_keys_and_the_speed_of_light():
    with open(os.path.join(REPO, "PERF.json")) as f:
        jax_row = json.load(f)["sections"][0]
    pk = R.peaks({"bf16_matmul_flops": 600e12, "f32_matmul_flops": 50e12,
                  "scale_add_bytes": 3.0e12})
    row = R.section_row("crn_total", 2.0, {"bf16": 1.2e12}, 0.9e9, pk)
    assert set(jax_row) <= set(row)
    assert row["gflops"] == 1200.0 and row["mbytes"] == 900.0
    assert row["tflops_s"] == pytest.approx(600.0)
    sol = max(1.2e12 / R.BF16_FLOPS, 0.9e9 / R.HBM_BYTES) * 1e3
    assert row["sol_ms"] == pytest.approx(sol)
    assert row["pct_sol"] == pytest.approx(100 * sol / 2.0)
    assert row["headroom_x"] == pytest.approx(2.0 / sol)
    assert row["bound"] == "mxu"
    assert row["pct_mxu_peak"] == pytest.approx(100 * 600 / 989)
    assert row["pct_sol_measured"] == pytest.approx(100.0)  # at 600 TF/s
    assert R.max_share(row) == pytest.approx(row["pct_mxu_peak"])
    assert R.max_share(row, "_measured") == pytest.approx(100.0)
    bare = R.section_row("x", 1.0, {}, 3.35e9, R.peaks())
    assert bare["bound"] == "hbm" and bare["pct_hbm_peak"] == \
        pytest.approx(100.0) and bare["sol_ms_measured"] is None


def test_section_row_holds_each_type_to_its_own_peak():
    """A bf16 section with f32 parts (the e2e forward of a bf16 mode): its
    operations' least time is the sum of each type's at its own peak."""
    flops = {"bf16": 989e9, "f32": 67e9}
    row = R.section_row("e2e_forward", 4.0, flops, 0.0, R.peaks(
        {"bf16_matmul_flops": 989e12 / 2, "f32_matmul_flops": 67e12 / 2,
         "scale_add_bytes": 3e12}))
    assert row["sol_ms"] == pytest.approx(2.0)  # 1 ms of each
    assert row["pct_sol"] == pytest.approx(50.0)
    assert row["pct_sol_measured"] == pytest.approx(100.0)
    assert row["gflops"] == pytest.approx(1056.0)
    assert row["gflops_by_type"] == {"bf16": 989.0, "f32": 67.0}
    # Held to bf16's peak alone it would read 1.07 ms, a share about half.
    assert row["sol_ms"] > 1056e9 / R.BF16_FLOPS * 1e3 * 1.8
    # A type without a measured peak leaves the measured shares empty.
    tf = R.section_row("x", 1.0, {"tf32": 1e9}, 0.0, R.peaks(
        {"bf16_matmul_flops": 1.0, "f32_matmul_flops": 1.0,
         "scale_add_bytes": 1.0}))
    assert tf["sol_ms"] == pytest.approx(1e9 / R.TF32_FLOPS * 1e3)
    assert tf["pct_sol_measured"] is None


def test_tensor_bytes_counts_each_storage_once():
    a = torch.zeros(10)
    b = torch.zeros(4, dtype=torch.bfloat16)
    lin = torch.nn.Linear(3, 2)
    assert R.tensor_bytes(a, [a, {"b": b}], (a,)) == 40 + 8
    assert R.tensor_bytes(lin, lin.weight) == 4 * (6 + 2)


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_122threefry_normal_kernelILi1ELi1EEEvPNS_3OutIXT_EE1TENS_6ParamsE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;             /* 0x00000a00ff017b82 */
        /*0010*/                   IADD3 R2, R3, R4, RZ ;             /* 0x0000000403027210 */
        /*0020*/              @!P0 SHF.L.W.U32.HI R5, R5, 0xd, R5 ;  /* 0x0000000d05057819 */
        /*0030*/                   IADD3.X R2, R3, R4, RZ, P0, !PT ; /* 0x0000000403027210 */
        /*0040*/                   UIADD3 UR4, UR4, 0x1, URZ ;       /* 0x0000000104047890 */
        /*0050*/                   FFMA R6, R7, R8, R9 ;             /* 0x0000000807067223 */
\t\tFunction : _ZN12_GLOBAL__N_122threefry_normal_kernelILi1ELi2EEEvPNS_3OutIXT_EE1TENS_6ParamsE
        /*0000*/                   IADD3 R2, R3, R4, RZ ;             /* 0x0000000403027210 */
"""


def test_sass_mix_and_threefry_bound():
    """cuobjdump -sass text -> opcode counts of the named instance alone
    (modifiers and predicates dropped), and the threefry bound: the
    largest of the output's bytes at 3.35 TB/s, the least instructions a
    value this ISA needs issued at 128 an SM a clock, and the xors on the
    64 integer ALU lanes of an SM."""
    mix = R.sass_mix(SASS, "threefry_normal_kernelILi1ELi1E")
    assert mix == {"LDC": 1, "IADD3": 2, "SHF": 1, "UIADD3": 1, "FFMA": 1}
    assert sum(v for k, v in mix.items() if k in R.INT_OPCODES) == 3
    assert R.sass_mix(SASS, "nothing") == {}
    assert R.THREEFRY_OPS == {"f32": (83, 21), "bf16": (83, 21),
                              "split": (66, 20), "uniform": (72, 21)}
    values = 128 * 32 * 128 * 128
    ms, by = R.threefry_bounds(values, 4 * values, R.THREEFRY_OPS["f32"],
                               132, 1.98e9)
    assert by == "operations"
    assert ms == pytest.approx(values * 83 / (132 * 128 * 1.98e9) * 1e3)
    assert 0.16 < ms < 0.17
    # Where the ALU's share of the work outweighs the issue's, it binds.
    ms, by = R.threefry_bounds(values, 4 * values, R.ThreefryOps(30, 20),
                               132, 1.98e9)
    assert ms == pytest.approx(values * 20 / (132 * 64 * 1.98e9) * 1e3)
    ms, by = R.threefry_bounds(values, 4 * values, R.ThreefryOps(1, 0),
                               132, 1.98e9)
    assert by == "bytes" and ms == pytest.approx(4 * values / 3.35e12 * 1e3)
