"""The layout compose's boxes entry (K1) as the CPU can hold it.

* Its kernel's plan (``layout_kernel.boxes_plan``, which the wrapper passes
  to the launch): within the shared memory and thread limits it states,
  object groups only on a tile of one pass, and every output pixel and
  channel stored exactly once by the kernel's walk (blocks of TH x TX
  pixels, pixel groups of 4 pixels of a row taken in turn by the block's
  threads, channel groups of 8), on every ``chip_smoke.KERNEL_CASES`` shape
  and on the main path's shapes (vg128 at b128, COCO-64 at b32,
  trained_fidelity's D 64).
* A plain emulation of the kernel's walk in float32: per block the taps
  (the kernel's expressions, indices clamped into the mask where the
  weight is 0), the 2x2 sample of the mask, the sum over objects in the
  order o = 0 ... O - 1 carried over object groups, the ragged edges;
  against ``layout_compose_ref`` to 1e-6 abs on small ragged shapes.  A
  degenerate box adds exactly 0.
* ``tools/layout_ab``: each checkout timed through its own wrapper in a
  process of its own, its outputs held to the plain version; and
  ``_measure.within_one_rounding``, the bar of every bf16 output.
"""

import pytest
import torch

import chip_smoke
from sg2im_tpu_torch.ops import layout_kernel as lk
from sg2im_tpu_torch.tools import _measure, layout_ab

ATOL = 1e-6

# (O, H, W, M, D) of the layouts the main path composes.
PATH_SHAPES = {
    "vg128 b128": (16, 128, 128, 16, 128),
    "coco64 b32": (16, 64, 64, 16, 128),
    "trained_fidelity D64": (16, 64, 64, 16, 64),
}
# The chip cases, the path shapes and cut-offs of the plan: object groups
# with a tile of one pass, D split over channel tiles, W below one tile,
# M 32, channel groups that do not fill a warp.
PLAN_SHAPES = sorted({(O, H, W, M, D) for _, O, M, H, W, D, *_
                      in chip_smoke.KERNEL_CASES.values()}
                     | set(PATH_SHAPES.values()) | {
    (64, 128, 128, 16, 128), (160, 64, 256, 8, 64), (700, 5, 40, 4, 8),
    (3, 2, 2, 1, 1), (11, 17, 300, 32, 260), (40, 33, 20, 13, 130),
    (30, 32, 32, 32, 128), (5, 9, 7, 3, 44),
})


def _is_pow2(v):
    return v > 0 and v & (v - 1) == 0


def tiles(plan, H, W):
    """Each block's tile: (y0, th, x0, tx), th and tx inside the image."""
    for band in range(plan.n_bands):
        for xt in range(plan.x_tiles):
            y0, x0 = band * plan.TH, xt * plan.TX
            yield y0, min(plan.TH, H - y0), x0, min(plan.TX, W - x0)


def pixel_groups(plan, th, tx):
    """The kernel's passes over one tile: thread pixel group pg takes
    groups q = pg, pg + pgs, ... of 4 pixels of row q // (TX / 4) from
    column 4 (q % (TX / 4)); those past the image's edge are skipped.
    Yields (row, [columns inside the image])."""
    per_row = plan.TX // lk.B_X_PER
    for pg in range(plan.pgs):
        for q in range(pg, plan.TH * per_row, plan.pgs):
            r, c = q // per_row, q % per_row * lk.B_X_PER
            if r < th and c < tx:
                yield r, [c + a for a in range(lk.B_X_PER) if c + a < tx]


def channel_groups(plan, D, out_elem=2):
    """Per channel tile and thread channel group: the runs of channels it
    stores, fewer at the tile's end, none past it.  bf16 (``out_elem`` 2):
    8 consecutive channels; f32: two halves of 4, 4 d_groups apart."""
    for dt in range(plan.d_tiles):
        d_base = dt * lk.TILE_D
        d_len = min(lk.TILE_D, D - d_base)
        for dg in range(plan.d_groups):
            runs = ([(8 * dg, 8 * dg + 8)] if out_elem == 2 else
                    [(4 * (h * plan.d_groups + dg),
                      4 * (h * plan.d_groups + dg) + 4) for h in (0, 1)])
            for lo, hi in runs:
                if lo < d_len:
                    yield d_base + lo, d_base + min(hi, d_len)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_boxes_plan_within_its_limits(shape):
    O, H, W, M, D = shape
    plan = lk.boxes_plan(O, H, W, M, D)
    assert _is_pow2(plan.TH) and plan.TH <= lk.B_MAX_TH
    assert _is_pow2(plan.TX) and lk.B_X_PER <= plan.TX <= lk.B_MAX_TX
    assert plan.TH * plan.TX <= lk.B_TILE_PIX
    assert plan.smem == lk.boxes_smem(plan.G, plan.TH, plan.TX, M,
                                      plan.d_groups)
    # Three blocks per SM: 228 KB less 1 KB the card keeps per block.
    assert plan.smem <= lk.B_SMEM_BUDGET
    assert 3 * (plan.smem + 1024) <= 228 * 1024
    assert plan.threads == plan.d_groups * plan.pgs <= lk.B_THREADS
    assert plan.pgs * lk.B_X_PER <= plan.TH * plan.TX
    assert lk.B_D_PER * plan.d_groups >= min(D, lk.TILE_D) \
        > lk.B_D_PER * (plan.d_groups - 1)
    assert plan.G * (plan.groups - 1) < O <= plan.G * plan.groups
    if plan.groups > 1:  # sums carried in registers: a tile of one pass
        assert plan.TH * plan.TX == plan.pgs * lk.B_X_PER
    assert plan.d_tiles * lk.TILE_D >= D > (plan.d_tiles - 1) * lk.TILE_D


@pytest.mark.parametrize("out_elem", [2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_boxes_plan_stores_every_output_once(shape, out_elem):
    O, H, W, M, D = shape
    plan = lk.boxes_plan(O, H, W, M, D)
    hits = torch.zeros((H, W, D), dtype=torch.int32)
    for y0, th, x0, tx in tiles(plan, H, W):
        for r, cols in pixel_groups(plan, th, tx):
            for d0, d1 in channel_groups(plan, D, out_elem):
                hits[y0 + r, x0 + cols[0]:x0 + cols[-1] + 1, d0:d1] += 1
    assert bool((hits == 1).all())


def test_boxes_plan_on_the_main_path():
    """vg128 at b128: tiles of 16 rows by 32 columns (8 passes of 64
    pixels), all 16 objects in one group, 256 threads, 68 KB of shared
    memory; the training shapes take the same tile."""
    plan = lk.boxes_plan(*PATH_SHAPES["vg128 b128"])
    assert plan == lk.BoxesPlan(TH=16, TX=32, G=16, d_groups=16, pgs=16,
                                threads=256, n_bands=8, x_tiles=4, d_tiles=1,
                                groups=1, smem=69632)
    for name in ("coco64 b32", "trained_fidelity D64"):
        p = lk.boxes_plan(*PATH_SHAPES[name])
        assert (p.TH, p.TX, p.G, p.groups, p.threads) == (16, 32, 16, 1, 256)


def emulate_taps(p, size, lo, hi, M):
    """The kernel's taps_at in float32 for coordinates ``p`` (P,) and box
    edges lo, hi (N, G): (j0, j1, w0, w1), each (N, G, P), the indices
    clamped into [0, M - 1]."""
    t = p.to(torch.float32) / torch.tensor(size - 1, dtype=torch.float32)
    s = (t - lo[..., None]) / (hi - lo)[..., None] * float(M - 1)
    inside = (s > -1.0) & (s < float(M)) & (p < size)
    f = torch.floor(s)
    j0 = torch.where(inside, f, torch.zeros_like(f)).long()
    zero = torch.zeros_like(s)
    w0 = torch.where(inside & (j0 >= 0),
                     torch.clamp(1.0 - (s - f).abs(), min=0.0), zero)
    w1 = torch.where(inside & (j0 + 1 <= M - 1),
                     torch.clamp(1.0 - (s - (f + 1.0)).abs(), min=0.0), zero)
    return j0.clamp(min=0), (j0 + 1).clamp(max=M - 1), w0, w1


def emulate_boxes_kernel(boxes, masks, vecs, H, W, plan):
    """The kernel's walk on the CPU in float32, every image at once.

    Per block (band of TH rows, tile of TX columns, channel tile) and object
    group: the x taps of the tile's columns and the y taps of its rows; the
    coefficients, the 2x2 sample of the mask, zero past the image's edge;
    the sum over the group's objects in order, carried over groups; per
    pixel group and channel group, the store.  Returns (out, how often each
    (y, x, d) was stored).
    """
    N, O, M = masks.shape[:3]
    D = vecs.shape[-1]
    TH, TX, G = plan.TH, plan.TX, plan.G
    n_idx = torch.arange(N)[:, None, None, None]
    out = torch.full((N, H, W, D), float("nan"))
    hits = torch.zeros((H, W, D), dtype=torch.int32)
    for y0, th, x0, tx in tiles(plan, H, W):
        acc = torch.zeros((N, TH, TX, D))
        for g in range(plan.groups):
            o = torch.arange(g * G, min(O, (g + 1) * G))
            j0, j1, wx0, wx1 = emulate_taps(x0 + torch.arange(TX), W,
                                            boxes[:, o, 0], boxes[:, o, 2], M)
            i0, i1, wy0, wy1 = emulate_taps(y0 + torch.arange(TH), H,
                                            boxes[:, o, 1], boxes[:, o, 3], M)
            o_idx = o[None, :, None, None]

            def m(i, j):
                return masks[n_idx, o_idx, i[..., :, None], j[..., None, :]]

            a, b = wy0[..., None], wy1[..., None]
            t0 = a * m(i0, j0) + b * m(i1, j0)
            t1 = a * m(i0, j1) + b * m(i1, j1)
            coef = t0 * wx0[..., None, :] + t1 * wx1[..., None, :]
            for k in range(len(o)):  # the objects in order
                acc = acc + coef[:, k, :, :, None] * vecs[:, o[k], None,
                                                          None, :]
        for r, cols in pixel_groups(plan, th, tx):
            c = torch.tensor(cols)
            for d0, d1 in channel_groups(plan, D):
                out[:, y0 + r, x0 + c, d0:d1] = acc[:, r][:, c, d0:d1]
                hits[y0 + r, x0 + c, d0:d1] += 1
    return out, hits


# (N, O, M, H, W, D, degenerate): small, ragged against every tile edge,
# and one of each plan cut-off: object groups (O 16 at M 32 D 128 is one
# above a group of 15; O 120 is chip_smoke's, held at 1e-5 on the card),
# D split over channel tiles, W and H below a tile, O 1.
WALK_CASES = {
    "ragged N3 O5 M8 24x40 D13": (3, 5, 8, 24, 40, 13, False),
    "ragged N2 O7 M16 40x50 D36": (2, 7, 16, 40, 50, 36, False),
    "degenerate N2 O12 M6 20x18 D20": (2, 12, 6, 20, 18, 20, True),
    "O1 N3 M4 6x2 D24": (3, 1, 4, 6, 2, 24, False),
    "groups+1 N1 O16 M32 9x40 D128": (1, 16, 32, 9, 40, 128, False),
    "D split N1 O3 M5 7x9 D260": (1, 3, 5, 7, 9, 260, False),
    "M32 N2 O4 M32 10x13 D16": (2, 4, 32, 10, 13, 16, False),
}


def _walk_inputs(case, seed=3):
    N, O, M, H, W, D, degenerate = case
    return chip_smoke.layout_inputs(N, O, M, H, W, D, seed, degenerate,
                                    device="cpu")


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_kernel_walk_matches_plain_version(name):
    N, O, M, H, W, D, _ = WALK_CASES[name]
    boxes, masks, vecs = _walk_inputs(WALK_CASES[name])
    plan = lk.boxes_plan(O, H, W, M, D)
    got, hits = emulate_boxes_kernel(boxes, masks, vecs, H, W, plan)
    assert bool((hits == 1).all())
    want = lk.layout_compose_ref(boxes, masks, vecs, H, W)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_one_object_past_a_group_makes_two_groups():
    _, O, M, H, W, D, _ = WALK_CASES["groups+1 N1 O16 M32 9x40 D128"]
    plan = lk.boxes_plan(O, H, W, M, D)
    assert (plan.G, plan.groups) == (15, 2)
    # chip_smoke's case of the same cut-off at vg128's M and D.
    plan = lk.boxes_plan(38, 64, 64, 16, 128)
    assert (plan.G, plan.groups) == (37, 2)


def test_degenerate_box_adds_exactly_zero():
    """Only the degenerate objects carry a vector: the walk's layout is
    exactly 0 (their taps are all zero, so every coefficient is)."""
    case = WALK_CASES["degenerate N2 O12 M6 20x18 D20"]
    N, O, M, H, W, D, _ = case
    boxes, masks, vecs = _walk_inputs(case)
    lone = torch.zeros_like(vecs)
    # chip_smoke.layout_inputs: slot 2 is a point box (0/0 at t = 0), every
    # third slot has zero width, slot 1 of every four zero height.
    for o in (0, 1, 2, 3, 5):
        lone[:, o] = vecs[:, o] + 1.0
    got, _ = emulate_boxes_kernel(boxes, masks, lone, H, W,
                                  lk.boxes_plan(O, H, W, M, D))
    assert bool((got == 0).all())


def test_cpu_tensors_count_no_launch():
    """On the CPU the wrapper takes the plain version: neither count moves,
    whatever the output type."""
    boxes, masks, vecs = _walk_inputs(WALK_CASES["ragged N3 O5 M8 24x40 D13"])
    before = (lk.layout_compose.launches, lk.layout_compose.launches_bf16)
    for dtype in (torch.float32, torch.bfloat16):
        out = lk.layout_compose(boxes, masks, vecs, 24, 40, out_dtype=dtype)
        assert out.dtype == dtype
    assert (lk.layout_compose.launches,
            lk.layout_compose.launches_bf16) == before


# A small shape for the A/B on the CPU: (N, O, M, H, W, D).
AB_SHAPE = (2, 5, 8, 24, 40, 13)


def test_layout_ab_times_this_checkout_in_processes_of_its_own(tmp_path):
    """tools/layout_ab runs each checkout's wrapper in a process of its own
    (two turns), holds its outputs to the plain version and keeps both
    turns; on the CPU the wrapper is the plain version itself.  Its command
    line needs a card."""
    report = layout_ab.compare([], "cpu", AB_SHAPE, iters=1)
    rows = {(r["checkout"], r["out"]): r for r in report["rows"]}
    assert set(rows) == {("this", "f32"), ("this", "bf16")}
    assert rows["this", "f32"]["max_abs_err"] == 0.0
    assert rows["this", "bf16"]["max_abs_err"] <= 2.0 ** -8 * 10
    for row in rows.values():
        assert len(row["turns"]) == 2 and row["ms"] == min(row["turns"])
    _, O, M, H, W, D = AB_SHAPE
    assert report["plan"] == lk.boxes_plan(O, H, W, M, D)._asdict()
    assert layout_ab.main(["--other", str(tmp_path), "--device", "cpu",
                           "--out", str(tmp_path)]) == 1


def test_layout_ab_refuses_a_checkout_whose_k1_disagrees(tmp_path):
    """A checkout whose wrapper is off by one ulp past one rounding fails
    the A/B before any time of it is kept."""
    pkg = tmp_path / "sg2im_tpu_torch"
    for sub in ("", "ops", "tools"):
        (pkg / sub).mkdir(exist_ok=True)
        (pkg / sub / "__init__.py").write_text("")
    (pkg / "ops" / "layout_kernel.py").write_text(
        "import torch\n"
        "def layout_compose(boxes, masks, vecs, H, W,\n"
        "                   out_dtype=torch.float32):\n"
        "    N, D = vecs.shape[0], vecs.shape[-1]\n"
        "    return torch.full((N, H, W, D), 1e-3, dtype=out_dtype)\n")
    (pkg / "tools" / "_measure.py").write_text(
        "def time_ms(fn, device, iters):\n"
        "    fn()\n"
        "    return 1.0\n")
    with pytest.raises(AssertionError, match="other:.*f32 output disagrees"):
        layout_ab.compare([str(tmp_path)], "cpu", AB_SHAPE, iters=1)


def test_within_one_rounding_takes_one_rounding_and_no_more():
    want = torch.tensor([1.0, -3.0, 0.0, 1e-7, 200.0])
    assert _measure.within_one_rounding(want.to(torch.bfloat16), want)
    # One bf16 ulp at 1.0 is 2^-7: twice the bar of 2^-8 |want|.
    off = want.clone()
    off[0] += 2.0 ** -7
    assert not _measure.within_one_rounding(off.to(torch.bfloat16), want)


def test_k1_bound_of_each_output_type():
    """utils/roofline.layout_bounds at the output's element size: the bf16
    layout at b128 is 0.537 GB of 0.540 moved, a 0.1612 ms bound; f32 keeps
    its 1.077 GB and 0.3215 ms."""
    from sg2im_tpu_torch.utils import roofline as R

    shape = chip_smoke.LAYOUT_TIMED
    f32 = R.layout_bounds(*shape, weights=False)
    bf16 = R.layout_bounds(*shape, weights=False, out_elem=2)
    assert f32 == R.layout_bounds(*shape, weights=False, out_elem=4)
    assert f32[0] - bf16[0] == 2 * 128 * 128 * 128 * 128 and f32[1] == bf16[1]
    assert bf16[0] == 540049408
    ms, by = R.roofline_ms(*bf16, R.F32_FLOPS)
    assert by == "bytes" and round(ms, 4) == 0.1612
    assert round(R.roofline_ms(*f32, R.F32_FLOPS)[0], 4) == 0.3215
