"""The layout compose's weights entry (K2) as the CPU can hold it.

* Its kernel's plan (``layout_kernel.weights_plan``, which the wrapper
  passes to the launch): it fits the shared memory budget, stores every
  output element exactly once, and carries sums across object groups only
  where a block holds one row and one pass.
* A plain emulation of the kernel's walk (bands of TH rows, column tiles,
  channel tiles, object groups and chunks, and the ragged edge of each)
  against ``layout_compose_weights_ref``, on every ``KERNEL_CASES`` case of
  ``chip_smoke.py``, dense signed weights included, and on one image of
  every plan shape.  Bar: 1e-5 abs.
* The plain version with dense random signed weights against the JAX
  package's ``fused_layout_compose`` in interpret mode, inputs made with
  numpy from a seed.  Bar: 1e-5 abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sg2im_tpu.ops.pallas.layout_kernel import fused_layout_compose
from sg2im_tpu_torch.ops import layout_kernel as lk
from sg2im_tpu_torch.ops.layout import box_warp_weights

ATOL = 1e-5

# (O, H, W, M, D): the chip cases, the b128 path shape, and cut-offs of the
# plan: the band shrinking with O, narrower column tiles, object groups, a
# D split over channel tiles, W below one pass, M not a multiple of 4.
PLAN_SHAPES = sorted({(O, H, W, M, D) for _, O, M, H, W, D, *_
                      in chip_smoke.KERNEL_CASES.values()} | {
    (16, 128, 128, 16, 128), (64, 128, 128, 16, 128), (160, 64, 256, 8, 64),
    (700, 5, 40, 4, 8), (3, 2, 2, 1, 1), (11, 17, 300, 32, 260),
    (40, 33, 20, 13, 130),
})


def tile_passes(plan, H, W):
    """Per block's tile (band of TH rows from y0, TX columns from x0) the
    passes the kernel computes: (y0, th, x0, tx, [(p0, rows, columns)]),
    pass p0 holding pixels p0 .. p0 + PX - 1 of the tile (row p // TX,
    column p % TX), rows and columns those of them inside the image."""
    TH, TX, PX = plan.TH, plan.TX, plan.PX
    for band in range(plan.n_bands):
        y0 = band * TH
        th = min(TH, H - y0)
        for xt in range(plan.x_tiles):
            x0 = xt * TX
            tx = min(TX, W - x0)
            passes = []
            for p0 in range(0, TH * TX, PX):
                if p0 // TX >= th:
                    break
                if TX >= PX and p0 % TX >= tx:
                    continue
                pix = p0 + torch.arange(PX)
                r, c = pix // TX, pix % TX
                keep = (r < th) & (c < tx)
                passes.append((p0, r[keep], c[keep], keep))
            yield y0, th, x0, tx, passes


def emulate_weights_kernel(wy, wx, masks, vecs, plan):
    """The kernel's walk on the CPU in float32, every image at once.

    Per block (band of TH rows, tile of TX columns, channel tile): per
    object group, R = Wy[band] @ mask and the warp coefficients per chunk
    of oc objects into a (G, TH, TX) tile, zero past the image's last row
    and column; then per pass of PX pixels of the tile the sums over the
    group's objects, carried over groups; stored where the pixels lie in
    the image.  Returns (out, how often each (y, x, d) was stored).
    """
    N, O, H, M = wy.shape
    W, D = wx.shape[2], vecs.shape[-1]
    TH, TX, G, oc, PX = plan.TH, plan.TX, plan.G, plan.oc, plan.PX
    out = torch.full((N, H, W, D), float("nan"))
    hits = torch.zeros((H, W, D), dtype=torch.int32)
    for y0, th, x0, tx, passes in tile_passes(plan, H, W):
        for dt in range(plan.d_tiles):
            d = slice(dt * lk.TILE_D, min(D, (dt + 1) * lk.TILE_D))
            acc = {}
            for g in range(plan.groups):
                ob = g * G
                gn = min(G, O - ob)
                warp = torch.zeros((N, G, TH, TX))
                for c in range(-(-gn // oc)):
                    o = slice(ob + c * oc, ob + min(gn, (c + 1) * oc))
                    band_wy = torch.zeros((N, o.stop - o.start, TH, M))
                    band_wy[:, :, :th] = wy[:, o, y0:y0 + th]
                    tile_wx = torch.zeros((N, o.stop - o.start, TX, M))
                    tile_wx[:, :, :tx] = wx[:, o, x0:x0 + tx]
                    r = band_wy @ masks[:, o]
                    warp[:, o.start - ob:o.stop - ob] = \
                        r @ tile_wx.transpose(-1, -2)
                flat = warp.reshape(N, G, TH * TX)
                for p0, _, _, _ in passes:
                    part = torch.einsum("nop,nod->npd",
                                        flat[:, :gn, p0:p0 + PX],
                                        vecs[:, ob:ob + gn, d])
                    acc[p0] = part + acc.get(p0, 0.0)
            for p0, rows, cols, keep in passes:
                out[:, y0 + rows, x0 + cols, d] = acc[p0][:, keep]
                hits[y0 + rows, x0 + cols, d] += 1
    return out, hits


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_weights_plan_fits_and_stores_every_output_once(shape):
    O, H, W, M, D = shape
    plan = lk.weights_plan(O, H, W, M, D)
    Mr, S = lk.wx_row_pitch(M)
    assert Mr >= M and Mr % 4 == 0 and (S // 4) % 2 == 1
    assert plan.smem <= lk.SMEM_BUDGET
    assert 1 <= plan.TH <= lk.MAX_BAND and 1 <= plan.oc <= lk.MAX_CHUNK
    assert plan.threads <= lk.W_THREADS and plan.PX <= lk.MAX_PX
    # A thread's pixels lie in one row; passes tile the tile.
    assert plan.TX % lk.X_PER == 0 and plan.PX % lk.X_PER == 0
    assert plan.TX % plan.PX == 0 or plan.PX % plan.TX == 0
    assert plan.TH * plan.TX % plan.PX == 0
    assert plan.G * (plan.groups - 1) < O <= plan.G * plan.groups
    if plan.groups > 1:  # sums carried in registers: a tile of one pass
        assert (plan.TH, plan.TX) == (1, plan.PX)
    # Every output pixel is stored exactly once, every channel once.
    hits = torch.zeros((H, W), dtype=torch.int32)
    for y0, _, x0, _, passes in tile_passes(plan, H, W):
        for _, rows, cols, _ in passes:
            hits[y0 + rows, x0 + cols] += 1
    assert bool((hits == 1).all())
    assert plan.d_tiles * lk.TILE_D >= D > (plan.d_tiles - 1) * lk.TILE_D


def test_weights_plan_at_the_b128_shape():
    """The flagship shape: tiles of 32 rows by 32 columns (80 KB staged per
    tile, 80 B per output pixel, against 148 KB and 296 B for bands of 4
    whole rows), all 16 objects in one group staged in chunks of 2, passes
    of two 32-pixel row segments, two blocks per SM."""
    plan = lk.weights_plan(16, 128, 128, 16, 128)
    assert plan == lk.WeightsPlan(TH=32, TX=32, G=16, oc=2, PX=64,
                                  threads=256, n_bands=4, x_tiles=4,
                                  d_tiles=1, groups=1, smem=100352)
    assert 2 * plan.smem <= 228 * 1024 - 2 * 1024


def _case_inputs(case, seed):
    N, O, M, H, W, D, degenerate, dense = case
    boxes, masks, vecs = chip_smoke.layout_inputs(
        N, O, M, H, W, D, seed, degenerate, device="cpu")
    if dense:
        wy, wx = chip_smoke.dense_weights(torch, N, O, M, H, W, seed,
                                          device="cpu")
    else:
        wy, wx = box_warp_weights(boxes, H, W, M, M)
    return wy, wx, masks, vecs


# The walk's inputs: the chip cases, and one image with the boxes' tents
# for each plan shape (the plan's cut-offs: object groups, a D split, W
# below one pass, M not a multiple of 4).  Tents, not dense weights: with
# hundreds of objects summed in groups, dense weights give |out| near 18,
# where the f32 orders of the walk and the einsum part by about 1e-5.
WALK_CASES = {**chip_smoke.KERNEL_CASES,
              **{f"plan O{O} {H}x{W} M{M} D{D}": (1, O, M, H, W, D, False,
                                                 False)
                 for O, H, W, M, D in PLAN_SHAPES}}


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_kernel_walk_matches_plain_version(name):
    case = WALK_CASES[name]
    N, O, M, H, W, D = case[:6]
    wy, wx, masks, vecs = _case_inputs(case, seed=3)
    plan = lk.weights_plan(O, H, W, M, D)
    got, hits = emulate_weights_kernel(wy, wx, masks, vecs, plan)
    assert bool((hits == 1).all())
    want = lk.layout_compose_weights_ref(wy, wx, masks, vecs)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# (N, O, H, W, M, D)
DENSE_SHAPES = {
    "square": (2, 4, 32, 32, 8, 12),
    "odd_24x40_O5": (2, 5, 24, 40, 8, 16),
    "M32_16x24": (1, 3, 16, 24, 32, 10),
}


@pytest.mark.parametrize("name", sorted(DENSE_SHAPES))
def test_dense_signed_weights_match_pallas(name):
    """The plain version against fused_layout_compose with weights that
    are not tents: dense, signed, every tap non-zero."""
    N, O, H, W, M, D = DENSE_SHAPES[name]
    _, masks, vecs = chip_smoke.layout_inputs(N, O, M, H, W, D, seed=5,
                                              device="cpu")
    wy, wx = chip_smoke.dense_weights(torch, N, O, M, H, W, seed=5,
                                      device="cpu")
    assert (wy < 0).any() and (wx < 0).any() and bool((wy != 0).all())
    want = np.asarray(fused_layout_compose(
        *(jnp.asarray(t.numpy()) for t in (wy, wx, masks, vecs)), True))
    got = lk.layout_compose_weights_ref(wy, wx, masks, vecs)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    emulated, _ = emulate_weights_kernel(
        wy, wx, masks, vecs, lk.weights_plan(O, H, W, M, D))
    np.testing.assert_allclose(emulated.numpy(), want, atol=ATOL)
