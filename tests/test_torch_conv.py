"""Port parity: the 3x3 conv kernel's plain versions
(sg2im_tpu_torch/ops/conv_kernel.py) against the JAX side, on the CPU.

* ``conv3x3_ref`` against the TPU prototype's Pallas body
  (``scripts/proto_pallas_conv.py::make_conv_kernel``), run in interpret
  mode as ``build`` calls it, with and without its epilogue.  Bar: 2e-6 of
  max |out| for float32 output (both sum bf16 products in float32, in
  another order); one bf16 rounding for bf16 output.
* ``conv3x3_int8_ref`` against ``lax.conv_general_dilated`` with int32
  accumulation: the int32 sums are equal (the float64 route is exact) and
  the dequantized output is within 1 ulp.
* The wrappers on CPU tensors: plain version, no launch counted, bad
  input rejected.
* What surrounds the Hopper kernel, which runs only on the card: the
  weight packing round-trips to the OIHW weight and zero-pads; the tile
  plan stores every output pixel and channel exactly once; a plain
  emulation of the kernel's walk (TMA boxes shifted per tap, packed weight
  tiles) gives exactly the int32 sums and the bf16 conv within the bar
  above; inputs the tensor map cannot take go through one padded copy.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sg2im_tpu_torch.ops import conv_kernel as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_BAR = 2e-6  # float32 output: max abs error / max |out|


def _proto_module():
    """scripts/proto_pallas_conv.py with the Pallas globals its main()
    would set."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location(
        "proto_pallas_conv",
        os.path.join(REPO, "scripts", "proto_pallas_conv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl, mod.pltpu = pl, pltpu
    return mod, pl, pltpu


def pallas_conv(x, w, scale, bias, TH, epilogue, out_dtype):
    """The prototype's pallas_call (``build``, :114-147) in interpret
    mode: x (N, H, W, Cin), w (3, 3, Cin, Co) -> (N, H, W, Co)."""
    mod, pl, pltpu = _proto_module()
    N, H, W, CIN = x.shape
    CO = w.shape[-1]
    n_htiles = H // TH
    kern = mod.make_conv_kernel(TH, W, CIN, CO, n_htiles, "im2col",
                                epilogue)

    def blk(f):
        return pl.BlockSpec((1, TH, W, CIN), lambda n, h: (n, f(h), 0, 0))

    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((N, H, W, CO), out_dtype),
        grid=(N, n_htiles),
        in_specs=[
            blk(lambda h: jnp.maximum(h - 1, 0)),
            blk(lambda h: h),
            blk(lambda h: jnp.minimum(h + 1, n_htiles - 1)),
            pl.BlockSpec((9 * CIN, CO), lambda n, h: (0, 0)),
            pl.BlockSpec((1, CO), lambda n, h: (0, 0)),
            pl.BlockSpec((1, CO), lambda n, h: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, TH, W, CO), lambda n, h: (n, h, 0, 0)),
        scratch_shapes=[pltpu.VMEM((TH + 2, W + 2, CIN), x.dtype),
                        pltpu.VMEM((TH * W, 9 * CIN), x.dtype)],
        interpret=True,
    )(x, x, x, w.reshape(9 * CIN, CO), scale, bias)


def conv_operands(N, H, W, Cin, Co, seed):
    """bf16-representable x (N, H, W, Cin), w (3, 3, Cin, Co) and f32
    scale, bias (Co,) as numpy float32."""
    rng = np.random.RandomState(seed)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    x = bf16(rng.randn(N, H, W, Cin))
    w = bf16(rng.randn(3, 3, Cin, Co) * (2.0 / (9 * Cin)) ** 0.5)
    scale = (rng.rand(Co) + 0.5).astype(np.float32)
    bias = (rng.randn(Co) * 0.1).astype(np.float32)
    return x, w, scale, bias


def to_port(x, w):
    """NHWC / HWIO numpy -> the port's NCHW (channels_last) / OIHW bf16."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    return xt.contiguous(memory_format=torch.channels_last), \
        wt.to(torch.bfloat16)


@pytest.mark.parametrize("epilogue", [False, True])
def test_conv3x3_ref_matches_pallas_body(epilogue):
    # Two tile rows (H = 8, TH = 4), Cin not a multiple of 8.
    x, w, scale, bias = conv_operands(2, 8, 8, 12, 8, seed=int(epilogue))
    want = np.asarray(pallas_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(scale[None]), jnp.asarray(bias[None]), 4, epilogue,
        jnp.float32))
    xt, wt = to_port(x, w)
    ep = ((torch.from_numpy(scale), torch.from_numpy(bias)) if epilogue
          else (None, None))
    got = ck.conv3x3_ref(xt, wt, *ep).permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= PALLAS_BAR, err
    if epilogue:
        assert (want < 0).any() and (want > 0).any()  # LeakyReLU ran


def test_conv3x3_ref_bf16_output_matches_pallas_body():
    x, w, scale, bias = conv_operands(1, 8, 16, 20, 24, seed=3)
    want = np.asarray(pallas_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(scale[None]), jnp.asarray(bias[None]), 4, True,
        jnp.bfloat16), np.float32)
    xt, wt = to_port(x, w)
    got = ck.conv3x3_ref(xt, wt, torch.from_numpy(scale),
                         torch.from_numpy(bias), out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    # Both round an f32 sum to bf16; the sums may straddle a rounding
    # boundary, so one bf16 ulp of the value.
    bound = np.abs(want) * 2.0 ** -7 + 1e-6
    assert (np.abs(got - want) <= bound).all()


def jax_int8_conv(xq, wq):
    """int32 sums of lax.conv_general_dilated on NHWC / HWIO int8."""
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("shape", [(1, 5, 6, 512, 16), (2, 13, 29, 36, 20)])
def test_conv3x3_int8_ref_is_exact(shape):
    N, H, W, Cin, Co = shape
    rng = np.random.RandomState(Cin)
    xq = rng.randint(-127, 128, (N, H, W, Cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, Cin, Co)).astype(np.int8)
    # Extremes: all +127 against all +127 / -127 filters reach
    # |acc| = 9 * Cin * 127^2 (7.4e7 at Cin = 512), past float32's 2^24.
    xq[0, 1:4, 1:4] = 127
    wq[..., 0] = 127
    wq[..., 1] = -127
    want_acc = jax_int8_conv(xq, wq)
    if Cin == 512:
        assert np.abs(want_acc).max() == 9 * 512 * 127 ** 2 > 2 ** 24
    xt = torch.from_numpy(xq).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    wt = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1)))
    acc = ck.conv3x3_int8_acc(xt, wt)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)

    dq = (rng.rand(Co) * 1e-4 + 1e-7).astype(np.float32)
    want = want_acc.astype(np.float32) * dq
    got = ck.conv3x3_int8(xt, wt, torch.from_numpy(dq))
    got = got.permute(0, 2, 3, 1).contiguous().numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    x, w, scale, bias = conv_operands(1, 6, 7, 10, 5, seed=5)
    xt, wt = to_port(x, w)
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    xq = torch.randint(-127, 128, (1, 10, 6, 7), dtype=torch.int8)
    wq = torch.randint(-127, 128, (5, 10, 3, 3), dtype=torch.int8)
    dq = torch.rand(5)
    before = (ck.conv3x3.launches, ck.conv3x3_int8.launches)
    assert torch.equal(ck.conv3x3(xt, wt, s, b), ck.conv3x3_ref(xt, wt, s, b))
    assert torch.equal(ck.conv3x3(xt, wt, out_dtype=torch.bfloat16),
                       ck.conv3x3_ref(xt, wt, out_dtype=torch.bfloat16))
    assert torch.equal(ck.conv3x3_int8(xq, wq, dq),
                       ck.conv3x3_int8_ref(xq, wq, dq))
    assert (ck.conv3x3.launches, ck.conv3x3_int8.launches) == before


def test_wrappers_reject_bad_input():
    xt = torch.zeros((1, 4, 5, 5), dtype=torch.bfloat16)
    wt = torch.zeros((3, 4, 3, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weight must be"):
        ck.conv3x3(xt, wt[:, :3])
    with pytest.raises(ValueError, match="x must be"):
        ck.conv3x3(xt[0], wt)
    with pytest.raises(ValueError, match="both scale and bias"):
        ck.conv3x3(xt, wt, scale=torch.ones(3))
    with pytest.raises(TypeError, match="out_dtype"):
        ck.conv3x3(xt, wt, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="int8"):
        ck.conv3x3_int8(xt, wt.to(torch.int8), torch.ones(3))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.conv3x3(xt.to("meta"), wt.to("meta"))


# ---------------------------------------------------------------------------
# What surrounds the Hopper kernel: its weight packing and tile plan, and a
# plain emulation of the kernel's walk over both.
# ---------------------------------------------------------------------------

# (N, H, W, Cin, Co): ragged Cin and Co, H and W not multiples of a tile,
# H = W = 1, W wider than a tile, several Cin chunks, several Co tiles.
KERNEL_PLAN_SHAPES = [(2, 13, 29, 36, 20), (3, 1, 1, 24, 8),
                      (1, 5, 150, 40, 72), (2, 6, 8, 160, 200),
                      (1, 9, 7, 20, 300)]
ELEMS = {"bf16": (torch.bfloat16, 2), "int8": (torch.int8, 1)}


def _random(dtype, shape, gen):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen).to(dtype)


def unswizzled_tiles(packed):
    """The packed tiles with the 128-byte swizzle undone: (co_tiles,
    n_chunks, 9, BN, chunk), element [.., r, k] = weight channel k of the
    chunk for output channel r of the tile.  Stored 16-byte unit j of row
    r holds unit j ^ (r % 8), and XOR is its own inverse."""
    ct, nch, _, BN, ch = packed.shape
    rows = torch.arange(BN)[:, None]
    units = torch.arange(8)[None, :] ^ (rows % 8)
    w = packed.reshape(ct, nch, 9, BN, 8, ch // 8)
    return w[:, :, :, rows, units].reshape(packed.shape)


def unpack_weights(packed, Co, Cin):
    """The OIHW weight back from the packed tiles."""
    ct, nch, _, BN, ch = packed.shape
    w = unswizzled_tiles(packed).permute(0, 3, 1, 4, 2)
    return w.reshape(ct * BN, nch * ch, 3, 3)[:Co, :Cin]


def stored_blocks(N, H, W, Co, plan):
    """Per block of the kernel's grid (n, pixel tile, Co tile), the output
    rows and channels it stores: (n, tile rows r, tile columns c, y, x, co)
    with r, c indexing the block's TILE_M rows as row m = r * TW + c."""
    for n in range(N):
        for th in range(plan.tiles_h):
            for tw in range(plan.tiles_w):
                m = torch.arange(ck.TILE_M)
                r, c = m // plan.TW, m % plan.TW
                y, x = th * plan.TH + r, tw * plan.TW + c
                keep = (r < plan.TH) & (y < H) & (x < W)
                for ct in range(plan.co_tiles):
                    co = ct * plan.BN + torch.arange(plan.BN)
                    yield n, th, tw, ct, m[keep], y[keep], x[keep], \
                        co[co < Co]


def emulate_kernel(x, weight):
    """The kernel's walk on the CPU: for each block, K steps of (Cin chunk,
    tap), A a TMA box of the NHWC input shifted by the tap with zeros
    outside, B the packed tile; int8 sums in int64, bf16 in float64.
    Returns the NHWC sums."""
    N, Cin, H, W = x.shape
    Co = weight.shape[0]
    exact = x.dtype == torch.int8
    acc_t = torch.int64 if exact else torch.float64
    plan = ck.tile_plan(H, W, Cin, Co, x.element_size())
    tiles = unswizzled_tiles(ck.pack_weights(weight, plan)).to(acc_t)
    ch = plan.chunk
    # Zero border: box coordinates run from -1 to tiles * tile.
    xp = torch.zeros((N, plan.tiles_h * plan.TH + 2,
                      plan.tiles_w * plan.TW + 2, plan.n_chunks * ch),
                     dtype=acc_t)
    xp[:, 1:H + 1, 1:W + 1, :Cin] = x.permute(0, 2, 3, 1).to(acc_t)
    out = torch.zeros((N, H, W, Co), dtype=acc_t)
    for n, th, tw, ct, m, y, xs, co in stored_blocks(N, H, W, Co, plan):
        h0, w0 = th * plan.TH, tw * plan.TW
        acc = torch.zeros((ck.TILE_M, plan.BN), dtype=acc_t)
        for chunk in range(plan.n_chunks):
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                box = xp[n, h0 + ky:h0 + ky + plan.TH,
                         w0 + kx:w0 + kx + plan.TW,
                         chunk * ch:(chunk + 1) * ch]
                a = torch.zeros((ck.TILE_M, ch), dtype=acc_t)
                a[:plan.TH * plan.TW] = box.reshape(-1, ch)
                acc += a @ tiles[ct, chunk, tap].T
        out[n, y[:, None], xs[:, None], co[None, :]] = \
            acc[m][:, co - ct * plan.BN]
    return out


@pytest.mark.parametrize("elem", sorted(ELEMS))
@pytest.mark.parametrize("shape", KERNEL_PLAN_SHAPES)
def test_pack_weights_round_trips_and_zero_pads(shape, elem):
    _, H, W, Cin, Co = shape
    dtype, size = ELEMS[elem]
    w = _random(dtype, (Co, Cin, 3, 3), torch.Generator().manual_seed(Cin))
    plan = ck.tile_plan(H, W, Cin, Co, size)
    packed = ck.pack_weights(w, plan)
    assert packed.dtype == dtype and packed.is_contiguous()
    assert packed.shape == (plan.co_tiles, plan.n_chunks, 9, plan.BN,
                            plan.chunk)
    assert plan.chunk * size == ck.CHUNK_BYTES
    assert torch.equal(unpack_weights(packed, Co, Cin), w)
    whole = unpack_weights(packed, plan.co_tiles * plan.BN,
                              plan.n_chunks * plan.chunk)
    assert not whole[Co:].any() and not whole[:, Cin:].any()
    # The swizzle moves 16-byte units within a row only: row r's unit k of
    # a tile holds unit k ^ (r % 8) of the plain layout.
    plain = unswizzled_tiles(packed)
    r = 5
    unit = plan.chunk // 8
    got = packed[0, 0, 4, r].reshape(8, unit)
    assert torch.equal(got, plain[0, 0, 4, r].reshape(8, unit)[
        torch.arange(8) ^ r])


@pytest.mark.parametrize("shape", KERNEL_PLAN_SHAPES + [(2, 32, 32, 8, 256),
                                                        (1, 64, 64, 8, 128),
                                                        (1, 3, 300, 8, 64)])
def test_tile_plan_covers_every_output_once(shape):
    N, H, W, Cin, Co = shape
    for size in (1, 2):
        plan = ck.tile_plan(H, W, Cin, Co, size)
        assert 1 <= plan.TH * plan.TW <= ck.TILE_M
        assert plan.BN in (128, 256) and plan.co_tiles * plan.BN >= Co
        assert plan.n_chunks * plan.chunk >= Cin
        hits = torch.zeros((N, H, W, Co), dtype=torch.int32)
        for n, _, _, _, _, y, x, co in stored_blocks(N, H, W, Co, plan):
            hits[n, y[:, None], x[:, None], co[None, :]] += 1
        assert bool((hits == 1).all())


@pytest.mark.parametrize("shape", KERNEL_PLAN_SHAPES)
def test_kernel_emulation_matches_plain_versions(shape):
    N, H, W, Cin, Co = shape
    gen = torch.Generator().manual_seed(H * W + Co)
    cl = torch.channels_last
    xq = _random(torch.int8, (N, Cin, H, W), gen).contiguous(memory_format=cl)
    wq = _random(torch.int8, (Co, Cin, 3, 3), gen)
    want = ck.conv3x3_int8_acc(xq, wq).permute(0, 2, 3, 1)
    assert torch.equal(emulate_kernel(xq, wq), want.long())

    x, w, _, _ = conv_operands(N, H, W, Cin, Co, seed=Cin)
    xt, wt = to_port(x, w)
    want = ck.conv3x3_ref(xt, wt).permute(0, 2, 3, 1)
    got = emulate_kernel(xt, wt).float()
    err = (got - want).abs().max() / want.abs().max()
    assert err <= PALLAS_BAR, err


def test_tma_input_pads_what_the_tensor_map_cannot_take():
    gen = torch.Generator().manual_seed(0)
    wrapper = ck.conv3x3_int8
    before = wrapper.padded_copies
    ok = _random(torch.int8, (2, 32, 3, 4), gen).contiguous(
        memory_format=torch.channels_last)
    assert ck._tma_input(ok, wrapper) == (ok, 32)
    ragged = ok[:, :20].contiguous(memory_format=torch.channels_last)
    got, cin = ck._tma_input(ragged, wrapper)
    assert cin == 32 and got.shape == (2, 3, 4, 32)
    assert torch.equal(got[..., :20], ragged.permute(0, 2, 3, 1))
    assert not got[..., 20:].any()
    bf = _random(torch.bfloat16, (1, 2 * 8 * 5 * 3 + 1), gen)[0, 1:]
    shifted = bf.view(2, 5, 3, 8).permute(0, 3, 1, 2)  # off 16-B alignment
    assert shifted.data_ptr() % 16 != 0
    got, cin = ck._tma_input(shifted, wrapper)
    assert cin == 8 and torch.equal(got, shifted.permute(0, 2, 3, 1))
    assert wrapper.padded_copies == before + 2
