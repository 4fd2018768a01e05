"""The Hopper kernels (layout compose, 3x3 conv, relayout, threefry) against
their plain versions, on the card.

These tests need a CUDA card and nvcc; they carry the ``cuda`` marker and
skip elsewhere.  On the card, where JAX (which tests/conftest.py imports)
need not be installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The comparisons are those of ``chip_smoke.py`` phases 3 to 5b (layout
compose: 1e-5 abs; conv: s8 within 1 ulp, bf16 within 1e-4 of max |out|;
relayout: bit-equal; threefry: bits bit-equal, normals within 1e-6), of
its serving phase (the server's launches per
engine call; the on-device deprocess bit-equal to the host's; noise on the
card used where it lies), of its training phase (the kernels'
gradients, a full-width step, the NaN guard) and of its training CLI
phase (``prefetch_to_device`` bit-equal to the host batches).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sg2im_tpu_torch.inference import full_fp32
from sg2im_tpu_torch.nn import crn as tcrn
from sg2im_tpu_torch.nn.layers import upsample_nearest
from sg2im_tpu_torch.ops import conv_kernel as ck
from sg2im_tpu_torch.ops import layout as tlayout
from sg2im_tpu_torch.ops import layout_kernel as lk
from sg2im_tpu_torch.ops import relayout as rl
from sg2im_tpu_torch.ops.prng import prng_key

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with torch.inference_mode(), full_fp32():
        yield torch.device("cuda")


@pytest.mark.parametrize("name", sorted(chip_smoke.KERNEL_CASES))
def test_kernel_entries_match_plain_version(card, name):
    errs = chip_smoke.check_kernel_case(torch, name,
                                        *chip_smoke.KERNEL_CASES[name])
    assert max(errs.values()) <= chip_smoke.KERNEL_BAR


def test_masks_to_layout_auto_launches_the_kernel(card):
    boxes, masks, vecs = chip_smoke.layout_inputs(2, 5, 8, 24, 40, 16,
                                                  seed=3)
    obj_mask = torch.tensor([[1, 1, 0, 1, 0], [1, 0, 1, 1, 1]],
                            dtype=torch.float32, device=card)
    before = lk.layout_compose.launches
    for pooling in ("sum", "avg"):
        got = tlayout.masks_to_layout(vecs, boxes, masks, obj_mask, 24, 40,
                                      pooling=pooling)
        want = tlayout.masks_to_layout(vecs, boxes, masks, obj_mask, 24, 40,
                                       pooling=pooling, backend="torch")
        assert (got - want).abs().max().item() <= chip_smoke.KERNEL_BAR
    assert lk.layout_compose.launches == before + 2


def test_masks_to_layout_with_weights_launches_the_weights_kernel(card):
    boxes, masks, vecs = chip_smoke.layout_inputs(2, 5, 8, 24, 40, 16,
                                                  seed=3)
    weights = chip_smoke.dense_weights(torch, 2, 5, 8, 24, 40, seed=3)
    obj_mask = torch.tensor([[1, 1, 0, 1, 0], [1, 0, 1, 1, 1]],
                            dtype=torch.float32, device=card)
    before = (lk.layout_compose.launches, lk.layout_compose_weights.launches)
    for pooling in ("sum", "avg"):
        got = tlayout.masks_to_layout(vecs, boxes, masks, obj_mask, 24, 40,
                                      pooling=pooling, weights=weights)
        assert lk.layout_compose_weights.launches == before[1] + (
            1 if pooling == "sum" else 2)
        want = tlayout.masks_to_layout(vecs, boxes, masks, obj_mask, 24, 40,
                                       pooling=pooling, backend="torch",
                                       weights=weights)
        assert (got - want).abs().max().item() <= chip_smoke.KERNEL_BAR
    assert lk.layout_compose.launches == before[0]


def test_weights_entry_refuses_a_tile_it_cannot_run(card):
    """The C entry takes its tile from the wrapper's plan and refuses, with
    cudaErrorInvalidValue (1), one that breaks the kernel's layout."""
    from sg2im_tpu_torch.ops._build import load_library

    N, O, M, H, W, D = 1, 3, 8, 16, 16, 8
    _, masks, vecs = chip_smoke.layout_inputs(N, O, M, H, W, D, seed=4)
    wy, wx = chip_smoke.dense_weights(torch, N, O, M, H, W, seed=4)
    out = torch.empty((N, H, W, D), device=card)
    plan = lk.weights_plan(O, H, W, M, D)

    def launch(p):
        rc = load_library().sg2im_layout_compose_weights(
            wy.data_ptr(), wx.data_ptr(), masks.data_ptr(), vecs.data_ptr(),
            out.data_ptr(), N, O, H, W, M, D, 0, p.TH, p.TX, p.G, p.oc,
            p.PX, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return rc

    assert launch(plan) == 0
    want = lk.layout_compose_weights_ref(wy, wx, masks, vecs)
    assert (out - want).abs().max().item() <= chip_smoke.KERNEL_BAR
    for bad in (plan._replace(TX=12), plan._replace(PX=136),
                plan._replace(TH=33), plan._replace(oc=plan.G + 1),
                plan._replace(G=1, TH=2)):
        assert launch(bad) == 1, bad


def test_boxes_entry_refuses_a_tile_it_cannot_run(card):
    """The boxes entry takes its tile (TH, TX, G) from the wrapper's
    boxes_plan, runs other tiles it can hold (one object a group on a tile
    of one pass included) to the same result, and refuses, with
    cudaErrorInvalidValue (1), one that breaks the kernel's layout."""
    from sg2im_tpu_torch.ops._build import load_library

    N, O, M, H, W, D = 2, 5, 8, 24, 40, 16
    boxes, masks, vecs = chip_smoke.layout_inputs(N, O, M, H, W, D, seed=4)
    out = torch.empty((N, H, W, D), device=card)
    want = lk.layout_compose_ref(boxes, masks, vecs, H, W)
    plan = lk.boxes_plan(O, H, W, M, D)

    def launch(TH, TX, G):
        out.fill_(float("nan"))
        rc = load_library().sg2im_layout_compose_boxes(
            boxes.data_ptr(), masks.data_ptr(), vecs.data_ptr(),
            out.data_ptr(), N, O, H, W, M, D, 0, TH, TX, G,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return rc

    for tile in ((plan.TH, plan.TX, plan.G), (1, 32, 1), (8, 4, O),
                 (2, 64, 2)):
        assert launch(*tile) == 0, tile
        assert (out - want).abs().max().item() <= chip_smoke.KERNEL_BAR, tile
    # TX not a power of two, TH past 32, TX past 128 or under 4, G past O
    # or 0, groups on a tile of many passes, shared memory past the budget.
    for bad in ((4, 12, O), (64, 8, O), (4, 256, O), (4, 2, O),
                (4, 8, O + 1), (4, 8, 0), (32, 32, 1), (32, 128, O)):
        assert launch(*bad) == 1, bad


def test_boxes_entry_counts_its_bf16_launches(card):
    boxes, masks, vecs = chip_smoke.layout_inputs(2, 5, 8, 24, 40, 16,
                                                  seed=2)
    before = (lk.layout_compose.launches, lk.layout_compose.launches_bf16)
    lk.layout_compose(boxes, masks, vecs, 24, 40)
    lk.layout_compose(boxes, masks, vecs, 24, 40, out_dtype=torch.bfloat16)
    assert (lk.layout_compose.launches,
            lk.layout_compose.launches_bf16) == (before[0] + 2, before[1] + 1)


def test_wrappers_reject_what_the_kernel_does_not_take(card):
    boxes, masks, vecs = chip_smoke.layout_inputs(1, 3, 8, 16, 16, 8, seed=4)
    with pytest.raises(TypeError, match="float32"):
        lk.layout_compose(boxes, masks, vecs.double(), 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        lk.layout_compose(boxes, masks.transpose(2, 3), vecs, 16, 16)
    with pytest.raises(ValueError, match="H >= 2"):
        lk.layout_compose(boxes, masks, vecs, 1, 16)
    big = torch.rand(1, 3, 64, 64, device=card)
    with pytest.raises(ValueError, match="mask side"):
        lk.layout_compose(boxes, big, vecs, 16, 16)
    with pytest.raises(TypeError, match="out_dtype"):
        lk.layout_compose(boxes, masks, vecs, 16, 16, out_dtype=torch.half)


@pytest.mark.parametrize("name", sorted(chip_smoke.CONV_CASES))
def test_conv_entries_match_plain_versions(card, name):
    before = (ck.conv3x3.launches, ck.conv3x3_int8.launches)
    chip_smoke.check_conv_case(torch, name, *chip_smoke.CONV_CASES[name])
    assert (ck.conv3x3.launches, ck.conv3x3_int8.launches) == \
        (before[0] + 3, before[1] + 1)


def test_int8_upsample_feeds_the_kernel(card):
    t = chip_smoke.conv_inputs(torch, 2, 9, 11, 40, 24, seed=5)
    up = upsample_nearest(t["x8"], 2)
    assert up.is_contiguous(memory_format=torch.channels_last)
    s = torch.tensor(0.01, device=card)
    w = torch.randn(24, 40, 3, 3, device=card)
    got = tcrn._conv_int8(up, w, s)
    kq, sw = tcrn._quant_weight_int8(w)
    want = ck.conv3x3_int8_ref(up, kq, s * sw)
    assert torch.equal(got, want)


def test_conv_wrappers_reject_what_the_kernel_does_not_take(card):
    t = chip_smoke.conv_inputs(torch, 1, 8, 8, 16, 8, seed=6)
    with pytest.raises(ValueError, match="channels_last"):
        ck.conv3x3_int8(t["x8"].contiguous(), t["w8"], t["dq"])
    with pytest.raises(TypeError, match="int8"):
        ck.conv3x3_int8(t["xb"], t["w8"], t["dq"])
    with pytest.raises(ValueError, match="dq must be"):
        ck.conv3x3_int8(t["x8"], t["w8"], t["dq"].double())
    with pytest.raises(TypeError, match="bfloat16"):
        ck.conv3x3(t["xb"].float(), t["wb"])
    with pytest.raises(ValueError, match="different devices"):
        ck.conv3x3(t["xb"], t["wb"].cpu())


# Both entries in f32 and bf16, ragged runs, an unaligned input, int8.
RELAYOUT_CASES = {
    **chip_smoke.RELAYOUT_RAGGED,
    "s2d N2 C160 16x16 bf16": ("s2d", (2, 160, 16, 16), "bfloat16", 0),
    "s2d N2 C64 8x12 f32": ("s2d", (2, 64, 8, 12), "float32", 0),
    "d2s N2 C1024 4x4 bf16": ("d2s", (2, 1024, 4, 4), "bfloat16", 0),
    "d2s N2 C12 8x8 f32": ("d2s", (2, 12, 8, 8), "float32", 0),
}


@pytest.mark.parametrize("name", sorted(RELAYOUT_CASES))
def test_relayout_entries_equal_plain_version(card, name):
    wrapper = chip_smoke.relayout_entry(RELAYOUT_CASES[name][0])[0]
    before = wrapper.launches
    assert chip_smoke.check_relayout_case(torch, name,
                                          *RELAYOUT_CASES[name]) == 0.0
    assert wrapper.launches == before + 1


def test_relayout_wrappers_reject_what_the_kernel_does_not_take(card):
    x = torch.randn(2, 8, 4, 6, device=card)  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        rl.space_to_depth(x)
    with pytest.raises(ValueError, match="channels_last"):
        rl.depth_to_space(x)
    with torch.inference_mode(False):
        # A gradient is taken: the backward is the other entry.
        g = torch.randn(2, 8, 4, 6, device=card, requires_grad=True)
        gy = torch.randn(2, 32, 2, 3, device=card)
        before = rl.depth_to_space.launches
        (got,) = torch.autograd.grad(
            rl.space_to_depth(g.contiguous(
                memory_format=torch.channels_last)), g, gy)
        assert rl.depth_to_space.launches == before + 1
        assert torch.equal(got, rl.depth_to_space_ref(gy))


def test_packed_generator_launches_the_relayout_kernel(card):
    """A packed vg-shaped generator at 64x64 on the card: its 32x32 and
    64x64 stages and the head run packed, through both K3 entries, and
    the images agree with the CPU's plain path."""
    from sg2im_tpu_torch.models import Sg2ImGenerator

    vocab, kwargs = chip_smoke.vg128_config()
    kwargs = dict(kwargs, image_size=(64, 64),
                  refinement_dims=(64, 32, 16, 8), crn_mode="packed")
    model = Sg2ImGenerator(vocab, **kwargs)
    model.reset_parameters(prng_key(0))
    model.eval()
    gen = torch.Generator().manual_seed(1)
    args = (torch.randint(1, 179, (2, 8), generator=gen),
            torch.randint(0, 8, (2, 12, 3), generator=gen),
            torch.ones(2, 8), torch.ones(2, 12),
            torch.randn(2, 32, 64, 64, generator=gen))
    want = model(*args)[0]
    gpu = model.to(card, memory_format=torch.channels_last)
    cuda_args = [a.to(card) for a in args]
    cuda_args[4] = cuda_args[4].contiguous(memory_format=torch.channels_last)
    before = (rl.space_to_depth.launches, rl.depth_to_space.launches)
    got = gpu(*cuda_args)[0]
    torch.cuda.synchronize()
    # s2d of the 32x32 and 64x64 levels; d2s at their boundary and after
    # the head.
    assert (rl.space_to_depth.launches - before[0],
            rl.depth_to_space.launches - before[1]) == (2, 2)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_server_b128_reply_launches_k1_once_per_engine_call(card, tmp_path):
    """The port's server at vg128 full width in bf16/split: a batch-128
    request is one engine call and one launch of the layout kernel."""
    ckpt = str(tmp_path / "vg128.pt")
    vocab = chip_smoke.write_vg128_checkpoint(torch, ckpt)
    graphs = chip_smoke.random_graphs(vocab, 128, np.random.RandomState(0))
    with chip_smoke.SmokeServer(
            ["--checkpoint", ckpt, "--device", "cuda", "--bf16", "1",
             "--crn_mode", "split", "--warmup", "1",
             "--max_graphs", "128"]) as server:
        calls0 = server.state.batcher.engine_calls
        before = lk.layout_compose.launches
        reply = server.post({"scene_graphs": graphs, "seed": 1,
                             "return": "npy"})
        calls = server.state.batcher.engine_calls - calls0
        assert chip_smoke.reply_images(reply).shape == (128, 128, 128, 3)
        assert calls == 1
        assert lk.layout_compose.launches - before == calls


def test_deprocess_on_device_equals_host_path(card):
    from sg2im_tpu_torch.data import (imagenet_deprocess_batch,
                                      imagenet_deprocess_batch_torch)

    gen = torch.Generator(device=card).manual_seed(0)
    imgs = torch.randn((8, 3, 128, 128), generator=gen, device=card)
    nhwc = imgs.contiguous(memory_format=torch.channels_last).permute(
        0, 2, 3, 1)
    got = imagenet_deprocess_batch_torch(nhwc)
    assert got.is_cuda and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  imagenet_deprocess_batch(nhwc.cpu().numpy()))


def test_device_noise_makes_no_host_copy(card):
    """Explicit noise already on the card is used in place (rows padded on
    the card): no copy between host and card, and the images equal those
    of the same noise handed over as a numpy array."""
    from torch.autograd import DeviceType

    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.models import Sg2ImGenerator

    vocab, kwargs = chip_smoke.vg128_config()
    kwargs = dict(kwargs, image_size=(64, 64), refinement_dims=(64, 32, 16, 8))
    model = Sg2ImGenerator(vocab, **kwargs)
    model.reset_parameters(prng_key(0))
    engine = InferenceEngine(vocab, kwargs, model.state_dict(), device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    noise = torch.randn((4, 64, 64, 32), generator=gen, device=card)
    assert engine._noise(noise, 0, 4).data_ptr() == noise.data_ptr()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA], acc_events=True) as prof:
        padded = engine._noise(noise[:3], 0, 4)
        torch.cuda.synchronize()
    events = prof.events()
    assert any(e.device_type == DeviceType.CUDA for e in events)
    assert not [e.name for e in events if "Memcpy" in e.name
                and ("HtoD" in e.name or "DtoH" in e.name)]
    assert torch.equal(padded[:3], noise[:3].permute(0, 3, 1, 2))
    assert not padded[3].any()
    graphs = chip_smoke.random_graphs(vocab, 3, np.random.RandomState(2))
    a, _ = engine.generate(graphs, noise=noise[:3])
    b, _ = engine.generate(graphs, noise=noise[:3].cpu().numpy())
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(chip_smoke.THREEFRY_CASES))
def test_threefry_matches_plain_version(card, name):
    """chip_smoke's threefry cases: bits bit-equal, normals (f32 and bf16)
    within THREEFRY_BAR of the plain version on the card."""
    errs = chip_smoke.check_threefry_case(
        torch, name, *chip_smoke.THREEFRY_CASES[name])
    assert max(errs.values()) <= chip_smoke.THREEFRY_BAR


@pytest.mark.parametrize("name", sorted(chip_smoke.THREEFRY_PATH_CASES))
def test_threefry_path_draws_match_plain_version(card, name):
    """The draws the paths make, whole at their own shapes, within
    THREEFRY_BAR of the plain version on the card."""
    err = chip_smoke.check_threefry_path_case(
        torch, name, *chip_smoke.THREEFRY_PATH_CASES[name])
    assert err <= chip_smoke.THREEFRY_BAR


@pytest.mark.parametrize("f,channels_last", [(1, True), (2, True),
                                               (1, False), (2, False)])
def test_threefry_ragged_runs_across_two_to_the_32(card, f, channels_last):
    """The kernel's runs of V values at a ragged shape (C 37 and W / f 13:
    no multiple of 4 or 8) from an offset whose counters cross 2^32 inside
    a run: bits bit-equal to the plain version, and the normals' plan the
    carry instance."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    fmt = torch.channels_last if channels_last else torch.contiguous_format
    shape, offset, key = (3, 37, 11 * f, 13 * f), 2 ** 32 - 5, prng.prng_key(9)
    assert pk.normal_plan(shape, f, fmt, torch.int32, offset).carry
    got = pk.threefry_bits(key, shape, f=f, offset=offset, device=card,
                           memory_format=fmt)
    want = pk.threefry_bits(key, shape, f=f, offset=offset,
                            memory_format=fmt)
    assert got.is_contiguous(memory_format=fmt)
    assert torch.equal(got.cpu(), want)


def test_kernel_table_counts_the_ports_kernels(card):
    """tools/_measure.kernel_table over a window that launches only the
    port's kernels (the threefry draw, through ctypes) counts each launch
    and leaves out its own warm-up launches."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk
    from sg2im_tpu_torch.tools._measure import kernel_table

    key = prng.prng_key(2)
    table = kernel_table(lambda: pk.threefry_normal(
        key, (8, 32, 64, 64), device=card,
        memory_format=torch.channels_last), card, iters=3, top=None)
    names = [r["name"] for r in table["top"]]
    assert table["kernels"] == 1 and table["device_ms"] > 0
    assert len(names) == 1 and "threefry_normal_kernel" in names[0]


def test_profile_window_leaves_out_its_warm_up(card):
    """utils/timing.profile_window on the card: the block's one kernel and
    its one launch, none of the window's warm-up launches."""
    from sg2im_tpu_torch.utils.timing import (
        PROFILE_WARMUP_LAUNCHES,
        profile_window,
    )

    x = torch.ones(1 << 20, device=card)
    with profile_window(card) as window:
        x.mul_(2)
    launches = [e for e in window.host_events
                if e.name.startswith("cudaLaunchKernel")]
    assert len(window.device_events) == 1 and len(launches) == 1
    assert "spin_kernel" not in window.device_events[0].name
    assert 0 <= window.warmup_lost < PROFILE_WARMUP_LAUNCHES


def test_threefry_key_on_the_card_and_refusals(card):
    """A key split on the card is read where it lies and draws what its
    words by value draw; f outside {1, 2, 4} and a key of another shape
    are refused."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    keys = prng.split(prng.prng_key(5).to(card), 3)
    before = pk.threefry_normal.launches
    got = pk.threefry_normal(keys[2], (2, 8, 16, 16))
    assert got.is_cuda and pk.threefry_normal.launches == before + 1
    want = pk.threefry_normal(prng.key_words(keys[2]), (2, 8, 16, 16),
                              device=card)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="f = 3"):
        pk.threefry_normal([0, 1], (1, 1, 6, 6), f=3, device=card)
    with pytest.raises(ValueError, match="key on the card"):
        pk.threefry_normal(keys, (1, 1, 4, 4))


@pytest.mark.parametrize("num", [1, 2, 5, 300])
def test_threefry_split_kernel_matches_plain_version(card, num):
    """The split kernel bit-equal to the plain ``split`` for keys at the
    int32 edges, read on the card or passed by value, one launch each."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    for seed in (0, 7, 2 ** 31 - 1, -1, -2 ** 31):
        key = prng.prng_key(seed)
        want = prng.split(key, num)
        before = pk.threefry_split.launches
        on_card = pk.threefry_split(key.to(card), num)
        by_value = pk.threefry_split(key, num, device=card)
        assert pk.threefry_split.launches == before + 2
        assert on_card.dtype == torch.uint32 and on_card.is_cuda
        assert torch.equal(on_card.cpu(), want)
        assert torch.equal(by_value.cpu(), want)


def test_seeded_generate_launches_threefry_once(card):
    """generate(noise=None) draws its noise with one threefry launch per
    forward, on the card, equal to the same rows given explicitly."""
    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.models import Sg2ImGenerator
    from sg2im_tpu_torch.ops import prng_kernel as pk

    vocab, kwargs = chip_smoke.vg128_config()
    kwargs = dict(kwargs, image_size=(64, 64), refinement_dims=(64, 32, 16, 8))
    model = Sg2ImGenerator(vocab, **kwargs)
    model.reset_parameters(prng_key(0))
    engine = InferenceEngine(vocab, kwargs, model.state_dict(), device=card)
    graphs = chip_smoke.random_graphs(vocab, 3, np.random.RandomState(2))
    before = (pk.threefry_normal.launches, lk.layout_compose.launches)
    a, _ = engine.generate(graphs, seed=6)
    assert pk.threefry_normal.launches == before[0] + 1
    assert lk.layout_compose.launches == before[1] + 1
    noise = engine.draw_noise(3, seed=6).permute(0, 2, 3, 1)
    b, _ = engine.generate(graphs, noise=noise)
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def train_card():
    """The card with autograd on (training), TF32 as the Trainer sets it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")


def _coco64(card):
    """vocab, config and the b32 batch on the card (imgs NCHW)."""
    from sg2im_tpu_torch.tools.profile_train import coco64

    vocab, cfg, batch = coco64()
    batch = {k: torch.from_numpy(v).to(card) for k, v in batch.items()}
    batch["imgs"] = batch["imgs"].permute(0, 3, 1, 2).contiguous()
    return vocab, cfg, batch


def test_train_kernel_gradients_on_the_card(train_card):
    """K1 through its Function at the training shape, f32 and bf16 out:
    the forward against the plain compose, the gradients within 1e-5 of
    max |grad| of autograd through it; K3's backward bit-equal to the
    plain relayout's (chip_smoke.check_train_gradients)."""
    with full_fp32():
        chip_smoke.check_train_gradients(torch, _coco64(train_card)[2])


@pytest.mark.parametrize("D", [64, 128])
def test_k1_function_at_the_proofs_widths(train_card, tmp_path, D):
    """K1 through its Function on a b32 batch of the training proofs' own
    data (trained_fidelity's D 64, train_proof's 128), as chip_smoke's
    phase_proofs checks it."""
    from sg2im_tpu_torch.data.loader import PaddedLoader
    from sg2im_tpu_torch.tools import train_proof

    paths = train_proof.build_dataset(str(tmp_path), 64)
    batch = next(iter(PaddedLoader(train_proof.open_dataset(*paths),
                                   batch_size=32, O_max=16, T_max=16,
                                   num_workers=2, seed=0)))
    boxes, masks, obj_mask = (torch.tensor(batch[k], dtype=torch.float32,
                                           device=train_card)
                              for k in ("boxes", "masks", "obj_mask"))
    with full_fp32():
        err = chip_smoke.check_k1_function(torch, boxes, masks, obj_mask, D,
                                           "[test]")
    assert err <= chip_smoke.KERNEL_BAR


def test_full_width_train_step_on_the_card(train_card):
    """One COCO-64 b32 step of the Trainer on the card: finite losses, not
    skipped, K1, the threefry draw and the key's split launched once,
    every state tensor finite."""
    from sg2im_tpu_torch.train.state import tensors
    from sg2im_tpu_torch.train.trainer import Trainer

    from sg2im_tpu_torch.ops import prng_kernel as pk

    vocab, cfg, batch = _coco64(train_card)
    tr = Trainer(cfg, vocab, device=train_card)
    state = tr.init_state(seed=0)
    before = (lk.layout_compose.launches, pk.threefry_normal.launches,
              pk.threefry_split.launches)
    state, m = tr.step(state, batch)
    assert lk.layout_compose.launches == before[0] + 1
    assert pk.threefry_normal.launches == before[1] + 1  # the step's noise
    assert pk.threefry_split.launches == before[2] + 1  # the step's key
    assert not bool(m["skipped_nonfinite"])
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(torch.isfinite(v).all() for k, v in tensors(state).items()
               if v.is_floating_point())


def test_nan_guard_on_the_card(train_card):
    """A batch with one NaN image leaves every parameter, moment and
    BatchNorm buffer of the three models bit-identical."""
    from sg2im_tpu_torch.train.trainer import Trainer

    vocab, cfg, batch = _coco64(train_card)
    tr = Trainer(cfg, vocab, device=train_card)
    state, _ = tr.step(tr.init_state(seed=0), batch)
    before = chip_smoke.state_tensors(state)
    bad = dict(batch, imgs=batch["imgs"].clone())
    bad["imgs"][0, 0, 0, 0] = float("nan")
    state2, m = tr.step(state, bad)
    assert bool(m["skipped_nonfinite"])
    after = chip_smoke.state_tensors(state2)
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_packed_train_step_launches_k3_forward_and_backward(train_card):
    """A COCO-64 b32 step in 'packed': both relayout entries launch in the
    G forward and again in the G backward (counts read at the step's
    phase marks)."""
    from sg2im_tpu_torch.tools.profile_train import coco64
    from sg2im_tpu_torch.train.trainer import Trainer

    vocab, _, batch = _coco64(train_card)
    tr = Trainer(coco64(crn_mode="packed")[1], vocab, device=train_card)
    marks = {}
    tr.train_step.marker = lambda phase: marks.setdefault(
        phase, (rl.space_to_depth.launches, rl.depth_to_space.launches))
    start = (rl.space_to_depth.launches, rl.depth_to_space.launches)
    try:
        _, m = tr.step(tr.init_state(seed=0), batch)
    finally:
        tr.train_step.marker = None
    assert not bool(m["skipped_nonfinite"])
    fwd, bwd = marks["g_forward"], marks["g_backward"]
    assert all(f > s for f, s in zip(fwd, start))
    assert all(b > f for b, f in zip(bwd, fwd))


def test_prefetch_to_device_is_bit_equal_under_a_busy_stream(train_card):
    """prefetch_to_device with 4 batches in flight (5 pinned buffers
    reused across 16 batches) and a consumer slower than the producer:
    every batch on the card equals its host batch, bit for bit
    (chip_smoke.check_prefetch)."""
    rng = np.random.RandomState(0)
    N, O, T, M = 32, 16, 24, 16
    batches = [{"imgs": rng.randn(N, 64, 64, 3).astype(np.float32),
                "objs": rng.randint(0, 184, (N, O)).astype(np.int32),
                "boxes": rng.rand(N, O, 4).astype(np.float32),
                "masks": (rng.rand(N, O, M, M) > 0.5).astype(np.float32),
                "triples": rng.randint(0, 9, (N, T, 3)).astype(np.int32),
                "obj_mask": (rng.rand(N, O) > 0.3).astype(np.float32),
                "triple_mask": (rng.rand(N, T) > 0.3).astype(np.float32)}
               for _ in range(16)]
    assert chip_smoke.check_prefetch(torch, batches, size=4,
                                     busy_ms=10.0) == 16
