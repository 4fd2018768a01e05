"""The port's data pipeline (``sg2im_tpu_torch.data``, ``.native``) against
the JAX package's on the CPU, on the synthetic COCO and VG fixtures of
``tests/test_data.py`` (PNG images with polygon and compressed-RLE
segmentations; JPEG images in an h5 of the preprocess schema).

Everything here is host code and compared bit for bit: the RLE codec
(native and numpy), the image decoders (PIL and the native libjpeg /
libpng one), dataset items over two epochs, loader batches (shuffle,
seeds, worker counts, ``shard``, ``drop_last``, truncation), the decoded
sample cache (built by either package), and the port's own additions:
``PaddedLoader.start_at`` and ``wait_seconds``, ``prefetch_to_device`` on
the CPU, and libraries built under ``build/`` only.  The native decoder's
and codec's tests mirror ``tests/test_native.py`` and
``tests/test_native_decode.py`` and skip where those skip.
"""

import ast
import io
import os
import pathlib
import time

import numpy as np
import pytest

from sg2im_tpu.data import cache as jcache
from sg2im_tpu.data import coco as jcoco
from sg2im_tpu.data import loader as jloader
from sg2im_tpu.data import rle as jrle
from sg2im_tpu.data import seeding as jseeding
from sg2im_tpu.data import transforms as jtransforms
from sg2im_tpu.data import vg as jvg
from sg2im_tpu.native import imagedec as jimagedec
from sg2im_tpu_torch import native
from sg2im_tpu_torch.data import cache as tcache
from sg2im_tpu_torch.data import coco as tcoco
from sg2im_tpu_torch.data import decode as tdecode
from sg2im_tpu_torch.data import loader as tloader
from sg2im_tpu_torch.data import rle as trle
from sg2im_tpu_torch.data import seeding as tseeding
from sg2im_tpu_torch.data import transforms as ttransforms
from sg2im_tpu_torch.data import vg as tvg
from sg2im_tpu_torch.native import imagedec
from test_data import _fake_coco, _fake_vg

REPO = pathlib.Path(__file__).resolve().parents[1]
DECODERS = ("pil", "native")


def _equal(a, b, what=""):
    """Two samples or batches (dicts) hold the same keys and bytes."""
    assert set(a) == set(b), what
    for k in a:
        if a[k] is None:
            assert b[k] is None, (what, k)
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (what, k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


@pytest.fixture
def rle_lib():
    if not native.native_available():
        pytest.skip("no C compiler available to build native codec")


@pytest.fixture
def dec_lib():
    if not imagedec.available():
        pytest.skip("native image decoder unavailable (no compiler or "
                    "libjpeg/png)")


def _decoder(name):
    if name == "native" and not imagedec.available():
        pytest.skip("native image decoder unavailable")
    return name


# ---------------------------------------------------------------------------
# RLE codec, seeding, transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(23, 17), (64, 64), (5, 1), (1, 7),
                                   (48, 64)])
def test_rle_codec_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    mask = (rng.rand(*shape) > 0.5).astype(np.uint8)
    rle = trle.mask_to_rle(mask)
    assert rle == jrle.mask_to_rle(mask)
    np.testing.assert_array_equal(trle.rle_to_mask(rle), mask)
    np.testing.assert_array_equal(trle.rle_to_mask(rle),
                                  jrle.rle_to_mask(rle))
    np.testing.assert_array_equal(trle.decode_rle_counts(rle["counts"]),
                                  jrle.decode_rle_counts(rle["counts"]))
    runs = jrle.decode_rle_counts(rle["counts"])
    assert trle.encode_rle_counts(runs) == jrle.encode_rle_counts(runs)
    polys = [[2.5, 1.25, shape[1] - 1.5, 2.0, shape[1] / 2, shape[0] - 1.0]]
    np.testing.assert_array_equal(
        trle.polygons_to_mask(polys, shape[1], shape[0]),
        jrle.polygons_to_mask(polys, shape[1], shape[0]))


@pytest.mark.parametrize("case", ["decode", "encode", "rle_to_mask",
                                  "invalid"])
def test_native_rle_codec(rle_lib, case):
    """tests/test_native.py's cases on the port's library: native against
    numpy, and against the JAX package's codec."""
    rng = np.random.RandomState(0)
    if case == "decode":
        for shape in [(23, 17), (64, 64), (5, 1), (1, 7)]:
            mask = (rng.rand(*shape) > 0.5).astype(np.uint8)
            rle = jrle.mask_to_rle(mask)
            np.testing.assert_array_equal(
                native.rle_decode_native(rle["counts"], *shape), mask)
    elif case == "encode":
        for shape in [(23, 17), (64, 64)]:
            mask = (rng.rand(*shape) > 0.3).astype(np.uint8)
            assert native.rle_encode_native(mask) == \
                jrle.mask_to_rle(mask)["counts"]
    elif case == "rle_to_mask":
        mask = (rng.rand(100, 80) > 0.6).astype(np.uint8)
        rle = trle.mask_to_rle(mask)
        np.testing.assert_array_equal(trle.rle_to_mask(rle), mask)
    else:
        with pytest.raises(ValueError):
            native.rle_decode_native(
                trle.encode_rle_counts([1000]).decode(), 4, 4)


def test_native_rle_decode_is_faster(rle_lib):
    rng = np.random.RandomState(3)
    counts = trle.mask_to_rle(
        (rng.rand(480, 640) > 0.5).astype(np.uint8))["counts"]
    t0 = time.perf_counter()
    for _ in range(20):
        native.rle_decode_native(counts, 480, 640)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(20):
        runs = trle.decode_rle_counts(counts)
        vals = np.zeros(len(runs), np.uint8)
        vals[1::2] = 1
        np.repeat(vals, runs)[: 480 * 640].reshape((640, 480)).T
    t_numpy = time.perf_counter() - t0
    assert t_native < t_numpy, (t_native, t_numpy)


def test_per_sample_rng_and_transforms_match_jax():
    for args in [(0, 0, 0), (3, 1, 7), (2**40, 5, 12345), (None, 0, 0)]:
        if args[0] is None:
            assert tseeding.per_sample_rng(*args) is \
                jseeding.per_sample_rng(*args)
            continue
        a, b = tseeding.per_sample_rng(*args), jseeding.per_sample_rng(*args)
        assert [a.random() for _ in range(5)] == \
            [b.random() for _ in range(5)]
    rng = np.random.RandomState(0)
    img = rng.rand(2, 9, 7, 3).astype(np.float32)
    _equal({"x": ttransforms.imagenet_preprocess(img)},
           {"x": jtransforms.imagenet_preprocess(img)})
    _equal({"x": ttransforms.imagenet_deprocess_batch(img)},
           {"x": jtransforms.imagenet_deprocess_batch(img)})
    from PIL import Image

    pil = Image.fromarray((img[0] * 255).astype(np.uint8))
    for size in [(5, 11), 6]:
        _equal({"x": np.asarray(ttransforms.resize_image(pil, size))},
               {"x": np.asarray(jtransforms.resize_image(pil, size))})


# ---------------------------------------------------------------------------
# The native image decoder (tests/test_native_decode.py's cases)
# ---------------------------------------------------------------------------

def _pil_want(data: bytes, size):
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(
            im.convert("RGB").resize((size[1], size[0]), Image.BILINEAR),
            np.uint8)


def _encode(arr, fmt, mode=None, **kw):
    from PIL import Image

    im = Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _natural(h, w, seed=0):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 2) % 256, (y * 3) % 256, (x + y) % 256], -1)
    return np.clip(base + rng.randint(-8, 8, base.shape), 0,
                   255).astype(np.uint8)


def _decoded_like_jax(data, size, fast=False):
    got = imagedec.decode_resize(data, size, fast=fast)
    want = jimagedec.decode_resize(data, size, fast=fast)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    return got


@pytest.mark.parametrize("fmt,kw", [
    ("JPEG", {"quality": 90}),
    ("JPEG", {"quality": 60}),
    ("JPEG", {"progressive": True, "quality": 85}),
    ("PNG", {}),
])
@pytest.mark.parametrize("size", [(64, 64), (128, 128), (48, 96)])
def test_exact_backend_matches_pil(dec_lib, fmt, kw, size):
    data = _encode(_natural(200, 300), fmt, **kw)
    img, ow, oh = _decoded_like_jax(data, size)
    assert (ow, oh) == (300, 200)
    assert img.shape == (size[0], size[1], 3)
    np.testing.assert_array_equal(img, _pil_want(data, size))


DECODE_CASES = ["exotic_modes", "upscale_identity", "png_interlaced_16bit",
                "cmyk", "corrupt", "probe", "fast_mode", "batch",
                "resize_u8_masks", "load_image_backends", "resize_fuzz"]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_native_decoder_cases(dec_lib, case, tmp_path):
    """The remaining cases of tests/test_native_decode.py on the port's
    decoder, each also against the JAX package's."""
    from PIL import Image

    if case == "exotic_modes":
        arr = _natural(120, 150, seed=1)
        cases = [_encode(arr[:, :, 0], "PNG", mode="L"),
                 _encode(arr[:, :, 0], "JPEG", mode="L"),
                 _encode(np.dstack([arr, arr[:, :, :1]]), "PNG",
                         mode="RGBA"),
                 _encode(np.asarray(Image.fromarray(arr).convert("P")),
                         "PNG", mode="P")]
        for data in cases:
            img, _, _ = _decoded_like_jax(data, (64, 64))
            np.testing.assert_array_equal(img, _pil_want(data, (64, 64)))
    elif case == "upscale_identity":
        data = _encode(_natural(40, 50, seed=2), "PNG")
        for size in [(64, 64), (40, 50)]:
            img, _, _ = _decoded_like_jax(data, size)
            np.testing.assert_array_equal(img, _pil_want(data, size))
    elif case == "png_interlaced_16bit":
        arr = _natural(90, 110, seed=4)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG", interlace=True)
        img, _, _ = _decoded_like_jax(buf.getvalue(), (64, 64))
        np.testing.assert_array_equal(img, _pil_want(buf.getvalue(),
                                                     (64, 64)))
        buf = io.BytesIO()
        Image.fromarray(arr[:, :, 0].astype(np.uint16) * 257).save(
            buf, format="PNG")
        assert _decoded_like_jax(buf.getvalue(), (64, 64)) is None
    elif case == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(_natural(100, 100)).convert("CMYK").save(
            buf, format="JPEG")
        assert _decoded_like_jax(buf.getvalue(), (64, 64)) is None
    elif case == "corrupt":
        assert imagedec.decode_resize(b"not an image", (64, 64)) is None
        data = _encode(_natural(100, 100), "JPEG")
        assert imagedec.decode_resize(data[:40], (64, 64)) is None
    elif case == "probe":
        jd = _encode(_natural(80, 120), "JPEG")
        pd = _encode(_natural(80, 120), "PNG")
        assert imagedec.probe(jd) == ("jpeg", 120, 80)
        assert imagedec.probe(pd) == ("png", 120, 80)
        assert imagedec.probe(b"junk")[0] is None
    elif case == "fast_mode":
        data = _encode(_natural(480, 640), "JPEG", quality=90)
        want = _pil_want(data, (64, 64)).astype(np.float32)
        img, _, _ = _decoded_like_jax(data, (64, 64), fast=True)
        mse = float(((img.astype(np.float32) - want) ** 2).mean())
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 30.0
    elif case == "batch":
        datas = [_encode(_natural(100 + 7 * i, 140 + 5 * i, seed=i), "JPEG")
                 for i in range(5)]
        datas.insert(2, b"corrupt")
        imgs, orig_wh, ok = imagedec.decode_resize_batch(datas, (64, 64),
                                                         n_threads=4)
        j_imgs, j_wh, j_ok = jimagedec.decode_resize_batch(
            datas, (64, 64), n_threads=4)
        assert ok.tolist() == [True, True, False, True, True, True]
        assert ok.tolist() == j_ok.tolist()
        np.testing.assert_array_equal(imgs, j_imgs)
        np.testing.assert_array_equal(orig_wh, j_wh)
        assert (imgs[2] == 0).all()
        for i, data in enumerate(datas):
            if ok[i]:
                single, ow, oh = imagedec.decode_resize(data, (64, 64))
                np.testing.assert_array_equal(imgs[i], single)
                assert orig_wh[i].tolist() == [ow, oh]
    elif case == "resize_u8_masks":
        rng = np.random.RandomState(0)
        for hw in [(1, 1), (7, 13), (30, 14), (200, 480)]:
            mask = (rng.rand(*hw) > 0.5).astype(np.uint8)
            want = np.asarray(Image.fromarray(mask * 255).resize(
                (16, 16), Image.BILINEAR), np.uint8)
            np.testing.assert_array_equal(
                tdecode.resize_u8(mask * 255, (16, 16), "native"), want)
        rgb = rng.randint(0, 256, (50, 70, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(rgb).resize((24, 32),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(
            tdecode.resize_u8(rgb, (32, 24), "native"), want)
    elif case == "load_image_backends":
        path = os.path.join(tmp_path, "x.jpg")
        with open(path, "wb") as f:
            f.write(_encode(_natural(180, 240, seed=3), "JPEG"))
        outs = [tdecode.load_image_u8(path, (64, 64), d)
                for d in ("pil", "native", "auto")]
        for a in outs[1:]:
            np.testing.assert_array_equal(outs[0][0], a[0])
            assert a[1:] == (240, 180)
        assert tdecode.resolve_decoder("auto") == "native"
        assert tdecode.resolve_decoder("pil") == "pil"
        with pytest.raises(ValueError):
            tdecode.resolve_decoder("nonsense")
    else:  # resize_fuzz
        rng = np.random.RandomState(11)
        for _ in range(25):
            ih, iw = rng.randint(1, 150, 2)
            oh, ow = rng.randint(1, 150, 2)
            arr = rng.randint(0, 256, (ih, iw, 3), dtype=np.uint8)
            want = np.asarray(Image.fromarray(arr).resize(
                (ow, oh), Image.BILINEAR), np.uint8)
            np.testing.assert_array_equal(imagedec.resize_u8(arr, (oh, ow)),
                                          want)


def test_native_libraries_build_under_build_dir_only():
    """The port's .so files land in build/sg2im_tpu_torch/native/ at the
    root of the checkout, keyed by their source; the package directory
    gets no file."""
    pkg = REPO / "sg2im_tpu_torch" / "native"

    def listing():  # bytecode caches come and go with imports
        return sorted(p.name for p in pkg.iterdir()
                      if p.name != "__pycache__")

    before = listing()
    paths = [native.build_library("rlecodec.c", ("cc", "gcc", "clang"))]
    if imagedec.available():
        paths.append(imagedec.build())
    for p in paths:
        if p is None:
            pytest.skip("no compiler")
        assert p.parent == REPO / "build" / "sg2im_tpu_torch" / "native"
        assert p.is_file() and p.suffix == ".so"
    assert listing() == before
    assert not [n for n in before if n.endswith(".so")]


# ---------------------------------------------------------------------------
# Datasets, cache and loader against the JAX package's
# ---------------------------------------------------------------------------

def _coco_kw(tmp_path, **kw):
    img_dir, inst, stuff = _fake_coco(str(tmp_path))
    return dict(dict(image_dir=img_dir, instances_json=inst,
                     stuff_json=stuff, image_size=(32, 32), mask_size=8,
                     seed=3), **kw)


def _vg_kw(tmp_path, **kw):
    vocab, h5_path, img_dir = _fake_vg(str(tmp_path))
    return dict(dict(vocab=vocab, h5_path=h5_path, image_dir=img_dir,
                     image_size=(32, 32), max_objects=6, seed=5), **kw)


DATASETS = {"coco": (_coco_kw, tcoco.CocoSceneGraphDataset,
                     jcoco.CocoSceneGraphDataset),
            "vg": (_vg_kw, tvg.VgSceneGraphDataset, jvg.VgSceneGraphDataset)}


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_match_jax(tmp_path, name, decoder):
    make_kw, port_cls, jax_cls = DATASETS[name]
    kw = make_kw(tmp_path, decoder=_decoder(decoder))
    port, ref = port_cls(**kw), jax_cls(**kw)
    assert port.vocab == ref.vocab and len(port) == len(ref) > 0
    for epoch in (0, 1):
        for i in range(len(ref)):
            _equal(port.getitem_at_epoch(i, epoch),
                   ref.getitem_at_epoch(i, epoch), f"{name} {i} {epoch}")
    if name == "coco":
        assert port.total_objects() == ref.total_objects()
        batch = port.decode_images_batch([0, 1])
        want = ref.decode_images_batch([0, 1])
        if want is None:
            assert batch is None
        else:
            for a, b in zip(batch, want):
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1] == b[1]


LOADER_CASES = {
    "w1": dict(num_workers=1, seed=5),
    "w4": dict(num_workers=4, seed=5),
    "shard": dict(num_workers=2, seed=1, shard=(1, 2), batch_size=1),
    "no_drop_last": dict(num_workers=2, shuffle=False, drop_last=False,
                         batch_size=3),
    "no_batch_decode": dict(num_workers=2, batch_decode=False),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_loader_batches_match_jax(tmp_path, name, case):
    """Two epochs of the port's PaddedLoader equal the JAX package's,
    batch for batch."""
    make_kw, port_cls, jax_cls = DATASETS[name]
    kw = make_kw(tmp_path, decoder="auto")
    lk = dict(dict(batch_size=2, O_max=8, T_max=16), **LOADER_CASES[case])
    port = tloader.PaddedLoader(port_cls(**kw), **lk)
    ref = jloader.PaddedLoader(jax_cls(**kw), **lk)
    assert len(port) == len(ref) > 0
    for epoch in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref)
        for j, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"epoch {epoch} batch {j}")


def test_collate_truncation_matches_jax():
    rng = np.random.RandomState(0)
    samples = [{"image": rng.rand(8, 8, 3).astype(np.float32),
                "objs": np.array([1, 2, 3, 4, 0]),
                "boxes": rng.rand(5, 4).astype(np.float32),
                "masks": (rng.rand(5, 4, 4) > 0.5).astype(np.int64),
                "triples": np.array([[0, 1, 1], [3, 1, 2], [0, 0, 4],
                                     [1, 2, 0], [2, 2, 4]])}
               for _ in range(2)]
    for O_max, T_max in [(4, 4), (4, 2), (8, 8)]:
        _equal(tloader.collate_padded(samples, O_max, T_max),
               jloader.collate_padded(samples, O_max, T_max))
    out = tloader.collate_padded(samples[:1], 4, 4)
    np.testing.assert_array_equal(out["objs"][0], [1, 2, 3, 0])
    with pytest.raises(ValueError):
        tloader.collate_padded(samples, 4, 4, drop_excess=False)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_cache_matches_uncached_and_jax(tmp_path, name):
    """Cached samples equal uncached ones for every epoch; a cache the JAX
    package built is read by the port as it is (the same files and
    fingerprint), and the other way round."""
    make_kw, port_cls, jax_cls = DATASETS[name]
    kw = make_kw(tmp_path, decoder="auto")
    plain = port_cls(**kw)
    own = port_cls(cache_dir=str(tmp_path / "port_cache"), **kw)
    assert own._cache is not None and own._cache.ready
    jax_built = jax_cls(cache_dir=str(tmp_path / "jax_cache"), **kw)
    assert jax_built._cache.ready
    orig = tcache.DecodedCache.build
    try:
        def refuse(*a, **k):
            raise AssertionError("the port rebuilt a cache the JAX "
                                 "package had built")
        tcache.DecodedCache.build = refuse
        reader = port_cls(cache_dir=str(tmp_path / "jax_cache"), **kw)
    finally:
        tcache.DecodedCache.build = orig
    orig = jcache.DecodedCache.build
    try:
        def refuse_jax(*a, **k):
            raise AssertionError("the JAX package rebuilt the port's cache")
        jcache.DecodedCache.build = refuse_jax
        jax_reader = jax_cls(cache_dir=str(tmp_path / "port_cache"), **kw)
    finally:
        jcache.DecodedCache.build = orig
    for epoch in (0, 1, 5):
        for i in range(len(plain)):
            want = plain.getitem_at_epoch(i, epoch)
            for ds in (own, reader, jax_reader):
                _equal(ds.getitem_at_epoch(i, epoch), want, f"{i} {epoch}")
    assert not [f for f in os.listdir(tmp_path / "port_cache")
                if ".tmp." in f]
    loader_kw = dict(batch_size=2, O_max=8, T_max=16, num_workers=2, seed=2)
    for a, b in zip(tloader.PaddedLoader(own, **loader_kw),
                    tloader.PaddedLoader(plain, **loader_kw)):
        _equal(a, b)


def test_cache_invalidates_on_a_changed_filter(tmp_path):
    kw = _coco_kw(tmp_path)
    cache_dir = str(tmp_path / "cache")
    tcoco.CocoSceneGraphDataset(cache_dir=cache_dir, **kw)
    builds = []
    orig = tcache.DecodedCache.build
    try:
        def counting(self, *a, **k):
            builds.append(1)
            return orig(self, *a, **k)
        tcache.DecodedCache.build = counting
        tcoco.CocoSceneGraphDataset(cache_dir=cache_dir, **kw)
        assert not builds
        other = tcoco.CocoSceneGraphDataset(cache_dir=cache_dir,
                                            **dict(kw, mask_size=4))
        assert builds and other[0]["masks"].shape[-1] == 4
    finally:
        tcache.DecodedCache.build = orig


# ---------------------------------------------------------------------------
# The port's additions to the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 2, 3, 5])
def test_start_at_resumes_where_an_uninterrupted_run_is(tmp_path, step):
    """A loader put at ``step`` yields, over the epochs that follow, the
    batches an uninterrupted loader yields from its ``step``-th on."""
    ds = tcoco.CocoSceneGraphDataset(**_coco_kw(tmp_path))
    kw = dict(batch_size=2, O_max=8, T_max=16, num_workers=2, seed=7)
    fresh = tloader.PaddedLoader(ds, **kw)
    want = [b for _ in range(4) for b in fresh]
    resumed = tloader.PaddedLoader(ds, **kw)
    resumed.start_at(step)
    got = []
    while len(got) < len(want) - step:
        got.extend(resumed)
    assert len(fresh) == 2
    for j, (a, b) in enumerate(zip(got, want[step:])):
        _equal(a, b, f"batch {step + j}")


def test_wait_seconds_counts_the_consumers_block(tmp_path):
    ds = tcoco.CocoSceneGraphDataset(**_coco_kw(tmp_path))

    class Slow:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            time.sleep(0.05)
            return ds[i]

    loader = tloader.PaddedLoader(Slow(), batch_size=2, O_max=8, T_max=16,
                                  num_workers=1, shuffle=False)
    assert loader.wait_seconds == 0.0
    assert len(list(loader)) == 2
    assert loader.wait_seconds >= 0.1


def test_prefetch_to_device_on_the_cpu_passes_batches_through(tmp_path):
    ds = tcoco.CocoSceneGraphDataset(**_coco_kw(tmp_path))
    batches = list(tloader.PaddedLoader(ds, batch_size=1, O_max=8,
                                        T_max=16, num_workers=2, seed=0))
    got = list(tloader.prefetch_to_device(iter(batches), size=3,
                                          device="cpu"))
    assert len(got) == len(batches) == 4
    for a, b in zip(got, batches):
        assert a is b
        assert a["imgs"].shape == (1, 32, 32, 3)


# ---------------------------------------------------------------------------
# The port's imports
# ---------------------------------------------------------------------------

def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    """No file of sg2im_tpu_torch, and not chip_smoke.py, imports JAX,
    flax, optax or the JAX package, at any depth of its code."""
    files = sorted((REPO / "sg2im_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = {}
    for path in files:
        mods = [m for m in _imported_modules(path)
                if m.split(".")[0] in ("jax", "flax", "optax", "sg2im_tpu")]
        if mods:
            bad[str(path.relative_to(REPO))] = mods
    assert len(files) > 40
    assert not bad, bad
