"""Image file -> resized uint8 array, with a native C++ fast path
(counterpart of ``sg2im_tpu/data/decode.py``).

One helper used by both datasets' hot decode path (reference loads via
PIL: ``sg2im/data/coco.py:232-245``, ``vg.py:105-112``).  Backends:

- ``"pil"``: the reference-shaped path (PIL decode + BILINEAR resize).
- ``"native"``: C++ libjpeg/libpng decode + a bit-exact port of PIL's
  triangle resampling (``native/imagedec.cpp``) — same bytes as "pil",
  measured ~1.5x faster single-thread, and GIL-free for thread pools.
- ``"native_fast"``: adds JPEG DCT-domain prescaling (decode at the
  smallest M/8 scale covering the target) — visually identical but NOT
  bit-equal to PIL; ~3x faster.  Pixel-parity tests must pin "pil" or
  "native".
- ``"auto"``: "native" when the library builds and passes its embedded
  bit-parity self-check, else "pil".

Every native backend falls back to PIL per-image on formats the C++
decoder rejects (CMYK JPEG, exotic PNG, corrupt files).
"""

from __future__ import annotations

import numpy as np

DECODERS = ("auto", "pil", "native", "native_fast")


def resolve_decoder(decoder: str) -> str:
    """Map 'auto'/'native*' to what will actually run on this host."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if decoder == "pil":
        return "pil"
    from sg2im_tpu_torch.native import imagedec

    if not imagedec.available():
        return "pil"
    return "native" if decoder == "auto" else decoder


def _pil_load(path: str, size) -> tuple[np.ndarray, int, int]:
    from PIL import Image

    from sg2im_tpu_torch.data.transforms import resize_image

    with open(path, "rb") as f:
        with Image.open(f) as image:
            WW, HH = image.size
            img = resize_image(image.convert("RGB"), size)
            return np.asarray(img, np.uint8), WW, HH


def resize_u8(arr: np.ndarray, size, decoder: str = "pil") -> np.ndarray:
    """PIL-BILINEAR resize of a uint8 (H, W) or (H, W, 3) array — the
    per-object mask-resize hot op (reference ``coco.py:280-283``).  The
    native path is bit-identical to PIL (same triangle resampler as the
    image path)."""
    if decoder != "pil" and resolve_decoder(decoder) != "pil":
        from sg2im_tpu_torch.native import imagedec

        out = imagedec.resize_u8(arr, size)
        if out is not None:
            return out
    from PIL import Image

    return np.asarray(
        Image.fromarray(arr).resize((size[1], size[0]), Image.BILINEAR),
        np.uint8)


def batch_decode_files(paths, size, decoder: str, n_threads=None):
    """Batched GIL-free decode of image files via the C++ thread pool
    (``native/imagedec.cpp``: one call decodes+resizes the whole batch).

    Returns a list aligned with ``paths`` of ``(img_u8 (H, W, 3),
    (orig_w, orig_h))`` with ``None`` entries where the native decoder
    failed (CMYK/exotic/corrupt — caller falls back per-sample), or
    ``None`` when batching is inapplicable on this host/decoder (PIL
    requested or the native library unavailable).  Bytes are identical to
    the per-sample path: same decoder, same resampler.
    """
    dec = resolve_decoder(decoder)
    if dec == "pil":
        return None
    from sg2im_tpu_torch.native import imagedec

    datas = []
    for p in paths:
        with open(p, "rb") as f:
            datas.append(f.read())
    r = imagedec.decode_resize_batch(datas, size,
                                     fast=(dec == "native_fast"),
                                     n_threads=n_threads)
    if r is None:
        return None
    imgs, orig_wh, ok = r
    return [(imgs[j], (int(orig_wh[j, 0]), int(orig_wh[j, 1])))
            if ok[j] else None for j in range(len(paths))]


def load_image_u8(path: str, size, decoder: str = "pil"):
    """Decode ``path`` and resize to ``size`` (H, W).

    Returns ``(img_u8 (H, W, 3), orig_w, orig_h)``.
    """
    if decoder not in ("pil",):
        decoder = resolve_decoder(decoder)
    if decoder == "pil":
        return _pil_load(path, size)

    from sg2im_tpu_torch.native import imagedec

    with open(path, "rb") as f:
        data = f.read()
    r = imagedec.decode_resize(data, size, fast=(decoder == "native_fast"))
    if r is None:  # CMYK/exotic/corrupt -> PIL decides (or raises)
        return _pil_load(path, size)
    return r
