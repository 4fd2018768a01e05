"""ctypes binding for the native image decode + resize pool (counterpart
of ``sg2im_tpu/native/imagedec.py``).

The C++ library (``imagedec.cpp``) replaces the loader's PIL decode +
bilinear-resize hot path (reference ``sg2im/data/coco.py:232-262``,
``vg.py:105-121``): libjpeg/libpng decode, a bit-exact reimplementation
of Pillow's BILINEAR triangle resampling, an optional DCT-domain
prescale fast mode, and a std::thread batch pool so one Python worker
can use every host core without the interpreter lock.  It is built at
first use into ``build/sg2im_tpu_torch/native/``
(:func:`sg2im_tpu_torch.native.build_library`).

Import is safe everywhere: :func:`available` compiles on demand and
returns False (never raises) when no compiler or libjpeg/libpng is
present; callers then stay on the PIL path.  ``available()`` also runs
a one-shot self-check (decode+resize a tiny embedded JPEG and compare
against PIL bit-for-bit) so a host with a divergent libjpeg falls back
instead of shipping off-by-some pixels into the parity-pinned datasets.
"""

from __future__ import annotations

import ctypes
import io
import os
import threading

import numpy as np

from sg2im_tpu_torch.native import build_library

_lib = None
_checked: bool | None = None
_lock = threading.Lock()


def build():
    """Compile imagedec.cpp (with libjpeg and libpng); the library's path,
    or None when no C++ compiler or library is available."""
    return build_library("imagedec.cpp", ("g++", "c++", "clang++"),
                         libs=("-ljpeg", "-lpng"))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.img_probe.restype = ctypes.c_int
        lib.img_probe.argtypes = [ctypes.c_char_p, ctypes.c_long, i32p, i32p]
        lib.img_decode_resize.restype = ctypes.c_int
        lib.img_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, i32p, i32p]
        lib.img_decode_resize_batch.restype = ctypes.c_int
        lib.img_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
            i32p, u8p, ctypes.c_int]
        lib.img_resize_u8.restype = ctypes.c_int
        lib.img_resize_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def _self_check() -> bool:
    """Decode+resize a synthetic JPEG natively and via PIL; require
    bit-identical output (the exact path's contract)."""
    try:
        from PIL import Image
    except ImportError:  # no PIL -> nothing to fall back to anyway
        return True
    rng = np.random.RandomState(0)
    # Smooth-ish content (JPEG-friendly) with structure across the image.
    y, x = np.mgrid[0:97, 0:131]
    base = np.stack([(x * 2) % 256, (y * 3) % 256, (x + y) % 256], -1)
    arr = np.clip(base + rng.randint(-8, 8, base.shape), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8)).save(buf, format="JPEG", quality=90)
    data = buf.getvalue()
    got = decode_resize(data, (64, 64), fast=False, _skip_check=True)
    if got is None:
        return False
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(
            im.convert("RGB").resize((64, 64), Image.BILINEAR), np.uint8)
    return bool((got[0] == want).all())


def available() -> bool:
    """True when the native decoder is built AND matches PIL bit-for-bit
    on the embedded self-check image."""
    global _checked
    if _checked is None:
        # No lock here: _load() takes _lock itself (non-reentrant), and a
        # racing duplicate self-check is idempotent.
        try:
            _checked = _load() is not None and _self_check()
        except Exception:
            _checked = False
    return bool(_checked)


def probe(data: bytes):
    """(format, width, height) without decoding pixels; format is
    'jpeg' / 'png' / None."""
    lib = _load()
    if lib is None:
        return None, 0, 0
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    fmt = lib.img_probe(data, len(data), ctypes.byref(w), ctypes.byref(h))
    return {1: "jpeg", 2: "png"}.get(fmt), w.value, h.value


def decode_resize(data: bytes, size, fast: bool = False, _skip_check=False):
    """Decode an encoded JPEG/PNG and resize to ``size`` (H, W).

    Returns ``(img_u8 (H, W, 3), orig_w, orig_h)`` or ``None`` when the
    native path is unavailable or the format needs the PIL fallback
    (CMYK JPEG, exotic PNG, corrupt file).  ``fast=True`` enables
    DCT-domain prescaling: visually identical, NOT bit-equal to PIL.
    """
    if not _skip_check and not available():
        return None
    lib = _load()
    if lib is None:
        return None
    H, W = int(size[0]), int(size[1])
    out = np.empty((H, W, 3), np.uint8)
    ow, oh = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.img_decode_resize(
        data, len(data), H, W,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if fast else 0, ctypes.byref(ow), ctypes.byref(oh))
    if rc != 0:
        return None
    return out, ow.value, oh.value


def resize_u8(arr, size):
    """PIL-BILINEAR-exact resize of a uint8 (H, W) or (H, W, 3) array to
    ``size`` (H, W); returns None when the native library is unavailable
    (callers fall back to PIL).  Matches ``Image.fromarray(arr).resize``
    bit-for-bit (modes L / RGB)."""
    if not available():
        return None
    lib = _load()
    a = np.ascontiguousarray(arr, np.uint8)
    ch = 1 if a.ndim == 2 else a.shape[2]
    H, W = int(size[0]), int(size[1])
    out = np.empty((H, W) if a.ndim == 2 else (H, W, ch), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.img_resize_u8(
        a.ctypes.data_as(u8p), a.shape[0], a.shape[1], ch,
        out.ctypes.data_as(u8p), H, W)
    if rc != 0:
        return None
    return out


def decode_resize_batch(datas, size, fast: bool = False,
                        n_threads: int | None = None):
    """Decode a list of encoded images to one (N, H, W, 3) uint8 array
    using the C++ thread pool.

    Returns ``(imgs, orig_wh (N, 2) int32, ok (N,) bool)`` or ``None``
    when the native path is unavailable.  Failed items have ``ok`` False
    and zeroed pixels — the caller re-decodes those via PIL.
    """
    if not available():
        return None
    lib = _load()
    n = len(datas)
    H, W = int(size[0]), int(size[1])
    imgs = np.empty((n, H, W, 3), np.uint8)
    orig_wh = np.zeros((n, 2), np.int32)
    ok = np.zeros((n,), np.uint8)
    if n == 0:
        return imgs, orig_wh, ok.astype(bool)
    bufs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_long * n)(*[len(d) for d in datas])
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    lib.img_decode_resize_batch(
        bufs, lens, n, H, W,
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if fast else 0,
        orig_wh.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_threads))
    return imgs, orig_wh, ok.astype(bool)
