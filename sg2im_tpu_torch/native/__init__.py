"""Native host components of the data pipeline, loaded with ctypes and
built at first use (counterpart of ``sg2im_tpu/native/``): the COCO RLE
codec (``rlecodec.c``, here) and the image decoder (``imagedec.cpp``,
:mod:`sg2im_tpu_torch.native.imagedec`).

Each library is compiled with the system's C or C++ compiler into
``build/sg2im_tpu_torch/native/`` at the root of the checkout, under a
name keyed by a hash of the source and flags, so a changed source is
rebuilt and nothing is written into the package.  When no compiler (or
no libjpeg / libpng) is present, :func:`build_library` returns None and
the callers stay on their numpy / PIL paths, which give the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sg2im_tpu_torch" \
    / "native"
_lib = None
_lock = threading.Lock()  # loader decode threads race into _load()


def build_library(source: str, compilers, flags=(), libs=()) -> Path | None:
    """Compile ``source`` (a file beside this module) into a shared
    library under :data:`BUILD_DIR`, with the first of ``compilers`` that
    succeeds; returns its path, or None when none does.  An existing
    library of the same source and flags is reused."""
    src = SRC_DIR / source
    args = ["-O3", "-shared", "-fPIC", *flags]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(args + list(libs)).encode())
    out = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for cc in compilers:
        # A temporary name, then an atomic rename: a concurrent process
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, *args, "-o", tmp, str(src), *libs],
                           check=True, capture_output=True)
        except (FileNotFoundError, subprocess.CalledProcessError):
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
        return out
    return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        return _load_locked()


def _load_locked():
    global _lib
    path = build_library("rlecodec.c", ("cc", "gcc", "clang"))
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long]
    lib.rle_encode.restype = ctypes.c_long
    lib.rle_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        return _load() is not None
    except OSError:
        return False


def rle_decode_native(counts: str | bytes, h: int, w: int):
    """Decode compressed counts to a (h, w) uint8 mask, or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    # decoded buffer is column-major (w, h) in C order == (h, w) Fortran
    out = np.zeros(h * w, np.uint8)
    rc = lib.rle_decode(
        counts, len(counts),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    if rc != 0:
        raise ValueError("invalid RLE counts")
    return out.reshape((w, h)).T


def rle_encode_native(mask) -> str | None:
    """Encode a (h, w) binary mask into a compressed counts string, or None
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    m = np.asarray(mask, np.uint8)
    flat = np.ascontiguousarray(m.T.reshape(-1))  # column-major walk
    cap = flat.size * 7 + 16
    out = ctypes.create_string_buffer(cap)
    n = lib.rle_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        flat.size, 1, out, cap)
    if n < 0:
        raise ValueError("rle_encode overflow")
    return out.raw[:n].decode("ascii")
