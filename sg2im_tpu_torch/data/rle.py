"""COCO mask codec: compressed-RLE decode/encode, polygon rasterization,
mask merging (counterpart of ``sg2im_tpu/data/rle.py``).

Replaces the pycocotools C extension used by the reference
(``sg2im/data/coco.py:27,362-373``: ``frPyObjects``, ``merge``, ``decode``).
Implemented from the COCO RLE format specification (LEB128-style base-64
varints with delta coding of run lengths, column-major runs).  Polygon
rasterization uses PIL's scanline fill, which can differ from pycocotools by
sub-pixel edge rules — irrelevant after the reference's 16x16 binary mask
resize, and covered by round-trip tests.

A C fast path (``sg2im_tpu_torch.native``: ``native/rlecodec.c``, built on
demand into ``build/sg2im_tpu_torch/native/``) is used when available; the
numpy path is the always-available fallback, with the same bytes.
"""

from __future__ import annotations

import numpy as np


def decode_rle_counts(counts) -> np.ndarray:
    """Decode a COCO compressed-RLE counts string to run lengths."""
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    out = []
    i = 0
    n = len(counts)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = counts[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return np.asarray(out, np.int64)


def encode_rle_counts(runs) -> bytes:
    """Inverse of decode_rle_counts (COCO compressed counts encoding)."""
    out = bytearray()
    runs = list(map(int, runs))
    for j, x in enumerate(runs):
        if j > 2:
            x -= runs[j - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def rle_to_mask(rle: dict) -> np.ndarray:
    """Decode an RLE dict {'size': [h, w], 'counts': str|list} to a (h, w)
    uint8 mask.  Runs alternate background/foreground down columns
    (column-major, like pycocotools).  Uses the native C codec
    (``sg2im_tpu_torch.native``) when built."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        try:
            from sg2im_tpu_torch.native import rle_decode_native

            m = rle_decode_native(counts, h, w)
            if m is not None:
                return m
        except (OSError, ImportError):
            pass
    if isinstance(counts, (list, tuple, np.ndarray)):
        runs = np.asarray(counts, np.int64)
    else:
        runs = decode_rle_counts(counts)
    vals = np.zeros(len(runs), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, runs)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[: h * w].reshape((w, h)).T


def mask_to_rle(mask: np.ndarray) -> dict:
    """Encode a (h, w) binary mask to compressed RLE (pycocotools layout)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    # run-length encode with leading zero-run
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(idx)
    if flat.size and flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {"size": [h, w],
            "counts": encode_rle_counts(runs).decode("ascii")}


def polygons_to_mask(polygons, width: int, height: int,
                     offset=(0, 0)) -> np.ndarray:
    """Rasterize COCO polygon segmentation (list of flat [x0,y0,x1,y1,...]
    rings) to a (height, width) uint8 mask; rings are OR-merged (the
    reference merges per-ring RLEs, ``coco.py:366-368``).

    ``offset`` (ox, oy) is subtracted from every vertex: rasterizing a
    (w, h) window at integer offset equals cropping the full raster at
    [oy:oy+h, ox:ox+w] PROVIDED every shifted vertex stays >= 0 (PIL's
    float scanline rounds negative coordinates toward zero, so callers
    must anchor the window at or left of the polygon's min vertex —
    pinned by the test_polygon_window_equals_crop property test).
    Vertices are quantized to a 1/64-pixel grid first so the
    integer-offset subtraction is EXACT in float64 (raw float
    subtraction shifts representation error and flips scanline boundary
    pixels); COCO annotations carry at most 0.01-pixel precision, so the
    <=1/128-pixel snap is far below annotation noise."""
    from PIL import Image, ImageDraw

    ox, oy = offset
    img = Image.new("1", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [((round(float(poly[i]) * 64) - ox * 64) / 64.0,
                (round(float(poly[i + 1]) * 64) - oy * 64) / 64.0)
               for i in range(0, len(poly), 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def seg_to_mask(seg, width: int, height: int) -> np.ndarray:
    """Decode any COCO segmentation format to a (height, width) uint8 mask.

    Mirrors reference ``seg_to_mask`` (``sg2im/data/coco.py:362-373``):
    polygon list, uncompressed RLE (counts list), or compressed RLE.
    """
    if isinstance(seg, list):
        return polygons_to_mask(seg, width, height)
    if isinstance(seg["counts"], list):
        return rle_to_mask({"size": seg["size"], "counts": seg["counts"]})
    return rle_to_mask(seg)
