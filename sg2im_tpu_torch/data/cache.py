"""Decoded-sample memmap cache: removes JPEG/RLE decode from the hot path
(counterpart of ``sg2im_tpu/data/cache.py``; the files are the same, so
either package reads a cache the other built).

The reference feeds its GPU with 4 torch ``DataLoader`` worker *processes*
(``scripts/train.py:296-305``) because every ``__getitem__`` pays a JPEG
decode + per-object RLE decode + PIL mask resize, which costs host cores
in proportion to the step rate.  This cache removes the dependency: the
epoch-INVARIANT decoded tensors of every sample (resized uint8 image,
category ids, normalized boxes, thresholded MxM masks) are written once
into a handful of memory-mapped array files; afterwards a read is a memmap
slice — microseconds, no PIL/RLE, a single worker feeds any step rate.

The epoch-VARYING part of a sample (COCO's random heuristic triples,
reference ``coco.py:297-356``) is NOT cached: datasets re-synthesize it
per (seed, epoch, index) from the cached geometry, so cached and uncached
samples are bit-identical for every epoch
(``tests/test_torch_data.py``).

Layout under ``cache_dir``:
  meta.json                        fingerprint + shapes
  images.u8   (n, H, W, 3) uint8   post-resize, pre-normalize (lossless:
                                   PIL resize output IS uint8)
  objs.i32    (n, O_cap)           category ids, padded 0
  boxes.f32   (n, O_cap, 4)
  masks.u8    (n, O_cap, M, M)     only when the dataset has masks
  counts.i32  (n,)                 real objects per sample
"""

from __future__ import annotations

import json
import os

import numpy as np


def file_sig(path) -> list | None:
    """Identity of a source file for cache fingerprints: [abspath, size,
    mtime_ns].  Basenames or paths alone are not enough — re-generating a
    source file (new preprocess run, edited annotations) must invalidate
    any cache keyed on it."""
    if path is None:
        return None
    st = os.stat(path)
    return [os.path.abspath(path), st.st_size, st.st_mtime_ns]


class DecodedCache:
    """Build/read a memmap cache of epoch-invariant decoded samples.

    ``fingerprint`` must capture everything the decoded tensors depend on
    (dataset length, image size, mask size, source paths) — a mismatch
    triggers a rebuild rather than serving stale tensors.
    """

    ARRAYS = {"images": np.uint8, "objs": np.int32, "boxes": np.float32,
              "masks": np.uint8, "counts": np.int32, "sizes": np.int32}

    def __init__(self, cache_dir: str, fingerprint: dict):
        self.dir = cache_dir
        self.fingerprint = dict(fingerprint)
        self._arrays: dict[str, np.memmap] | None = None

    @property
    def ready(self) -> bool:
        if self._arrays is not None:
            return True
        meta_path = os.path.join(self.dir, "meta.json")
        if not os.path.isfile(meta_path):
            return False
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        if meta.get("fingerprint") != self.fingerprint:
            return False
        self._open(meta)
        return True

    def _path(self, name, dtype):
        suffix = {"uint8": "u8", "int32": "i32", "float32": "f32"}[
            np.dtype(dtype).name]
        return os.path.join(self.dir, f"{name}.{suffix}")

    def _open(self, meta):
        arrays = {}
        for name, shape in meta["shapes"].items():
            dtype = self.ARRAYS[name]
            arrays[name] = np.memmap(self._path(name, dtype), dtype=dtype,
                                     mode="r", shape=tuple(shape))
        self._arrays = arrays

    def build(self, n: int, decode_fn, O_cap: int = 0,
              progress_every: int = 2000, workers: int | None = None):
        """Decode all ``n`` samples once via ``decode_fn(i) -> dict`` and
        stream them into the memmap files (constant memory; real COCO is
        ~100k samples).  ``decode_fn`` returns image (H,W,3 u8 or f32 in
        [0,1]) plus any of: objs (O,) / boxes (O,4) / masks (O,M,M)
        (ragged per-object tensors, require ``O_cap`` — the dataset's
        per-image object cap) and size (2,) (original WxH, for datasets
        that re-derive geometry per epoch, e.g. VG)."""
        if n <= 0:
            raise ValueError(
                "refusing to build a decoded-sample cache for an empty "
                "dataset (0 samples after filtering) — check the dataset "
                "filters / --num_train_samples")
        os.makedirs(self.dir, exist_ok=True)
        first = decode_fn(0)
        H, W = first["image"].shape[:2]
        has_objs = first.get("objs") is not None
        has_masks = first.get("masks") is not None
        has_size = first.get("size") is not None
        M = first["masks"].shape[-1] if has_masks else 0

        shapes = {"images": (n, H, W, 3), "counts": (n,)}
        if has_objs:
            assert O_cap > 0 and len(first["objs"]) <= O_cap
            shapes["objs"] = (n, O_cap)
            shapes["boxes"] = (n, O_cap, 4)
        if has_masks:
            shapes["masks"] = (n, O_cap, M, M)
        if has_size:
            shapes["sizes"] = (n, 2)
        # Build into per-process tmp files, then atomically os.replace into
        # place (meta.json last).  Concurrent builders — e.g. a multihost
        # start skew where a straggler begins building while another
        # process already reads — never truncate live files: each writes
        # its own tmp set, replace is atomic, and an already-open reader
        # keeps its old inode.  Last build wins with identical bytes
        # (decode is deterministic).
        tmp_suffix = f".tmp.{os.getpid()}"
        arrays = {name: np.memmap(self._path(name, self.ARRAYS[name])
                                  + tmp_suffix,
                                  dtype=self.ARRAYS[name], mode="w+",
                                  shape=shape)
                  for name, shape in shapes.items()}
        # Decode in a thread pool (the heavy parts — libjpeg/libpng via
        # ctypes, PIL, numpy — release the GIL; one-time build scales
        # with host cores), write sequentially in index order here.
        from concurrent.futures import ThreadPoolExecutor

        if workers is None:
            workers = min(16, os.cpu_count() or 1)

        def records():
            yield first
            if n == 1:
                return
            if workers <= 1:
                for i in range(1, n):
                    yield decode_fn(i)
                return
            # Windowed submission (Executor.map would enqueue all n
            # upfront; a slow writer would then buffer unbounded decoded
            # samples).  In-flight is capped at 4x workers.
            import collections

            with ThreadPoolExecutor(workers) as ex:
                pending = collections.deque()
                idxs = iter(range(1, n))
                for i in idxs:
                    pending.append(ex.submit(decode_fn, i))
                    if len(pending) >= workers * 4:
                        break
                while pending:
                    rec = pending.popleft().result()
                    nxt = next(idxs, None)
                    if nxt is not None:
                        pending.append(ex.submit(decode_fn, nxt))
                    yield rec

        for i, s in enumerate(records()):
            img = s["image"]
            if img.dtype != np.uint8:
                img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
            arrays["images"][i] = img
            if has_objs:
                O = len(s["objs"])
                assert O <= O_cap, (O, O_cap)
                arrays["counts"][i] = O
                arrays["objs"][i, :O] = s["objs"]
                arrays["boxes"][i, :O] = s["boxes"]
                if has_masks:
                    arrays["masks"][i, :O] = s["masks"]
            if has_size:
                arrays["sizes"][i] = s["size"]
            if progress_every and i and i % progress_every == 0:
                print(f"  cache build: {i}/{n}")
        for name, a in arrays.items():
            a.flush()
            final = self._path(name, self.ARRAYS[name])
            os.replace(final + tmp_suffix, final)
        meta_path = os.path.join(self.dir, "meta.json")
        with open(meta_path + tmp_suffix, "w") as f:
            json.dump({"fingerprint": self.fingerprint,
                       "shapes": {k: list(v) for k, v in shapes.items()}},
                      f)
        os.replace(meta_path + tmp_suffix, meta_path)
        self._arrays = {k: np.memmap(self._path(k, self.ARRAYS[k]),
                                     dtype=self.ARRAYS[k], mode="r",
                                     shape=shapes[k])
                        for k in arrays}

    def get(self, i: int) -> dict:
        """Epoch-invariant tensors for sample ``i``.

        ``image_u8`` and ``boxes`` are READ-ONLY views into the memmap
        (zero-copy; the dtype-converting fields are fresh arrays).  Every
        in-tree consumer copies on its first transform (normalize /
        collate-pad); a caller that wants to mutate in place must
        ``np.array(...)`` first."""
        a = self._arrays
        out = {"image_u8": np.asarray(a["images"][i])}
        if "objs" in a:
            O = int(a["counts"][i])
            out["objs"] = np.asarray(a["objs"][i, :O], np.int64)
            out["boxes"] = np.asarray(a["boxes"][i, :O])
            if "masks" in a:
                out["masks"] = np.asarray(a["masks"][i, :O], np.int64)
        if "sizes" in a:
            out["size"] = (int(a["sizes"][i, 0]), int(a["sizes"][i, 1]))
        return out
