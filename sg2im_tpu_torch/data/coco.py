"""COCO-Stuff scene-graph dataset (counterpart of
``sg2im_tpu/data/coco.py``).

Framework-free re-implementation of reference ``CocoSceneGraphDataset``
(``sg2im/data/coco.py:32-373``): loads COCO instances+stuff JSON, filters
objects/images identically (box area > min_object_size, category whitelists,
'other' exclusion, 3<=objects<=8 — ``coco.py:133-195``), and synthesizes a
random heuristic scene graph per ``__getitem__`` from box geometry
(surrounding/inside/left of/right of/above/below by center angle,
``coco.py:314-350``), appending the ``__image__`` node and ``__in_image__``
edges (``coco.py:286-289,352-356``).

Returns numpy arrays (NHWC images, already imagenet-preprocessed).  Batching
into padded GraphBatches happens in ``sg2im_tpu_torch.data.loader``.

Deviations (host-side only, documented):
- RLE decode / polygon rasterization via ``sg2im_tpu_torch.data.rle`` instead of
  the pycocotools C extension.
- The 16x16 mask resize uses PIL bilinear instead of (unpinned-version)
  ``skimage.transform.resize`` (reference ``coco.py:281-283``); masks are
  thresholded at 128 either way.
"""

from __future__ import annotations

import json
import math
import os
from collections import defaultdict

import numpy as np

from sg2im_tpu_torch.data.rle import polygons_to_mask, seg_to_mask
from sg2im_tpu_torch.data.seeding import per_sample_rng
from sg2im_tpu_torch.data.transforms import imagenet_preprocess

COCO_PRED_NAMES = [
    "__in_image__", "left of", "right of", "above", "below", "inside",
    "surrounding",
]


class CocoSceneGraphDataset:
    def __init__(self, image_dir, instances_json, stuff_json=None,
                 stuff_only=True, image_size=(64, 64), mask_size=16,
                 normalize_images=True, max_samples=None,
                 include_relationships=True, min_object_size=0.02,
                 min_objects_per_image=3, max_objects_per_image=8,
                 include_other=False, instance_whitelist=None,
                 stuff_whitelist=None, seed=None, cache_dir=None,
                 decoder="auto"):
        self.image_dir = image_dir
        self.mask_size = mask_size
        self.max_samples = max_samples
        self.normalize_images = normalize_images
        self.include_relationships = include_relationships
        self.image_size = tuple(image_size)
        self.seed = seed
        self.decoder = decoder  # see sg2im_tpu_torch.data.decode backends
        self._epoch = 0

        with open(instances_json) as f:
            instances_data = json.load(f)
        stuff_data = None
        if stuff_json:
            with open(stuff_json) as f:
                stuff_data = json.load(f)

        self.image_ids = []
        self.image_id_to_filename = {}
        self.image_id_to_size = {}
        for image_data in instances_data["images"]:
            image_id = image_data["id"]
            self.image_ids.append(image_id)
            self.image_id_to_filename[image_id] = image_data["file_name"]
            self.image_id_to_size[image_id] = (image_data["width"],
                                               image_data["height"])

        # Vocab from category ids (sparse ids; idx_to_name padded with
        # 'NONE', reference coco.py:175-185).
        self.vocab = {"object_name_to_idx": {}, "pred_name_to_idx": {}}
        object_idx_to_name = {}
        all_instance_categories = []
        for c in instances_data["categories"]:
            all_instance_categories.append(c["name"])
            object_idx_to_name[c["id"]] = c["name"]
            self.vocab["object_name_to_idx"][c["name"]] = c["id"]
        all_stuff_categories = []
        if stuff_data:
            for c in stuff_data["categories"]:
                all_stuff_categories.append(c["name"])
                object_idx_to_name[c["id"]] = c["name"]
                self.vocab["object_name_to_idx"][c["name"]] = c["id"]

        if instance_whitelist is None:
            instance_whitelist = all_instance_categories
        if stuff_whitelist is None:
            stuff_whitelist = all_stuff_categories
        category_whitelist = set(instance_whitelist) | set(stuff_whitelist)

        def keep(object_data):
            image_id = object_data["image_id"]
            _, _, w, h = object_data["bbox"]
            W, H = self.image_id_to_size[image_id]
            box_ok = (w * h) / (W * H) > min_object_size
            name = object_idx_to_name[object_data["category_id"]]
            category_ok = name in category_whitelist
            other_ok = name != "other" or include_other
            return box_ok and category_ok and other_ok

        self.image_id_to_objects = defaultdict(list)
        for od in instances_data["annotations"]:
            if keep(od):
                self.image_id_to_objects[od["image_id"]].append(od)
        if stuff_data:
            image_ids_with_stuff = set()
            for od in stuff_data["annotations"]:
                image_ids_with_stuff.add(od["image_id"])
                if keep(od):
                    self.image_id_to_objects[od["image_id"]].append(od)
            if stuff_only:
                self.image_ids = [i for i in self.image_ids
                                  if i in image_ids_with_stuff]
                for image_id in (set(self.image_id_to_filename)
                                 - image_ids_with_stuff):
                    self.image_id_to_filename.pop(image_id, None)
                    self.image_id_to_size.pop(image_id, None)
                    self.image_id_to_objects.pop(image_id, None)

        self.vocab["object_name_to_idx"]["__image__"] = 0
        name_to_idx = self.vocab["object_name_to_idx"]
        assert len(name_to_idx) == len(set(name_to_idx.values()))
        max_object_idx = max(name_to_idx.values())
        idx_to_name = ["NONE"] * (1 + max_object_idx)
        for name, idx in name_to_idx.items():
            idx_to_name[idx] = name
        self.vocab["object_idx_to_name"] = idx_to_name

        self.image_ids = [
            i for i in self.image_ids
            if min_objects_per_image <= len(self.image_id_to_objects[i])
            <= max_objects_per_image
        ]

        self.vocab["pred_idx_to_name"] = list(COCO_PRED_NAMES)
        self.vocab["pred_name_to_idx"] = {
            n: i for i, n in enumerate(COCO_PRED_NAMES)}

        # Optional decoded-sample memmap cache (data/cache.py): built once
        # here (streams; ~2 ms/sample decode), then every __getitem__ is a
        # memmap slice + cheap triple synthesis — one loader worker feeds
        # any step rate.  Bit-identical to the uncached path
        # (test_coco_cache_bit_identical).
        self._cache = None
        if cache_dir:
            from sg2im_tpu_torch.data.cache import DecodedCache

            from sg2im_tpu_torch.data.cache import file_sig

            n = len(self)
            # Everything the decoded tensors depend on: source-file
            # identity (size+mtime — re-annotated JSONs must invalidate)
            # and every object-selection knob (a changed filter can keep n
            # and the id endpoints identical while changing which objects
            # each sample carries).
            fp = {"dataset": "coco", "n": n,
                  # Decode-pipeline revision: bump when the cached BYTES
                  # can change for identical sources (v2: polygon
                  # vertices quantized to 1/64 px for the windowed
                  # rasterizer) so stale caches invalidate.
                  "pipeline": 2,
                  "image_size": list(self.image_size),
                  "mask_size": mask_size,
                  "image_dir": os.path.abspath(image_dir),
                  "instances": file_sig(instances_json),
                  "stuff": file_sig(stuff_json),
                  "filters": {
                      "min_object_size": min_object_size,
                      "min_objects_per_image": min_objects_per_image,
                      "max_objects_per_image": max_objects_per_image,
                      "include_other": bool(include_other),
                      "stuff_only": bool(stuff_only),
                      "instance_whitelist": sorted(instance_whitelist),
                      "stuff_whitelist": sorted(stuff_whitelist),
                  },
                  "ids": [int(self.image_ids[0]), int(self.image_ids[-1])]
                  if n else []}
            # Only the DCT-prescale decoder changes the cached BYTES
            # (pil / native / auto are bit-identical by self-check), so
            # only it joins the fingerprint — switching between the
            # exact backends keeps existing caches valid.
            from sg2im_tpu_torch.data.decode import resolve_decoder

            if resolve_decoder(decoder) == "native_fast":
                fp["decoder"] = "native_fast"
            cache = DecodedCache(cache_dir, fp)
            if not cache.ready:
                print(f"building decoded-sample cache for {n} samples "
                      f"at {cache_dir} ...")
                cache.build(n, self._decode_invariant,
                            O_cap=max_objects_per_image + 1)
            self._cache = cache

    def total_objects(self) -> int:
        total = 0
        for i, image_id in enumerate(self.image_ids):
            if self.max_samples and i >= self.max_samples:
                break
            total += len(self.image_id_to_objects[image_id])
        return total

    def __len__(self):
        n = len(self.image_ids)
        return n if self.max_samples is None else min(n, self.max_samples)

    def set_epoch(self, epoch: int):
        """Advance the per-sample RNG stream (fresh heuristic triples each
        epoch, reproducibly — see ``sg2im_tpu_torch.data.seeding``).  Prefer
        :meth:`getitem_at_epoch` (no shared mutable state): concurrent
        iterators (e.g. a mid-epoch eval sweep) racing ``set_epoch`` would
        otherwise make in-flight samples' epoch thread-timing-dependent."""
        self._epoch = int(epoch)

    def _load_image_u8(self, image_id):
        from sg2im_tpu_torch.data.decode import load_image_u8

        path = os.path.join(self.image_dir,
                            self.image_id_to_filename[image_id])
        return load_image_u8(path, self.image_size, self.decoder)

    def decode_images_batch(self, indices, n_threads=None):
        """Batched GIL-free native decode of the samples' images (the
        loader's ``batch_decode`` fast path: ONE C++ thread-pool call per
        batch instead of per-sample Python dispatch).  Returns a list
        aligned with ``indices`` of ``(image_u8, (WW, HH))`` with ``None``
        entries for per-sample fallback, or ``None`` when inapplicable
        (decoded cache ready — it already skips decode — or the native
        decoder unavailable)."""
        if self._cache is not None and self._cache.ready:
            return None
        from sg2im_tpu_torch.data.decode import batch_decode_files

        paths = [os.path.join(self.image_dir,
                              self.image_id_to_filename[self.image_ids[i]])
                 for i in indices]
        return batch_decode_files(paths, self.image_size, self.decoder,
                                  n_threads=n_threads)

    def _decode_invariant(self, index, image=None):
        """The epoch-invariant (cacheable) part of a sample: resized uint8
        image + per-object categories / normalized boxes / MxM masks,
        incl. the trailing ``__image__`` node.  The per-epoch heuristic
        triples are synthesized later from these tensors.  ``image``:
        optional pre-decoded ``(image_u8, (WW, HH))`` from
        :meth:`decode_images_batch`."""
        image_id = self.image_ids[index]
        if image is not None:
            image_u8, (WW, HH) = image
        else:
            image_u8, WW, HH = self._load_image_u8(image_id)

        from sg2im_tpu_torch.data.decode import resize_u8

        M = self.mask_size
        objs, boxes, masks = [], [], []
        for od in self.image_id_to_objects[image_id]:
            objs.append(od["category_id"])
            x, y, w, h = od["bbox"]
            boxes.append([x / WW, y / HH, (x + w) / WW, (y + h) / HH])
            # Crop to the box without producing a zero-area region
            # (coco.py:274-279).
            mx0, mx1 = int(round(x)), int(round(x + w))
            my0, my1 = int(round(y)), int(round(y + h))
            mx1 = max(mx0 + 1, mx1)
            my1 = max(my0 + 1, my1)
            seg = od["segmentation"]
            if (isinstance(seg, list)
                    and 0 <= mx0 < mx1 <= WW and 0 <= my0 < my1 <= HH):
                # Polygon fast path: rasterize only the box window
                # (integer-offset rasterization == crop of the full
                # raster; full-canvas fill was ~0.6 ms/sample at 480px).
                # The window anchors at or left of the polygon's min
                # vertex — PIL's scanline is only translation-invariant
                # while shifted coordinates stay >= 0 (rle.py).  Out-of-
                # range boxes fall through to the full raster + numpy
                # crop so pathological boxes keep slice semantics.
                vx = min((p[i] for p in seg if len(p) >= 6
                          for i in range(0, len(p), 2)), default=0)
                vy = min((p[i] for p in seg if len(p) >= 6
                          for i in range(1, len(p), 2)), default=0)
                ax = max(0, min(mx0, math.floor(vx)))
                ay = max(0, min(my0, math.floor(vy)))
                win = polygons_to_mask(seg, mx1 - ax, my1 - ay,
                                       offset=(ax, ay))
                mask = win[my0 - ay:, mx0 - ax:]
            else:
                mask = seg_to_mask(seg, WW, HH)[my0:my1, mx0:mx1]
            if mask.size == 0:
                mask = np.zeros((1, 1), np.uint8)
            mimg = resize_u8(mask * 255, (M, M), self.decoder)
            masks.append((mimg.astype(np.float32) > 128).astype(np.int64))

        objs.append(0)  # __image__
        boxes.append([0.0, 0.0, 1.0, 1.0])
        masks.append(np.ones((M, M), np.int64))
        return {"image": image_u8, "objs": np.asarray(objs, np.int64),
                "boxes": np.asarray(boxes, np.float32),
                "masks": np.stack(masks)}

    def __getitem__(self, index):
        return self.getitem_at_epoch(index, self._epoch)

    def getitem_at_epoch(self, index, epoch: int, image=None):
        """Returns dict(image (H,W,3), objs (O,), boxes (O,4),
        masks (O,M,M), triples (T,3)) — same content as the reference's
        tuple (``coco.py:232-359``) in NHWC numpy form.  ``epoch`` selects
        the per-sample RNG stream explicitly (thread-safe; loaders bind it
        per iterator).  ``image``: optional pre-decoded ``(image_u8,
        (WW, HH))`` from :meth:`decode_images_batch` (byte-identical to
        the in-sample decode)."""
        if self._cache is not None and self._cache.ready:
            c = self._cache.get(index)
            image_u8 = c["image_u8"]
            objs, boxes, masks = c["objs"], c["boxes"], c["masks"]
        else:
            inv = self._decode_invariant(index, image=image)
            image_u8 = inv["image"]
            objs, boxes, masks = inv["objs"], inv["boxes"], inv["masks"]

        image = image_u8.astype(np.float32) / 255.0
        if self.normalize_images:
            image = imagenet_preprocess(image).astype(np.float32)
        rng = per_sample_rng(self.seed, epoch, index)
        triples = self._synthesize_triples(objs, boxes, masks, rng)
        return {"image": image, "objs": objs, "boxes": boxes,
                "masks": masks, "triples": triples}

    def _synthesize_triples(self, objs, boxes, masks, rng):
        """Random heuristic scene graph from box geometry
        (reference ``coco.py:297-356``)."""
        O = len(objs)
        MH = MW = self.mask_size
        # Vectorized mask-weighted centers (one pass over (O, MH, MW)
        # instead of per-object linspace/broadcast/fancy-index — the
        # loop was ~0.9 ms/sample of pure numpy call overhead).
        # Mathematically xs[m].mean() == sum_j count_j * xs_j / count:
        # the row weight of column j is the number of selected pixels in
        # that column.  Arithmetic stays float32 like the reference
        # (torch.linspace + float32 masked mean, coco.py:297-311);
        # float32 summation ORDER differs from both the old per-object
        # path and torch (last-ulp center differences — a predicate flip
        # would need theta within ~1e-7 of a pi/4 boundary), and the
        # per-sample reference-equality tests pin the resulting triples.
        boxes32 = np.asarray(boxes, np.float32)
        x0, y0, x1, y1 = (boxes32[:, k] for k in range(4))
        m = np.asarray(masks) == 1  # (O, MH, MW)
        tx = np.linspace(0.0, 1.0, MW, dtype=np.float32)
        ty = np.linspace(0.0, 1.0, MH, dtype=np.float32)
        xs = x0[:, None] + (x1 - x0)[:, None] * tx[None, :]  # (O, MW)
        ys = y0[:, None] + (y1 - y0)[:, None] * ty[None, :]  # (O, MH)
        cnt = m.sum(axis=(1, 2), dtype=np.float32)  # (O,)
        col_w = m.sum(axis=1, dtype=np.float32)  # (O, MW) px per column
        row_w = m.sum(axis=2, dtype=np.float32)  # (O, MH) px per row
        with np.errstate(invalid="ignore"):
            cx = (col_w * xs).sum(axis=1) / cnt
            cy = (row_w * ys).sum(axis=1) / cnt
        empty = cnt == 0
        cx = np.where(empty, 0.5 * (x0 + x1), cx)
        cy = np.where(empty, 0.5 * (y0 + y1), cy)
        centers = np.stack([cx, cy], axis=1).astype(np.float32)

        triples = []
        real_objs = np.nonzero(objs != 0)[0] if O > 1 else []
        for cur in real_objs:
            choices = [o for o in real_objs if o != cur]
            if not choices or not self.include_relationships:
                break
            other = rng.choice(choices)
            if rng.random() > 0.5:
                s, o = cur, other
            else:
                s, o = other, cur
            sx0, sy0, sx1, sy1 = boxes[s]
            ox0, oy0, ox1, oy1 = boxes[o]
            d = centers[s] - centers[o]
            theta = math.atan2(d[1], d[0])
            if sx0 < ox0 and sx1 > ox1 and sy0 < oy0 and sy1 > oy1:
                p = "surrounding"
            elif sx0 > ox0 and sx1 < ox1 and sy0 > oy0 and sy1 < oy1:
                p = "inside"
            elif theta >= 3 * math.pi / 4 or theta <= -3 * math.pi / 4:
                p = "left of"
            elif -3 * math.pi / 4 <= theta < -math.pi / 4:
                p = "above"
            elif -math.pi / 4 <= theta < math.pi / 4:
                p = "right of"
            else:
                p = "below"
            triples.append([int(s), self.vocab["pred_name_to_idx"][p],
                            int(o)])

        in_image = self.vocab["pred_name_to_idx"]["__in_image__"]
        for i in range(O - 1):
            triples.append([i, in_image, O - 1])
        return np.asarray(triples, np.int64).reshape(-1, 3)
