"""Visual Genome scene-graph dataset (preprocessed HDF5; counterpart of
``sg2im_tpu/data/vg.py``).

Framework-free re-implementation of reference ``VgSceneGraphDataset``
(``sg2im/data/vg.py:32-141``): reads the preprocess_vg HDF5 schema whole
into memory (``vg.py:52-58``), samples up to ``max_objects`` objects per
image preferring those with relationships (+orphans, ``vg.py:85-104``),
remaps triples, and appends the ``__image__`` node + ``__in_image__`` edges.

Quirk reproduced: when an image has more than ``max_objects - 1`` related
objects the reference samples ``max_objects`` of them (``vg.py:98-99``), so
graphs can end up with ``max_objects + 1`` objects including ``__image__``
— pad targets must allow for it.
"""

from __future__ import annotations

import os

import numpy as np

from sg2im_tpu_torch.data.seeding import per_sample_rng
from sg2im_tpu_torch.data.transforms import imagenet_preprocess


class VgSceneGraphDataset:
    def __init__(self, vocab, h5_path, image_dir, image_size=(256, 256),
                 normalize_images=True, max_objects=10, max_samples=None,
                 include_relationships=True, use_orphaned_objects=True,
                 seed=None, cache_dir=None, decoder="auto"):
        self.image_dir = image_dir
        self.image_size = tuple(image_size)
        self.vocab = vocab
        self.num_objects = len(vocab["object_idx_to_name"])
        self.use_orphaned_objects = use_orphaned_objects
        self.max_objects = max_objects
        self.max_samples = max_samples
        self.include_relationships = include_relationships
        self.normalize_images = normalize_images
        self.seed = seed
        self.decoder = decoder  # see sg2im_tpu_torch.data.decode backends
        self._epoch = 0

        import h5py

        self.data = {}
        with h5py.File(h5_path, "r") as f:
            for k, v in f.items():
                if k == "image_paths":
                    self.image_paths = [
                        p.decode() if isinstance(p, bytes) else str(p)
                        for p in v
                    ]
                else:
                    self.data[k] = np.asarray(v).astype(np.int64)

        # Optional decoded-image memmap cache (data/cache.py): VG's graph
        # tensors are re-sampled per epoch from the in-memory h5 arrays
        # (cheap), so only the image decode + original size are cached.
        self._cache = None
        if cache_dir:
            from sg2im_tpu_torch.data.cache import DecodedCache

            from sg2im_tpu_torch.data.cache import file_sig

            n = len(self)
            # The cached images are indexed by THIS h5's image_paths
            # ordering — key on the file's full identity (abspath + size +
            # mtime), not its basename, so a re-preprocessed h5 at the
            # same name invalidates the cache.
            fp = {"dataset": "vg", "n": n,
                  "image_size": list(self.image_size),
                  "image_dir": os.path.abspath(image_dir),
                  "h5": file_sig(h5_path)}
            # Fingerprint the decoder only when it changes the cached
            # bytes (the DCT-prescale fast mode; pil/native/auto are
            # bit-identical — see data/decode.py).
            from sg2im_tpu_torch.data.decode import resolve_decoder

            if resolve_decoder(decoder) == "native_fast":
                fp["decoder"] = "native_fast"
            cache = DecodedCache(cache_dir, fp)
            if not cache.ready:
                print(f"building decoded-image cache for {n} samples "
                      f"at {cache_dir} ...")
                cache.build(n, self._decode_invariant)
            self._cache = cache

    def decode_images_batch(self, indices, n_threads=None):
        """Batched GIL-free native decode (loader ``batch_decode`` fast
        path; see the COCO dataset's docstring)."""
        if self._cache is not None and self._cache.ready:
            return None
        from sg2im_tpu_torch.data.decode import batch_decode_files

        paths = [os.path.join(self.image_dir, self.image_paths[i])
                 for i in indices]
        return batch_decode_files(paths, self.image_size, self.decoder,
                                  n_threads=n_threads)

    def _decode_invariant(self, index, image=None):
        if image is not None:
            return {"image": image[0], "size": tuple(image[1])}
        from sg2im_tpu_torch.data.decode import load_image_u8

        img_path = os.path.join(self.image_dir, self.image_paths[index])
        arr, WW, HH = load_image_u8(img_path, self.image_size, self.decoder)
        return {"image": arr, "size": (WW, HH)}

    def __len__(self):
        num = self.data["object_names"].shape[0]
        return num if self.max_samples is None else min(self.max_samples, num)

    def set_epoch(self, epoch: int):
        """Advance the per-sample RNG stream (fresh object subsampling each
        epoch, reproducibly — see ``sg2im_tpu_torch.data.seeding``).  Prefer
        :meth:`getitem_at_epoch` (no shared mutable state; see the COCO
        dataset's note)."""
        self._epoch = int(epoch)

    def __getitem__(self, index):
        return self.getitem_at_epoch(index, self._epoch)

    def getitem_at_epoch(self, index, epoch: int, image=None):
        """``image``: optional pre-decoded ``(image_u8, (WW, HH))`` from
        :meth:`decode_images_batch` (byte-identical to in-sample decode)."""
        if self._cache is not None and self._cache.ready:
            c = self._cache.get(index)
            arr_u8, (WW, HH) = c["image_u8"], c["size"]
        else:
            inv = self._decode_invariant(index, image=image)
            arr_u8, (WW, HH) = inv["image"], inv["size"]
        arr = arr_u8.astype(np.float32) / 255.0
        if self.normalize_images:
            arr = imagenet_preprocess(arr)
        image = arr.astype(np.float32)

        num_objs_img = int(self.data["objects_per_image"][index])
        num_rels = int(self.data["relationships_per_image"][index])
        obj_idxs_with_rels = set()
        obj_idxs_without_rels = set(range(num_objs_img))
        for r in range(num_rels):
            s = int(self.data["relationship_subjects"][index, r])
            o = int(self.data["relationship_objects"][index, r])
            obj_idxs_with_rels.update((s, o))
            obj_idxs_without_rels.discard(s)
            obj_idxs_without_rels.discard(o)

        rng = per_sample_rng(self.seed, epoch, index)
        obj_idxs = list(obj_idxs_with_rels)
        orphans = list(obj_idxs_without_rels)
        if len(obj_idxs) > self.max_objects - 1:
            # Reference samples max_objects here, not max_objects-1
            # (vg.py:98-99) — reproduced.
            obj_idxs = rng.sample(obj_idxs, self.max_objects)
        if len(obj_idxs) < self.max_objects - 1 and self.use_orphaned_objects:
            num_to_add = min(self.max_objects - 1 - len(obj_idxs),
                             len(orphans))
            obj_idxs += rng.sample(orphans, num_to_add)
        O = len(obj_idxs) + 1

        objs = np.full(O, -1, np.int64)
        boxes = np.tile(np.array([0, 0, 1, 1], np.float32), (O, 1))
        mapping = {}
        for i, obj_idx in enumerate(obj_idxs):
            objs[i] = self.data["object_names"][index, obj_idx]
            x, y, w, h = self.data["object_boxes"][index, obj_idx].tolist()
            boxes[i] = [x / WW, y / HH, (x + w) / WW, (y + h) / HH]
            mapping[obj_idx] = i
        objs[O - 1] = self.vocab["object_name_to_idx"]["__image__"]

        triples = []
        for r in range(num_rels):
            if not self.include_relationships:
                break
            s = mapping.get(int(self.data["relationship_subjects"][index, r]))
            o = mapping.get(int(self.data["relationship_objects"][index, r]))
            p = int(self.data["relationship_predicates"][index, r])
            if s is not None and o is not None:
                triples.append([s, p, o])
        in_image = self.vocab["pred_name_to_idx"]["__in_image__"]
        for i in range(O - 1):
            triples.append([i, in_image, O - 1])

        return {"image": image, "objs": objs, "boxes": boxes, "masks": None,
                "triples": np.asarray(triples, np.int64).reshape(-1, 3)}
