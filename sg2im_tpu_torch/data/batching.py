"""Padded graph batching (counterpart of ``sg2im_tpu/data/batching.py``).

The reference concatenates per-image graphs into flat ragged tensors with
``obj_to_img`` routing (``sg2im/data/coco.py:376-419``).  Here every
image's graph is padded to static (O, T) slots with validity masks, and
triple subject/object entries are within-image slot indices.
``flat_to_padded`` / ``padded_to_flat`` convert between the two layouts.
Host-side numpy in and out, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class GraphBatch:
    """One padded batch of scene graphs, and optionally their layouts and
    images.

    objs (N, O) int32; triples (N, T, 3) int32 [s, p, o]; obj_mask (N, O)
    bool; triple_mask (N, T) bool; boxes (N, O, 4) f32, masks (N, O, M, M)
    f32 and images (N, H, W, 3) f32, each or None.
    """

    objs: Any
    triples: Any
    obj_mask: Any
    triple_mask: Any
    boxes: Any = None
    masks: Any = None
    images: Any = None

    @property
    def num_images(self) -> int:
        return self.objs.shape[0]

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def pad_rows(self, n: int) -> "GraphBatch":
        """Append all-padding graphs up to ``n`` rows."""
        def pad(a):
            out = np.zeros((n,) + a.shape[1:], a.dtype)
            out[: a.shape[0]] = a
            return out

        return self.replace(**{f.name: pad(getattr(self, f.name))
                               for f in dataclasses.fields(self)
                               if getattr(self, f.name) is not None})


def pad_graphs(
    objs_list: Sequence[np.ndarray],
    triples_list: Sequence[np.ndarray],
    boxes_list: Sequence[np.ndarray] | None = None,
    masks_list: Sequence[np.ndarray] | None = None,
    images: np.ndarray | None = None,
    O_max: int | None = None,
    T_max: int | None = None,
    align: int = 1,
) -> GraphBatch:
    """Pad per-image graphs (within-image indices) into a GraphBatch.

    Args:
      objs_list: per image, (O_i,) int category ids.
      triples_list: per image, (T_i, 3) int [s, p, o] with local s / o.
      boxes_list / masks_list: optional per image (O_i, 4) / (O_i, M, M);
        an entry may be None, and the first present mask sets M.
      O_max / T_max: pad targets (default: the batch maxima rounded up to
        ``align``); a graph beyond them raises ValueError.
    """
    N = len(objs_list)
    o_need = max((len(o) for o in objs_list), default=1)
    t_need = max((len(t) for t in triples_list), default=1)
    O = O_max if O_max is not None else round_up(max(o_need, 1), align)
    T = T_max if T_max is not None else round_up(max(t_need, 1), align)
    if o_need > O or t_need > T:
        raise ValueError(f"graphs exceed pad targets: O {o_need}>{O} or "
                         f"T {t_need}>{T}")

    objs = np.zeros((N, O), np.int32)
    obj_mask = np.zeros((N, O), bool)
    triples = np.zeros((N, T, 3), np.int32)
    triple_mask = np.zeros((N, T), bool)
    boxes = None if boxes_list is None else np.zeros((N, O, 4), np.float32)
    masks = None
    if masks_list is not None:
        present = [m for m in masks_list if m is not None]
        if present:
            M = present[0].shape[-1]
            masks = np.zeros((N, O, M, M), np.float32)

    for n in range(N):
        o = np.asarray(objs_list[n])
        t = np.asarray(triples_list[n]).reshape(-1, 3)
        objs[n, : len(o)] = o
        obj_mask[n, : len(o)] = True
        triples[n, : len(t)] = t
        triple_mask[n, : len(t)] = True
        if boxes is not None and boxes_list[n] is not None:
            boxes[n, : len(o)] = boxes_list[n]
        if masks is not None and masks_list[n] is not None:
            masks[n, : len(o)] = masks_list[n]

    return GraphBatch(objs=objs, triples=triples, obj_mask=obj_mask,
                      triple_mask=triple_mask, boxes=boxes, masks=masks,
                      images=images)


def flat_to_padded(objs, triples, obj_to_img, boxes=None, masks=None,
                   num_imgs=None, O_max=None, T_max=None, align: int = 1):
    """Reference-style flat ragged arrays (global object indices in the
    triples, ``obj_to_img`` routing, in any order) -> a padded GraphBatch.
    A triple belongs to its subject's image."""
    objs = np.asarray(objs)
    triples = np.asarray(triples)
    obj_to_img = np.asarray(obj_to_img)
    N = int(num_imgs) if num_imgs is not None else int(obj_to_img.max()) + 1

    local_idx = np.zeros(len(objs), np.int64)
    t_img = obj_to_img[triples[:, 0]] if len(triples) else obj_to_img[:0]
    per_image = [np.nonzero(obj_to_img == n)[0] for n in range(N)]
    for idx in per_image:
        local_idx[idx] = np.arange(len(idx))
    objs_list, triples_list = [], []
    boxes_list = [] if boxes is not None else None
    masks_list = [] if masks is not None else None
    for n, idx in enumerate(per_image):
        objs_list.append(objs[idx])
        tsel = triples[t_img == n].copy()
        if len(tsel):
            tsel[:, 0] = local_idx[tsel[:, 0]]
            tsel[:, 2] = local_idx[tsel[:, 2]]
        triples_list.append(tsel)
        if boxes_list is not None:
            boxes_list.append(np.asarray(boxes)[idx])
        if masks_list is not None:
            masks_list.append(np.asarray(masks)[idx])
    return pad_graphs(objs_list, triples_list, boxes_list, masks_list,
                      O_max=O_max, T_max=T_max, align=align)


def padded_to_flat(batch: GraphBatch):
    """Inverse of :func:`flat_to_padded`: -> (objs, triples, obj_to_img[,
    boxes][, masks]) flat arrays with global triple indices."""
    objs_out, triples_out, o2i = [], [], []
    boxes_out, masks_out = [], []
    offset = 0
    for n in range(batch.num_images):
        om = np.asarray(batch.obj_mask[n]).astype(bool)
        tm = np.asarray(batch.triple_mask[n]).astype(bool)
        o = np.asarray(batch.objs[n])[om]
        t = np.asarray(batch.triples[n])[tm].copy()
        t[:, 0] += offset
        t[:, 2] += offset
        objs_out.append(o)
        triples_out.append(t)
        o2i.append(np.full(len(o), n, np.int64))
        if batch.boxes is not None:
            boxes_out.append(np.asarray(batch.boxes[n])[om])
        if batch.masks is not None:
            masks_out.append(np.asarray(batch.masks[n])[om])
        offset += len(o)
    out = [np.concatenate(objs_out), np.concatenate(triples_out),
           np.concatenate(o2i)]
    if batch.boxes is not None:
        out.append(np.concatenate(boxes_out))
    if batch.masks is not None:
        out.append(np.concatenate(masks_out))
    return tuple(out)
