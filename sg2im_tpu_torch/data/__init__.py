"""Data pipeline: scene graphs -> padded batches (this module), image
transforms, the COCO and Visual Genome datasets with their decoders, RLE
codec and decoded-sample cache, and the padded loader with its prefetch to
the card (counterpart of ``sg2im_tpu/data/``).

Host-side numpy, kept inside the port so that the port imports nothing of
the JAX package (tests hold the two copies equal).  This module holds the
counterparts of ``sg2im_tpu/data/scene_graphs.py`` and ``batching.py``
(``GraphBatch``, ``encode_scene_graphs``) and re-exports the deprocess
functions of :mod:`sg2im_tpu_torch.data.transforms`.  Every image's graph
is padded to static (O, T) slots with validity masks; triple
subject/object entries are within-image slot indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sg2im_tpu_torch.data.transforms import (  # noqa: F401 (re-exported)
    IMAGENET_MEAN,
    IMAGENET_STD,
    imagenet_deprocess_batch,
    imagenet_deprocess_batch_torch,
)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class GraphBatch:
    """objs (N, O) int32; triples (N, T, 3) int32 [s, p, o]; obj_mask (N, O)
    bool; triple_mask (N, T) bool."""

    objs: np.ndarray
    triples: np.ndarray
    obj_mask: np.ndarray
    triple_mask: np.ndarray

    def pad_rows(self, n: int) -> "GraphBatch":
        """Append all-padding graphs up to ``n`` rows."""
        def pad(a):
            out = np.zeros((n,) + a.shape[1:], a.dtype)
            out[: a.shape[0]] = a
            return out

        return GraphBatch(*(pad(a) for a in dataclasses.astuple(self)))


def encode_scene_graphs(scene_graphs, vocab, align: int = 1) -> GraphBatch:
    """Encode scene-graph dicts ({"objects": [...], "relationships":
    [[s, pred, o], ...]}) into a GraphBatch.

    Each graph gets the ``__image__`` object and one ``__in_image__``
    triple per object, as the reference's ``forward_json`` adds them.  The
    slot counts are the batch maxima rounded up to ``align``.
    """
    if isinstance(scene_graphs, dict):
        scene_graphs = [scene_graphs]
    name_to_idx = vocab["object_name_to_idx"]
    pred_to_idx = vocab["pred_name_to_idx"]

    objs_list, triples_list = [], []
    for sg in scene_graphs:
        objects = list(sg["objects"]) + ["__image__"]
        image_idx = len(objects) - 1
        rels = [list(r) for r in sg["relationships"]]
        rels += [[j, "__in_image__", image_idx] for j in range(image_idx)]
        obj_ids = []
        for name in objects:
            if name not in name_to_idx:
                raise ValueError(f'Object "{name}" not in vocab')
            obj_ids.append(name_to_idx[name])
        triples = []
        for s, p, o in rels:
            if p not in pred_to_idx:
                raise ValueError(f'Relationship "{p}" not in vocab')
            if not (0 <= s < len(objects)) or not (0 <= o < len(objects)):
                raise ValueError(
                    f"Relationship endpoint out of range: [{s}, {p!r}, {o}] "
                    f"for a {image_idx}-object graph")
            triples.append([s, pred_to_idx[p], o])
        objs_list.append(obj_ids)
        triples_list.append(triples)

    N = len(objs_list)
    O = round_up(max((len(o) for o in objs_list), default=1), align)
    T = round_up(max(max((len(t) for t in triples_list), default=1), 1),
                 align)
    batch = GraphBatch(np.zeros((N, O), np.int32),
                       np.zeros((N, T, 3), np.int32),
                       np.zeros((N, O), bool), np.zeros((N, T), bool))
    for n, (o, t) in enumerate(zip(objs_list, triples_list)):
        batch.objs[n, : len(o)] = o
        batch.obj_mask[n, : len(o)] = True
        batch.triples[n, : len(t)] = np.asarray(t, np.int32).reshape(-1, 3)
        batch.triple_mask[n, : len(t)] = True
    return batch
