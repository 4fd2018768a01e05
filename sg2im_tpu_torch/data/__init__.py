"""Data pipeline: scene graphs -> padded batches, image transforms, the
COCO and Visual Genome datasets with their decoders, RLE codec and
decoded-sample cache, and the padded loader with its prefetch to the card
(counterpart of ``sg2im_tpu/data/``).

Host-side numpy, kept inside the port so that the port imports nothing of
the JAX package (tests hold the two copies equal).  This module holds the
counterpart of ``sg2im_tpu/data/scene_graphs.py`` (``encode_scene_graphs``)
and exports, as the JAX package's does, the padded batching of
:mod:`sg2im_tpu_torch.data.batching` (``GraphBatch``, ``pad_graphs``,
``flat_to_padded``, ``padded_to_flat``) and the deprocess functions of
:mod:`sg2im_tpu_torch.data.transforms`.
"""

from __future__ import annotations

import numpy as np

from sg2im_tpu_torch.data.batching import (  # noqa: F401 (re-exported)
    GraphBatch,
    flat_to_padded,
    pad_graphs,
    padded_to_flat,
    round_up,
)
from sg2im_tpu_torch.data.transforms import (  # noqa: F401 (re-exported)
    IMAGENET_MEAN,
    IMAGENET_STD,
    imagenet_deprocess,
    imagenet_deprocess_batch,
    imagenet_deprocess_batch_torch,
    imagenet_preprocess,
)

__all__ = [
    "GraphBatch",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "encode_scene_graphs",
    "flat_to_padded",
    "imagenet_deprocess",
    "imagenet_deprocess_batch",
    "imagenet_preprocess",
    "pad_graphs",
    "padded_to_flat",
]


def encode_scene_graphs(scene_graphs, vocab, O_max: int | None = None,
                        T_max: int | None = None,
                        align: int = 1) -> GraphBatch:
    """Encode one scene-graph dict or a list of them ({"objects": [...],
    "relationships": [[s, pred, o], ...]}) into a GraphBatch.

    Each graph gets the ``__image__`` object and one ``__in_image__``
    triple per object, as the reference's ``forward_json`` adds them.  The
    slot counts are ``O_max`` / ``T_max``, or else the batch maxima
    rounded up to ``align``.
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

    return pad_graphs(
        [np.asarray(o, np.int32) for o in objs_list],
        [np.asarray(t, np.int32).reshape(-1, 3) for t in triples_list],
        O_max=O_max, T_max=T_max, align=align)
