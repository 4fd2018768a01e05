"""Weights and inputs from the run's seed: the same seed gives the same
weights, graphs, batches and noise seeds on every run.

Weights are drawn on the device by one ``torch.Generator`` in one call and
shaped per tensor by its kind (:func:`make_weights`); scene graphs and
training batches follow the traffic file's parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Tags that keep the streams of one seed apart.
STREAMS = {"g": 1, "d_obj": 2, "d_img": 3, "graphs": 4, "calls": 5,
           "batches": 6, "arrivals": 7, "sample": 8}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of the run's ``seed``."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1),
                                 STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def _fan_in(shape) -> int:
    return int(np.prod(shape[1:])) if len(shape) > 1 else int(shape[0])


def make_weights(spec, seed: int, stream: str, device) -> dict:
    """{name: float32 tensor} for ``spec`` ((name, shape, kind) triples):
    one draw of normals z on the device, then per kind: weights z *
    sqrt(2 / fan_in), biases 0.01 z, embeddings z, BatchNorm weights 1 +
    0.1 z, biases and running means 0.1 z, running variances exp(0.2 z);
    the box head's last layer 0.1 z / sqrt(fan_in) over biases (0.25,
    0.25, 0.75, 0.75) + 0.05 z, so that boxes start inside the image."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    sizes = [math.prod(shape) for _, shape, _ in spec]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    scale, shift = [], []
    for (name, shape, kind), n in zip(spec, sizes):
        if kind == "weight":
            s, b = math.sqrt(2.0 / _fan_in(shape)), 0.0
        elif kind == "box":
            s, b = 0.1 / math.sqrt(_fan_in(shape)), 0.0
        elif kind == "bias":
            s, b = 0.01, 0.0
        elif kind == "embed":
            s, b = 1.0, 0.0
        elif kind == "bn_weight":
            s, b = 0.1, 1.0
        elif kind in ("bn_bias", "bn_mean"):
            s, b = 0.1, 0.0
        elif kind == "bn_var":
            s, b = 0.2, 0.0
        elif kind == "box_bias":
            s, b = 0.05, 0.0
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        scale.append(s)
        shift.append(b)
    counts = torch.tensor(sizes, device=device)
    flat = (z * torch.tensor(scale, device=device).repeat_interleave(counts)
            + torch.tensor(shift, device=device).repeat_interleave(counts))
    out = {}
    for (name, shape, kind), t in zip(spec, flat.split(sizes)):
        if kind == "bn_var":
            t = t.exp()
        elif kind == "box_bias":
            t = t + torch.tensor([0.25, 0.25, 0.75, 0.75], device=device)
        out[name] = t.reshape(shape)
    return out


def vocab(cfg) -> dict:
    """The configuration's vocabulary: index 0 of the objects is
    '__image__' and of the predicates '__in_image__', as sg2im's datasets
    build them; the others are named by their index, or by the
    configuration's ``predicates``."""
    objs = ["__image__"] + [f"obj{i}" for i in range(1, cfg["num_objects"])]
    preds = cfg.get("predicates") or (
        ["__in_image__"] + [f"pred{i}" for i in range(1,
                                                      cfg["num_predicates"])])
    return {"object_idx_to_name": objs, "pred_idx_to_name": list(preds),
            "object_name_to_idx": {n: i for i, n in enumerate(objs)},
            "pred_name_to_idx": {n: i for i, n in enumerate(preds)}}


def scene_graphs(cfg, traffic, r: np.random.Generator, n: int) -> list:
    """``n`` scene-graph dicts as sg2im's loaders give them: a number of
    objects drawn in [min_objects, max_objects], and one relationship per
    object, to another object, with a predicate drawn from the
    configuration's (never '__in_image__')."""
    v = vocab(cfg)
    objs, preds = v["object_idx_to_name"][1:], v["pred_idx_to_name"][1:]
    out = []
    for _ in range(n):
        k = int(r.integers(traffic["min_objects"], traffic["max_objects"] + 1))
        names = [objs[i] for i in r.integers(0, len(objs), k)]
        rels = []
        for s in range(k):
            o = int(r.integers(0, k - 1))
            rels.append([s, preds[int(r.integers(0, len(preds)))],
                         o + (o >= s)])
        out.append({"objects": names, "relationships": rels})
    return out


def encode(graphs, v) -> dict:
    """Padded int64 / float32 numpy arrays of graphs (objects plus
    '__image__', relationships plus one '__in_image__' per object), padded
    to the batch's largest graph: objs (N, O), triples (N, T, 3),
    obj_mask, triple_mask."""
    objs, triples = [], []
    for g in graphs:
        o = [v["object_name_to_idx"][n] for n in g["objects"]] + [0]
        img = len(o) - 1
        t = [[s, v["pred_name_to_idx"][p], d] for s, p, d in
             g["relationships"]] + [[j, 0, img] for j in range(img)]
        objs.append(o)
        triples.append(t)
    N = len(graphs)
    O = max(len(o) for o in objs)
    T = max(len(t) for t in triples)
    out = {"objs": np.zeros((N, O), np.int64),
           "triples": np.zeros((N, T, 3), np.int64),
           "obj_mask": np.zeros((N, O), np.float32),
           "triple_mask": np.zeros((N, T), np.float32)}
    for i, (o, t) in enumerate(zip(objs, triples)):
        out["objs"][i, :len(o)] = o
        out["triples"][i, :len(t)] = t
        out["obj_mask"][i, :len(o)] = 1.0
        out["triple_mask"][i, :len(t)] = 1.0
    return out


def call_seeds(seed: int, n: int) -> list[int]:
    """``n`` int32 noise seeds, one a call or request."""
    return [int(s) for s in rng(seed, "calls").integers(0, 1 << 31, n)]


def train_batch(cfg, traffic, r: np.random.Generator, gen: torch.Generator,
                device) -> dict:
    """A COCO-like training batch on the device: per image a number of
    objects in [min_objects, max_objects] plus '__image__' (box [0, 0, 1,
    1], a full mask), padded to ``pad_objects``; one relationship per
    object plus its '__in_image__' triple, padded to ``pad_triples``; boxes
    inside the image, at least ``min_box`` wide; binary 16x16 masks;
    normalised images drawn on the device by ``gen``."""
    N, O = traffic["batch_size"], traffic["pad_objects"]
    T = traffic["pad_triples"]
    H, W = cfg["model"]["image_size"]
    M = cfg["model"]["mask_size"]
    n_obj, n_pred = cfg["num_objects"], cfg["num_predicates"]
    objs = np.zeros((N, O), np.int64)
    boxes = np.tile(np.array([0.0, 0.0, 1.0, 1.0], np.float32), (N, O, 1))
    triples = np.zeros((N, T, 3), np.int64)
    obj_mask = np.zeros((N, O), np.float32)
    triple_mask = np.zeros((N, T), np.float32)
    for i in range(N):
        k = int(r.integers(traffic["min_objects"], traffic["max_objects"] + 1))
        objs[i, :k] = r.integers(1, n_obj, k)
        size = r.uniform(traffic["min_box"], 0.7, (k, 2))
        lo = r.uniform(0.0, 1.0 - size)
        boxes[i, :k] = np.concatenate([lo, lo + size], 1)
        obj_mask[i, :k + 1] = 1.0
        rels = []
        for s in range(k):
            o = int(r.integers(0, k - 1))
            rels.append([s, int(r.integers(1, n_pred)), o + (o >= s)])
        rels += [[j, 0, k] for j in range(k)]
        triples[i, :len(rels)] = rels
        triple_mask[i, :len(rels)] = 1.0
    masks = (r.random((N, O, M, M)) > 0.5).astype(np.float32)
    masks[obj_mask == 0] = 0.0
    for i in range(N):
        masks[i, int(obj_mask[i].sum()) - 1] = 1.0  # '__image__'
    b = {"objs": objs, "boxes": boxes, "masks": masks, "triples": triples,
         "obj_mask": obj_mask, "triple_mask": triple_mask}
    b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    b["imgs"] = torch.randn((N, 3, H, W), generator=gen, device=device)
    return b
