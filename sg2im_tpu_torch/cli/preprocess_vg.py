"""preprocess_vg CLI: Visual Genome raw JSON -> train/val/test HDF5 + vocab.

The port's own copy of ``sg2im_tpu/cli/preprocess_vg.py`` (upstream
``scripts/preprocess_vg.py:33-512``); it uses no framework.  It writes the
HDF5 schema (upstream ``preprocess_vg.py:489-502``) that the port's
``data.vg.VgSceneGraphDataset`` reads: per-split padded int32 arrays (pad
-1), a vlen-str ``image_paths`` dataset, and ``vocab.json`` with the
object, attribute and predicate vocabularies ('__image__' and
'__in_image__' at index 0).  The default split file is the port's copy of
upstream's ``vg_splits.json``.

    python -m sg2im_tpu_torch.cli.preprocess_vg --images_json ... \
        --output_h5_dir datasets/vg --output_vocab_json datasets/vg/vocab.json

Filters are upstream's defaults: min image side 200px, objects with
>= 2000 training instances and >= 32px sides, attributes >= 2000,
relationships >= 500 instances, 3-30 objects and 1-30 relationships per
image (``preprocess_vg.py:53-67``).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter, defaultdict

import numpy as np


def build_parser():
    VG_DIR = "datasets/vg"
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--splits_json", default=os.path.join(
                       os.path.dirname(os.path.dirname(__file__)), "data",
                       "vg_splits.json"))
    p.add_argument("--images_json",
                   default=os.path.join(VG_DIR, "image_data.json"))
    p.add_argument("--objects_json",
                   default=os.path.join(VG_DIR, "objects.json"))
    p.add_argument("--attributes_json",
                   default=os.path.join(VG_DIR, "attributes.json"))
    p.add_argument("--object_aliases",
                   default=os.path.join(VG_DIR, "object_alias.txt"))
    p.add_argument("--relationship_aliases",
                   default=os.path.join(VG_DIR, "relationship_alias.txt"))
    p.add_argument("--relationships_json",
                   default=os.path.join(VG_DIR, "relationships.json"))
    p.add_argument("--min_image_size", default=200, type=int)
    p.add_argument("--train_split", default="train")
    p.add_argument("--min_object_instances", default=2000, type=int)
    p.add_argument("--min_attribute_instances", default=2000, type=int)
    p.add_argument("--min_object_size", default=32, type=int)
    p.add_argument("--min_objects_per_image", default=3, type=int)
    p.add_argument("--max_objects_per_image", default=30, type=int)
    p.add_argument("--max_attributes_per_image", default=30, type=int)
    p.add_argument("--min_relationship_instances", default=500, type=int)
    p.add_argument("--min_relationships_per_image", default=1, type=int)
    p.add_argument("--max_relationships_per_image", default=30, type=int)
    p.add_argument("--output_vocab_json",
                   default=os.path.join(VG_DIR, "vocab.json"))
    p.add_argument("--output_h5_dir", default=VG_DIR)
    return p


def load_aliases(path):
    """Alias txt: comma-separated synonym lines; all map to the first
    (reference ``preprocess_vg.py:206-214``)."""
    aliases = {}
    with open(path) as f:
        for line in f:
            parts = [s.strip() for s in line.split(",")]
            for s in parts:
                aliases[s] = parts[0]
    return aliases


def remove_small_images(min_size, image_id_to_image, splits):
    out = {}
    for split_name, ids in splits.items():
        kept = [i for i in ids
                if min(image_id_to_image[i]["height"],
                       image_id_to_image[i]["width"]) >= min_size]
        print(f'Removed {len(ids) - len(kept)} images from split '
              f'"{split_name}" for being too small')
        out[split_name] = kept
    return out


def create_object_vocab(args, train_ids, objects, aliases, vocab):
    train_ids = set(train_ids)
    counter = Counter()
    for image in objects:
        if image["image_id"] not in train_ids:
            continue
        for obj in image["objects"]:
            counter.update({aliases.get(n, n) for n in obj["names"]})
    names = ["__image__"] + [n for n, c in counter.most_common()
                             if c >= args.min_object_instances]
    print(f"Found {len(names)} object categories with >= "
          f"{args.min_object_instances} training instances")
    vocab["object_name_to_idx"] = {n: i for i, n in enumerate(names)}
    vocab["object_idx_to_name"] = list(names)


def create_attribute_vocab(args, train_ids, attributes, vocab):
    train_ids = set(train_ids)
    counter = Counter()
    for image in attributes:
        if image["image_id"] not in train_ids:
            continue
        for attr in image["attributes"]:
            if "attributes" in attr:
                counter.update(set(attr["attributes"]))
    names = [n for n, c in counter.most_common()
             if c >= args.min_attribute_instances]
    print(f"Found {len(names)} attribute categories with >= "
          f"{args.min_attribute_instances} training instances")
    vocab["attribute_name_to_idx"] = {n: i for i, n in enumerate(names)}
    vocab["attribute_idx_to_name"] = list(names)


def filter_objects(args, objects, aliases, vocab, splits):
    all_ids = set()
    for ids in splits.values():
        all_ids |= set(ids)
    name_to_idx = vocab["object_name_to_idx"]
    object_id_to_obj = {}
    num_too_small = 0
    for image in objects:
        if image["image_id"] not in all_ids:
            continue
        for obj in image["objects"]:
            final = next(
                (aliases.get(n, n) for n in obj["names"]
                 if aliases.get(n, n) in name_to_idx), None)
            too_small = (obj["w"] < args.min_object_size
                         or obj["h"] < args.min_object_size)
            if too_small:
                num_too_small += 1
            if final is not None and not too_small:
                object_id_to_obj[obj["object_id"]] = {
                    "name": final,
                    "name_idx": name_to_idx[final],
                    "box": [obj["x"], obj["y"], obj["w"], obj["h"]],
                }
    print(f"Skipped {num_too_small} objects with size < "
          f"{args.min_object_size}")
    return object_id_to_obj


def create_rel_vocab(args, train_ids, relationships, object_id_to_obj,
                     rel_aliases, vocab):
    pred_counter = defaultdict(int)
    train_ids = set(train_ids)
    for image in relationships:
        if image["image_id"] not in train_ids:
            continue
        for rel in image["relationships"]:
            if (rel["subject"]["object_id"] not in object_id_to_obj
                    or rel["object"]["object_id"] not in object_id_to_obj):
                continue
            pred = rel["predicate"].lower().strip()
            pred = rel_aliases.get(pred, pred)
            rel["predicate"] = pred
            pred_counter[pred] += 1
    names = ["__in_image__"] + [
        p for p, c in pred_counter.items()
        if c >= args.min_relationship_instances]
    print(f"Found {len(names)} relationship types with >= "
          f"{args.min_relationship_instances} training instances")
    vocab["pred_name_to_idx"] = {n: i for i, n in enumerate(names)}
    vocab["pred_idx_to_name"] = list(names)


def encode_graphs(args, splits, objects, relationships, vocab,
                  object_id_to_obj, attributes):
    image_id_to_objects = {im["image_id"]: im["objects"] for im in objects}
    image_id_to_rels = {im["image_id"]: im["relationships"]
                        for im in relationships}
    image_id_to_attrs = {im["image_id"]: im["attributes"]
                         for im in attributes}

    col_names = (
        "image_ids", "object_ids", "object_names", "object_boxes",
        "objects_per_image", "relationship_ids", "relationship_subjects",
        "relationship_predicates", "relationship_objects",
        "relationships_per_image", "attributes_per_object",
        "object_attributes",
    )
    out = {}
    for split, image_ids in splits.items():
        skip = defaultdict(int)
        cols = {k: [] for k in col_names}
        for image_id in image_ids:
            obj_ids, obj_names, obj_boxes = [], [], []
            oid_to_idx = {}
            for obj in image_id_to_objects[image_id]:
                oid = obj["object_id"]
                if oid not in object_id_to_obj:
                    continue
                rec = object_id_to_obj[oid]
                oid_to_idx[oid] = len(obj_ids)
                obj_ids.append(oid)
                obj_names.append(rec["name_idx"])
                obj_boxes.append(rec["box"])
            num_objects = len(obj_ids)
            if num_objects < args.min_objects_per_image:
                skip["too_few_objects"] += 1
                continue
            if num_objects > args.max_objects_per_image:
                skip["too_many_objects"] += 1
                continue

            r_ids, r_subs, r_preds, r_objs = [], [], [], []
            for rel in image_id_to_rels[image_id]:
                pred_idx = vocab["pred_name_to_idx"].get(rel["predicate"])
                sidx = oid_to_idx.get(rel["subject"]["object_id"])
                oidx = oid_to_idx.get(rel["object"]["object_id"])
                if pred_idx is None or sidx is None or oidx is None:
                    continue
                r_ids.append(rel["relationship_id"])
                r_subs.append(sidx)
                r_preds.append(pred_idx)
                r_objs.append(oidx)
            num_rels = len(r_ids)
            if num_rels < args.min_relationships_per_image:
                skip["too_few_relationships"] += 1
                continue
            if num_rels > args.max_relationships_per_image:
                skip["too_many_relationships"] += 1
                continue

            oid_to_attrs = {a["object_id"]: a.get("attributes")
                            for a in image_id_to_attrs[image_id]}
            num_attrs = []
            for oid in obj_ids:
                attrs = oid_to_attrs.get(oid)
                if attrs is None:
                    cols["object_attributes"].append(
                        [-1] * args.max_attributes_per_image)
                    num_attrs.append(0)
                else:
                    ids = []
                    for a in attrs:
                        if a in vocab["attribute_name_to_idx"]:
                            ids.append(vocab["attribute_name_to_idx"][a])
                        if len(ids) >= args.max_attributes_per_image:
                            break
                    num_attrs.append(len(ids))
                    ids += [-1] * (args.max_attributes_per_image - len(ids))
                    cols["object_attributes"].append(ids)

            pad_o = args.max_objects_per_image
            obj_ids += [-1] * (pad_o - len(obj_ids))
            obj_names += [-1] * (pad_o - len(obj_names))
            obj_boxes += [[-1] * 4] * (pad_o - len(obj_boxes))
            num_attrs += [-1] * (pad_o - len(num_attrs))
            pad_r = args.max_relationships_per_image
            r_ids += [-1] * (pad_r - len(r_ids))
            r_subs += [-1] * (pad_r - len(r_subs))
            r_preds += [-1] * (pad_r - len(r_preds))
            r_objs += [-1] * (pad_r - len(r_objs))

            cols["image_ids"].append(image_id)
            cols["object_ids"].append(obj_ids)
            cols["object_names"].append(obj_names)
            cols["object_boxes"].append(obj_boxes)
            cols["objects_per_image"].append(num_objects)
            cols["relationship_ids"].append(r_ids)
            cols["relationship_subjects"].append(r_subs)
            cols["relationship_predicates"].append(r_preds)
            cols["relationship_objects"].append(r_objs)
            cols["relationships_per_image"].append(num_rels)
            cols["attributes_per_object"].append(num_attrs)

        print(f'Skip stats for split "{split}": {dict(skip)}')
        out[split] = {
            k: np.asarray(v).astype(np.int32)
            for k, v in cols.items()
        }
    return out


def get_image_paths(image_id_to_image, image_ids):
    paths = []
    for image_id in image_ids:
        base, filename = os.path.split(image_id_to_image[image_id]["url"])
        paths.append(os.path.join(os.path.basename(base), filename))
    return paths


def main(argv=None):
    import h5py

    args = build_parser().parse_args(argv)
    with open(args.images_json) as f:
        images = json.load(f)
    image_id_to_image = {i["image_id"]: i for i in images}
    with open(args.splits_json) as f:
        splits = json.load(f)
    splits = remove_small_images(args.min_image_size, image_id_to_image,
                                 splits)
    obj_aliases = load_aliases(args.object_aliases)
    rel_aliases = load_aliases(args.relationship_aliases)
    with open(args.objects_json) as f:
        objects = json.load(f)

    vocab = {}
    train_ids = splits[args.train_split]
    create_object_vocab(args, train_ids, objects, obj_aliases, vocab)
    with open(args.attributes_json) as f:
        attributes = json.load(f)
    create_attribute_vocab(args, train_ids, attributes, vocab)
    object_id_to_obj = filter_objects(args, objects, obj_aliases, vocab,
                                      splits)
    print(f"After filtering there are {len(object_id_to_obj)} object "
          f"instances")
    with open(args.relationships_json) as f:
        relationships = json.load(f)
    create_rel_vocab(args, train_ids, relationships, object_id_to_obj,
                     rel_aliases, vocab)

    arrays = encode_graphs(args, splits, objects, relationships, vocab,
                           object_id_to_obj, attributes)
    os.makedirs(args.output_h5_dir, exist_ok=True)
    for split_name, split_arrays in arrays.items():
        image_ids = list(split_arrays["image_ids"].astype(int))
        h5_path = os.path.join(args.output_h5_dir, f"{split_name}.h5")
        print(f'Writing file "{h5_path}"')
        with h5py.File(h5_path, "w") as h5:
            for name, ary in split_arrays.items():
                h5.create_dataset(name, data=ary)
            paths = get_image_paths(image_id_to_image, image_ids)
            dset = h5.create_dataset(
                "image_paths", (len(paths),),
                dtype=h5py.special_dtype(vlen=str))
            for i, p in enumerate(paths):
                dset[i] = p
    with open(args.output_vocab_json, "w") as f:
        json.dump(vocab, f)
    print(f'Wrote vocab to "{args.output_vocab_json}"')
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
