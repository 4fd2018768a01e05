"""sample_images CLI: bulk sampling over a validation set, on a CUDA card
by default (counterpart of ``sg2im_tpu/cli/sample_images.py``, upstream
``scripts/sample_images.py:40-72``).

    python -m sg2im_tpu_torch.cli.sample_images --checkpoint ckpt.pt \\
        --dataset coco --coco_image_dir ... --instances_json ... \\
        --stuff_json ... --output_dir samples [--device cpu]

Loads a reference-layout ``.pt`` or a checkpoint directory of the port's
Trainer or of the JAX package's (``state.msgpack``), rebuilds the dataset
from the checkpoint's own training args (the args travel with the
weights, upstream ``sample_images.py:76-109``), and
writes ``img/img%06d.png`` (plus, on request, ``gt_img/``, GraphViz renders
of the graphs under ``graphs/`` and ``data.npz`` of boxes, objects and
masks, row i for image i).  ``--checkpoint_list`` names checkpoints or
snapshot directories (every ``snapshot_*`` file inside, in name order),
one per line; each gets ``<output_dir>/result<i>[_<tag>]``.

Every flag of the JAX CLI, plus ``--device``.  The layout noise is the JAX
CLI's: ``rng = PRNGKey(--seed)``, then for each batch ``rng, k =
split(rng)`` and ``normal(k, (batch, H, W, layout_noise_dim))``, drawn on
the device by the threefry kernel (``ops.prng``).  The last batch is
padded to the full batch size and its padded rows dropped.
``--model_mode train`` normalises with each batch's statistics; the
running statistics it would move are discarded.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sg2im_tpu_torch.utils.flags import bool_flag, int_tuple


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default="sg2im-models/vg64.pt")
    p.add_argument("--checkpoint_list", default=None)
    p.add_argument("--model_mode", default="eval",
                   choices=["train", "eval"])
    p.add_argument("--dataset", default="vg", choices=["coco", "vg"])
    p.add_argument("--image_size", default="64,64", type=int_tuple)
    p.add_argument("--batch_size", default=24, type=int)
    p.add_argument("--shuffle", default=False, type=bool_flag)
    p.add_argument("--loader_num_workers", default=4, type=int)
    p.add_argument("--num_samples", default=10000, type=int)
    p.add_argument("--save_gt_imgs", default=False, type=bool_flag)
    p.add_argument("--save_graphs", default=False, type=bool_flag)
    p.add_argument("--use_gt_boxes", default=False, type=bool_flag)
    p.add_argument("--use_gt_masks", default=False, type=bool_flag)
    p.add_argument("--save_layout", default=True, type=bool_flag)
    p.add_argument("--decoder", default="auto",
                   choices=["auto", "pil", "native", "native_fast"],
                   help="image decode backend (data/decode.py)")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--vg_h5", default="datasets/vg/val.h5")
    p.add_argument("--vg_image_dir", default="datasets/vg/images")
    p.add_argument("--coco_image_dir",
                   default="datasets/coco/images/val2017")
    p.add_argument("--instances_json",
                   default="datasets/coco/annotations/instances_val2017.json")
    p.add_argument("--stuff_json",
                   default="datasets/coco/annotations/stuff_val2017.json")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on; 'cuda' fails without "
                        "a card rather than running on the CPU")
    return p


def load_bundle(path) -> dict:
    """{'model_kwargs', 'vocab', 'generator', 'args'} of a reference-layout
    ``.pt`` or of a checkpoint directory of either Trainer (``ckpt.store``:
    the port's ``state.pt`` or the JAX package's ``state.msgpack``)."""
    from sg2im_tpu_torch.ckpt import load_reference_bundle

    if not os.path.isdir(path):
        return load_reference_bundle(path)
    from sg2im_tpu_torch.ckpt.store import load_checkpoint
    from sg2im_tpu_torch.train.config import TrainConfig

    try:
        state, meta = load_checkpoint(path)
    except ValueError as e:  # no state file of either Trainer
        raise SystemExit(f"not a checkpoint directory: {e}") from None
    cfg = meta.get("config") or {}
    config = TrainConfig.from_dict(cfg)
    return {"model_kwargs": config.generator_kwargs(),
            "vocab": meta["vocab"], "generator": state.g, "args": cfg}


def _build_dataset(args, ckpt_args, vocab):
    if args.dataset == "coco":
        from sg2im_tpu_torch.data.coco import CocoSceneGraphDataset

        return CocoSceneGraphDataset(
            image_dir=args.coco_image_dir,
            instances_json=args.instances_json,
            stuff_json=args.stuff_json,
            stuff_only=ckpt_args.get("coco_stuff_only", True),
            image_size=tuple(args.image_size),
            mask_size=ckpt_args.get("mask_size", 16),
            max_samples=args.num_samples,
            min_object_size=ckpt_args.get("min_object_size", 0.02),
            min_objects_per_image=ckpt_args.get("min_objects_per_image", 3),
            instance_whitelist=ckpt_args.get("instance_whitelist"),
            stuff_whitelist=ckpt_args.get("stuff_whitelist"),
            # upstream reads this one as True for old checkpoints
            # (sample_images.py:91)
            include_other=ckpt_args.get("coco_include_other", True),
            include_relationships=ckpt_args.get("include_relationships",
                                                True),
            decoder=args.decoder,
        )
    from sg2im_tpu_torch.data.vg import VgSceneGraphDataset

    return VgSceneGraphDataset(
        vocab=vocab, h5_path=args.vg_h5, image_dir=args.vg_image_dir,
        image_size=tuple(args.image_size),
        max_objects=ckpt_args.get("max_objects_per_image", 10),
        max_samples=args.num_samples,
        use_orphaned_objects=ckpt_args.get("vg_use_orphaned_objects", True),
        include_relationships=ckpt_args.get("include_relationships", True),
        decoder=args.decoder,
    )


def run_checkpoint(args, checkpoint_path) -> int:
    """Sample one checkpoint into ``args.output_dir``; the number of
    images written."""
    import torch
    from PIL import Image

    from sg2im_tpu_torch.data import round_up
    from sg2im_tpu_torch.data.loader import PaddedLoader
    from sg2im_tpu_torch.data.transforms import (
        imagenet_deprocess_batch,
        imagenet_deprocess_batch_torch,
    )
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.models.sg2im import Sg2ImGenerator
    from sg2im_tpu_torch.ops.prng import prng_key, split
    from sg2im_tpu_torch.ops.prng_kernel import threefry_normal
    from sg2im_tpu_torch.utils.vis import draw_scene_graph, have_graphviz

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA card "
                         "(pass --device cpu to sample on the host)")
    bundle = load_bundle(checkpoint_path)
    vocab = bundle["vocab"]
    ckpt_args = bundle["args"] or {}
    model_kwargs = dict(bundle["model_kwargs"])
    model_kwargs["image_size"] = tuple(args.image_size)
    model = Sg2ImGenerator(vocab, **model_kwargs)
    model.load_state_dict(bundle["generator"], strict=True)
    model = model.to(device)
    train_mode = args.model_mode == "train"
    model.train(train_mode)
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())

    dset = _build_dataset(args, ckpt_args, vocab)
    # Pad targets from the data's caps (collate_padded truncates nothing).
    if args.dataset == "vg":
        max_objs = ckpt_args.get("max_objects_per_image", 10)
        rel_cap = int(dset.data["relationship_subjects"].shape[1])
        o_cap = max_objs + 2  # + __image__, + the sampling quirk
        t_cap = rel_cap + max_objs + 1
    else:
        o_cap = 8 + 1
        t_cap = 8 + 8
    loader = PaddedLoader(dset, batch_size=args.batch_size,
                          O_max=round_up(o_cap, 8), T_max=round_up(t_cap, 8),
                          shuffle=args.shuffle,
                          num_workers=args.loader_num_workers,
                          seed=args.seed, drop_last=False)

    H, W = args.image_size
    noise_dim = model_kwargs.get("layout_noise_dim", 0) or 0
    rng = prng_key(args.seed)

    def on_device(v, dtype):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype)

    img_dir = os.path.join(args.output_dir, "img")
    os.makedirs(img_dir, exist_ok=True)
    if args.save_gt_imgs:
        os.makedirs(os.path.join(args.output_dir, "gt_img"), exist_ok=True)
    if args.save_graphs:
        os.makedirs(os.path.join(args.output_dir, "graphs"), exist_ok=True)
    save_graphs = args.save_graphs and have_graphviz()
    if args.save_graphs and not save_graphs:
        print("WARNING: --save_graphs requested but GraphViz 'dot' is not "
              "installed; skipping scene-graph renders")
    saved = 0
    dump = {"boxes_pred": [], "boxes_gt": [], "objs": [], "obj_mask": [],
            "masks_pred": [], "masks_gt": []}
    for batch in loader:
        if saved >= args.num_samples:
            break
        N = batch["imgs"].shape[0]
        if N < args.batch_size:
            # The last batch padded to the full size (one batch shape for
            # the whole run); pad rows carry zero masks and are dropped.
            pad = args.batch_size - N
            batch = {k: (np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                if v is not None else None) for k, v in batch.items()}
        B = batch["imgs"].shape[0]
        noise = None
        if noise_dim > 0:
            rng, k = split(rng)
            noise = threefry_normal(k, (B, noise_dim, H, W), device=device)
        boxes_gt = (on_device(batch["boxes"], torch.float32)
                    if args.use_gt_boxes else None)
        masks_gt = (on_device(batch["masks"], torch.float32)
                    if args.use_gt_masks and batch.get("masks") is not None
                    else None)
        # Train mode writes the running statistics into the buffers it is
        # given: copies, discarded after the batch.
        bufs = ({k: v.clone() for k, v in buffers.items()} if train_mode
                else buffers)
        with torch.no_grad(), full_fp32():
            imgs, boxes_pred, masks_pred, _ = torch.func.functional_call(
                model, (params, bufs),
                (on_device(batch["objs"], torch.long),
                 on_device(batch["triples"], torch.long),
                 on_device(batch["obj_mask"], torch.float32),
                 on_device(batch["triple_mask"], torch.float32)),
                dict(layout_noise=noise, boxes_gt=boxes_gt,
                     masks_gt=masks_gt))
            imgs_u8 = imagenet_deprocess_batch_torch(
                imgs.permute(0, 2, 3, 1)).cpu().numpy()
        gt_u8 = (imagenet_deprocess_batch(batch["imgs"])
                 if args.save_gt_imgs else None)
        for i in range(N):
            if saved >= args.num_samples:
                break
            Image.fromarray(imgs_u8[i]).save(
                os.path.join(img_dir, f"img{saved:06d}.png"))
            if gt_u8 is not None:
                Image.fromarray(gt_u8[i]).save(os.path.join(
                    args.output_dir, "gt_img", f"img{saved:06d}.png"))
            if save_graphs:
                om = batch["obj_mask"][i].astype(bool)
                tm = batch["triple_mask"][i].astype(bool)
                sg = draw_scene_graph(batch["objs"][i][om],
                                      batch["triples"][i][tm], vocab)
                Image.fromarray(sg).save(os.path.join(
                    args.output_dir, "graphs", f"sg{saved:06d}.png"))
            saved += 1
        dump["boxes_pred"].append(boxes_pred.cpu().numpy()[:N])
        dump["boxes_gt"].append(np.asarray(batch["boxes"])[:N])
        dump["objs"].append(np.asarray(batch["objs"])[:N])
        dump["obj_mask"].append(np.asarray(batch["obj_mask"])[:N])
        if masks_pred is not None:
            dump["masks_pred"].append(masks_pred.cpu().numpy()[:N])
        if batch.get("masks") is not None:
            dump["masks_gt"].append(np.asarray(batch["masks"])[:N])

    # Row i of every array is img%06d.png i: cut to the images saved (the
    # last batch may overshoot num_samples).
    np.savez(os.path.join(args.output_dir, "data.npz"),
             **{k: np.concatenate(v)[:saved]
                for k, v in dump.items() if v})
    print(f"Saved {saved} images to {img_dir}")
    return saved


def main(argv=None):
    from sg2im_tpu_torch.ckpt.store import STATE_FILES

    args = build_parser().parse_args(argv)
    if args.checkpoint_list is None:
        run_checkpoint(args, args.checkpoint)
        return 0
    with open(args.checkpoint_list) as f:
        checkpoints = [ln.strip() for ln in f if ln.strip()]
    base = args.output_dir
    for i, ck in enumerate(checkpoints):
        if os.path.isdir(ck) and not any(
                os.path.exists(os.path.join(ck, name))
                for name in STATE_FILES.values()):
            # A snapshot directory (upstream sample_images.py:268-285):
            # every snapshot_* inside, in name order.
            for fn in sorted(os.listdir(ck)):
                if "snapshot" not in fn:
                    continue
                name = os.path.splitext(fn)[0].split("_")[-1]
                args.output_dir = os.path.join(base, f"result{i:03d}_{name}")
                run_checkpoint(args, os.path.join(ck, fn))
        else:
            args.output_dir = os.path.join(base, f"result{i:03d}")
            run_checkpoint(args, ck)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
