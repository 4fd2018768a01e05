"""train CLI of the port — flag-compatible with the JAX package's
``sg2im_tpu/cli/train.py`` and with upstream ``scripts/train.py``.

Example (COCO 64x64 default config, on the card):
    python -m sg2im_tpu_torch.cli.train --dataset coco --batch_size 32

Every flag of the JAX CLI, with its name and default, plus ``--device``
(default ``cuda``; ``--device cpu`` runs on the host) and
``--dist_backend``.  The JAX CLI's compile cache has no counterpart
(nothing is compiled but the kernels, which build once into ``build/``).

Data parallelism (``parallel/mesh.py``), with ``--batch_size`` the GLOBAL
batch and each rank loading its own ``batch_size / N`` rows
(``PaddedLoader(shard=(rank, N))``); the step computes the one-process
step on the global batch (``train/step.py``):

- ``--data_parallel N``: this command starts the N ranks itself, one
  process per card (``cuda:0`` .. ``cuda:N-1``), and waits for them;
- ``--multihost true``: this process is one rank of a group launched
  outside, by torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) or by the JAX package's variables
  (``SG2IM_COORDINATOR``, ``SG2IM_NUM_PROCESSES``, ``SG2IM_PROCESS_ID``);
  its card is ``cuda:LOCAL_RANK``:

      torchrun --nproc_per_node 4 -m sg2im_tpu_torch.cli.train \
          --multihost true --batch_size 128 ...

``--dist_backend`` is NCCL for CUDA and Gloo for the CPU unless given;
nothing switches backend when one fails.  Rank 0 alone prints, writes
``log.jsonl``, checkpoints and snapshots; every rank restores.

A run is deterministic: cuDNN's and PyTorch's deterministic algorithms
are on for its duration, so a run resumed from a checkpoint takes the same
steps as one that was never stopped (the loader, too, starts at the
resumed step's epoch and batch).  With ``--timing`` every step is fenced
and timed, each print adds the per-section breakdown, and ``log.jsonl``
gets a ``timing`` record per step: the step's ms, the ms the loop waited
on the loader's queue before it, and the ms since the previous step's
record (the loop's period, prints and checkpoints included).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from collections import defaultdict

import torch

from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.utils.flags import bool_flag, int_tuple, str_tuple

SAMPLE_KINDS = ("train_samples", "train_batch_data", "val_samples",
                "val_batch_data")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    d = TrainConfig()
    p.add_argument("--dataset", default=d.dataset, choices=["vg", "coco"])
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--num_iterations", default=d.num_iterations, type=int)
    p.add_argument("--learning_rate", default=d.learning_rate, type=float)
    p.add_argument("--eval_mode_after", default=d.eval_mode_after, type=int)
    p.add_argument("--image_size", default="64,64", type=int_tuple)
    p.add_argument("--num_train_samples", default=None, type=int)
    p.add_argument("--num_val_samples", default=d.num_val_samples, type=int)
    p.add_argument("--shuffle_val", default=True, type=bool_flag)
    p.add_argument("--loader_num_workers", default=4, type=int)
    p.add_argument("--cache_dir", default=None,
                   help="directory for the decoded-sample memmap cache "
                        "(data/cache.py): built on first run, then every "
                        "sample read skips JPEG/RLE decode entirely")
    p.add_argument("--include_relationships", default=True, type=bool_flag)
    p.add_argument("--decoder", default="auto",
                   choices=["auto", "pil", "native", "native_fast"],
                   help="image decode backend (data/decode.py): 'native' "
                        "is the C++ libjpeg/libpng + bit-exact-PIL-resize "
                        "path, 'native_fast' adds JPEG DCT prescaling "
                        "(visually identical, not bit-equal), 'auto' = "
                        "native when it builds and passes its bit-parity "
                        "self-check, else pil; the run prints which")
    # VG
    p.add_argument("--vg_image_dir", default=d.vg_image_dir)
    p.add_argument("--train_h5", default=d.train_h5)
    p.add_argument("--val_h5", default=d.val_h5)
    p.add_argument("--vocab_json", default=d.vocab_json)
    p.add_argument("--max_objects_per_image", default=10, type=int)
    p.add_argument("--vg_use_orphaned_objects", default=True, type=bool_flag)
    # COCO
    p.add_argument("--coco_train_image_dir", default=d.coco_train_image_dir)
    p.add_argument("--coco_val_image_dir", default=d.coco_val_image_dir)
    p.add_argument("--coco_train_instances_json",
                   default=d.coco_train_instances_json)
    p.add_argument("--coco_train_stuff_json", default=d.coco_train_stuff_json)
    p.add_argument("--coco_val_instances_json",
                   default=d.coco_val_instances_json)
    p.add_argument("--coco_val_stuff_json", default=d.coco_val_stuff_json)
    p.add_argument("--instance_whitelist", default=None, type=str_tuple)
    p.add_argument("--stuff_whitelist", default=None, type=str_tuple)
    p.add_argument("--coco_include_other", default=False, type=bool_flag)
    p.add_argument("--min_object_size", default=0.02, type=float)
    p.add_argument("--min_objects_per_image", default=3, type=int)
    p.add_argument("--coco_stuff_only", default=True, type=bool_flag)
    # Generator
    p.add_argument("--mask_size", default=16, type=int)
    p.add_argument("--embedding_dim", default=128, type=int)
    p.add_argument("--gconv_dim", default=128, type=int)
    p.add_argument("--gconv_hidden_dim", default=512, type=int)
    p.add_argument("--gconv_num_layers", default=5, type=int)
    p.add_argument("--mlp_normalization", default="none")
    p.add_argument("--refinement_network_dims", default="1024,512,256,128,64",
                   type=int_tuple)
    p.add_argument("--normalization", default="batch")
    p.add_argument("--activation", default="leakyrelu-0.2")
    p.add_argument("--layout_noise_dim", default=32, type=int)
    p.add_argument("--use_boxes_pred_after", default=-1, type=int)
    # Losses
    p.add_argument("--mask_loss_weight", default=0.0, type=float)
    p.add_argument("--l1_pixel_loss_weight", default=1.0, type=float)
    p.add_argument("--bbox_pred_loss_weight", default=10.0, type=float)
    p.add_argument("--predicate_pred_loss_weight", default=0.0, type=float)
    # Discriminators
    p.add_argument("--discriminator_loss_weight", default=0.01, type=float)
    p.add_argument("--gan_loss_type", default="gan")
    p.add_argument("--d_clip", default=None, type=float,
                   help="WGAN weight clip bound applied to both D param "
                        "sets after each update (upstream parses but never "
                        "applies this flag; the JAX package and the port "
                        "apply it)")
    p.add_argument("--d_normalization", default="batch")
    p.add_argument("--d_padding", default="valid")
    p.add_argument("--d_activation", default="leakyrelu-0.2")
    p.add_argument("--d_obj_arch", default="C4-64-2,C4-128-2,C4-256-2")
    p.add_argument("--crop_size", default=32, type=int)
    p.add_argument("--d_obj_weight", default=1.0, type=float)
    p.add_argument("--ac_loss_weight", default=0.1, type=float)
    p.add_argument("--d_img_arch", default="C4-64-2,C4-128-2,C4-256-2")
    p.add_argument("--d_img_weight", default=1.0, type=float)
    # Output
    p.add_argument("--print_every", default=10, type=int)
    p.add_argument("--timing", default=False, type=bool_flag)
    p.add_argument("--checkpoint_every", default=10000, type=int)
    p.add_argument("--snapshot_every", default=-1, type=int,
                   help="also emit reference-layout snapshot_%%05dK.pt "
                        "generator checkpoints every N iterations")
    p.add_argument("--output_dir", default=os.getcwd())
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--checkpoint_start_from", default=None)
    p.add_argument("--restore_from_checkpoint", default=False, type=bool_flag)
    # Additions of the JAX package
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--data_parallel", default=1, type=int,
                   help="ranks of a data-parallel run this command starts, "
                        "one process per card (batch_size is the GLOBAL "
                        "batch)")
    p.add_argument("--multihost", default=False, type=bool_flag,
                   help="join a data-parallel group launched outside "
                        "(torchrun, or SG2IM_COORDINATOR / "
                        "SG2IM_NUM_PROCESSES / SG2IM_PROCESS_ID); each "
                        "rank loads a disjoint shard (batch_size is the "
                        "GLOBAL batch)")
    p.add_argument("--pad_objects_to", default=None, type=int)
    p.add_argument("--pad_triples_to", default=None, type=int)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "training loop to <dir>/trace.json")
    p.add_argument("--bf16_compute", default=False, type=bool_flag,
                   help="bf16 CRN convs + bf16 inter-conv activation chain "
                        "(train-mode BN stats stay f32)")
    p.add_argument("--crn_mode", default=None,
                   choices=["legacy", "split"],
                   help="CRN stage-conv formulation; 'split' avoids "
                        "materializing the per-stage concat (the fast "
                        "training mode, with --bf16_compute); 'legacy' "
                        "(default) keeps the reference-shaped composition")
    p.add_argument("--async_checkpoint", default=False, type=bool_flag,
                   help="overlap checkpoint disk writes with training: the "
                        "state is copied to host memory before the step "
                        "loop continues and the files are written in the "
                        "background (joined before any later save or load "
                        "and at exit)")
    p.add_argument("--tensorboard_dir", default=None,
                   help="also mirror the scalar stream as TensorBoard "
                        "events (train/* and eval/* tags)")
    p.add_argument("--log_jsonl", default=True, type=bool_flag,
                   help="append scalar records to <output_dir>/log.jsonl "
                        "(one JSON object per print/eval event)")
    # The port's own
    p.add_argument("--device", default="cuda",
                   help="torch device of the Trainer ('cuda' fails without "
                        "a card rather than running on the CPU); a data-"
                        "parallel rank on a card uses its own, cuda:<rank "
                        "on its host>")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of --data_parallel / "
                        "--multihost runs; default nccl on CUDA, gloo on "
                        "the CPU")
    return p


def make_scalar_logger(config: TrainConfig, process_index: int = 0):
    """Append-mode JSONL scalar stream (``<output_dir>/log.jsonl``) and
    optional TensorBoard event mirror (``--tensorboard_dir``), one record
    per print / eval / timing event; ``t`` identifies the step, so a
    resumed run continues the same stream.  A no-op on every rank but 0
    (the metrics are already global)."""
    if process_index != 0 or not (config.log_jsonl
                                  or config.tensorboard_dir):
        return lambda record: None
    path = os.path.join(config.output_dir, "log.jsonl")
    tb = None
    if config.tensorboard_dir:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(config.tensorboard_dir)
        except Exception as e:  # noqa: BLE001 — an optional sink
            print(f"WARNING: --tensorboard_dir disabled ({e!r})")

    def write(record):
        if config.log_jsonl:
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if tb is not None:
            kind, t = record.get("kind", "train"), record.get("t", 0)
            for k, v in record.items():
                if k in ("kind", "t"):
                    continue
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    tb.add_scalar(f"{kind}/{k}", v, global_step=int(t))
            tb.flush()

    return write


def config_from_args(args) -> TrainConfig:
    from sg2im_tpu_torch.data import round_up

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields and v is not None}
    cfg = TrainConfig(**kw)
    # Static pad targets from the dataset caps (each flag independently;
    # explicit values are kept).
    if cfg.dataset == "coco":
        o_cap = 8 + 1  # max_objects_per_image + __image__
        t_cap = 8 + 8  # one heuristic triple per object + __in_image__
    else:
        o_cap = cfg.max_objects_per_image + 1  # (+1 quirk-safe below)
        t_cap = 30 + cfg.max_objects_per_image + 1
    if args.pad_objects_to is None:
        cfg = dataclasses.replace(cfg, pad_objects_to=round_up(o_cap + 1, 8))
    if args.pad_triples_to is None:
        cfg = dataclasses.replace(cfg, pad_triples_to=round_up(t_cap, 8))
    return cfg


def check_args(config: TrainConfig):
    H, _ = config.image_size
    for _ in config.refinement_network_dims[1:]:
        H = H // 2
    if H == 0:
        raise ValueError("Too many layers in refinement network")


def build_datasets(config: TrainConfig):
    """-> (vocab, train dataset, val dataset)."""
    def cache_sub(split):
        if not config.cache_dir:
            return None
        return os.path.join(config.cache_dir, f"{config.dataset}_{split}")

    if config.dataset == "coco":
        from sg2im_tpu_torch.data.coco import CocoSceneGraphDataset

        common = dict(
            stuff_only=config.coco_stuff_only,
            image_size=config.image_size,
            mask_size=config.mask_size,
            min_object_size=config.min_object_size,
            min_objects_per_image=config.min_objects_per_image,
            instance_whitelist=config.instance_whitelist,
            stuff_whitelist=config.stuff_whitelist,
            include_other=config.coco_include_other,
            include_relationships=config.include_relationships,
            seed=config.seed,  # reproducible for any loader_num_workers
            decoder=config.decoder,
        )
        train = CocoSceneGraphDataset(
            image_dir=config.coco_train_image_dir,
            instances_json=config.coco_train_instances_json,
            stuff_json=config.coco_train_stuff_json,
            max_samples=config.num_train_samples,
            cache_dir=cache_sub("train"), **common)
        val = CocoSceneGraphDataset(
            image_dir=config.coco_val_image_dir,
            instances_json=config.coco_val_instances_json,
            stuff_json=config.coco_val_stuff_json,
            max_samples=config.num_val_samples,
            cache_dir=cache_sub("val"), **common)
        if train.vocab != val.vocab:
            raise ValueError("the COCO train and val annotations give "
                             "different vocabularies")
        return train.vocab, train, val
    from sg2im_tpu_torch.data.vg import VgSceneGraphDataset

    with open(config.vocab_json) as f:
        vocab = json.load(f)
    common = dict(
        vocab=vocab, image_dir=config.vg_image_dir,
        image_size=config.image_size,
        max_objects=config.max_objects_per_image,
        use_orphaned_objects=config.vg_use_orphaned_objects,
        include_relationships=config.include_relationships,
        seed=config.seed,
        decoder=config.decoder)
    train = VgSceneGraphDataset(h5_path=config.train_h5,
                                max_samples=config.num_train_samples,
                                cache_dir=cache_sub("train"), **common)
    # Upstream uses the whole val split (build_vg_dsets deletes
    # max_samples, train.py:281); check_model caps the sweep instead.
    val = VgSceneGraphDataset(h5_path=config.val_h5,
                              cache_dir=cache_sub("val"), **common)
    return vocab, train, val


@contextlib.contextmanager
def deterministic():
    """cuDNN's and PyTorch's deterministic algorithms for the block (ops
    without one warn), restored after it.  Uninitialised memory is left
    unfilled: filling it would add a kernel per allocation."""
    import torch.utils.deterministic as det

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    # cuBLAS's fixed workspace, which its determinism needs; read when a
    # process makes its first handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        det.fill_uninitialized_memory = saved[4]


def flatten_samples(sample_history: dict) -> dict:
    """The per-eval triptychs and batch data ({kind: [{key: array}]}) as
    one flat dict of arrays, ``<kind>/<eval index>/<key>``, for the
    checkpoint's ``history.npz``."""
    return {f"{kind}/{i}/{key}": arr
            for kind, evals in sample_history.items()
            for i, rec in enumerate(evals) for key, arr in rec.items()}


def unflatten_samples(arrays: dict) -> dict:
    """Inverse of :func:`flatten_samples`."""
    out = {kind: [] for kind in SAMPLE_KINDS}
    for name in sorted(arrays, key=lambda n: (n.split("/")[0],
                                              int(n.split("/")[1]))):
        kind, i, key = name.split("/", 2)
        if kind not in out:
            continue
        while len(out[kind]) <= int(i):
            out[kind].append({})
        out[kind][int(i)][key] = arrays[name]
    return out


def _warm_config(config: TrainConfig, mk: dict) -> TrainConfig:
    """The generator-shaping fields from a checkpoint's own kwargs, not
    the flags (upstream ``build_model``, train.py:161-171)."""
    return dataclasses.replace(
        config,
        image_size=tuple(mk.get("image_size", config.image_size)),
        embedding_dim=mk.get("embedding_dim", config.embedding_dim),
        gconv_dim=mk.get("gconv_dim", config.gconv_dim),
        gconv_hidden_dim=mk.get("gconv_hidden_dim", config.gconv_hidden_dim),
        gconv_num_layers=mk.get("gconv_num_layers", config.gconv_num_layers),
        mlp_normalization=mk.get("mlp_normalization",
                                 config.mlp_normalization),
        refinement_network_dims=tuple(mk.get(
            "refinement_dims", config.refinement_network_dims)),
        normalization=mk.get("normalization", config.normalization),
        activation=mk.get("activation", config.activation),
        mask_size=mk.get("mask_size") or 0,
        layout_noise_dim=mk.get("layout_noise_dim", config.layout_noise_dim),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    check_args(config)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA card "
                         "(pass --device cpu to train on the host)")
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if args.multihost:
        if args.data_parallel > 1:
            raise SystemExit("--multihost joins a group launched outside; "
                             "--data_parallel N starts one: give one")
        return _multihost(args, config, device, backend)
    if args.data_parallel > 1:
        return _launch_ranks(args, argv, config, device, backend)
    with deterministic():
        return _train(args, config, device)


def _rank_device(device, local_rank: int):
    """A rank's card: ``cuda`` (no index) becomes cuda:<local rank>."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _check_divides(config: TrainConfig, world: int):
    if config.batch_size % world:
        raise SystemExit(f"--batch_size {config.batch_size} (global) must "
                         f"divide by the {world} ranks")


def _multihost(args, config, device, backend) -> int:
    """One rank of a group launched outside (torchrun or SG2IM_*)."""
    import torch.distributed as dist

    from sg2im_tpu_torch.parallel.mesh import init_multihost, local_rank

    rank, world = init_multihost(backend)
    _check_divides(config, world)
    device = _rank_device(device, local_rank())
    print(f"multihost: rank {rank}/{world} on {device} ({backend})"
          if dist.is_initialized() else f"multihost: one process on "
          f"{device}")
    config = dataclasses.replace(config, data_parallel=world)
    try:
        with deterministic():
            return _train(args, config, device, rank, world)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _launch_ranks(args, argv, config, device, backend) -> int:
    """--data_parallel N: N spawned ranks, one card each, on this host."""
    from sg2im_tpu_torch.parallel.mesh import free_port, spawn_ranks

    n = args.data_parallel
    _check_divides(config, n)
    if device.type == "cuda":
        if device.index is not None:
            raise SystemExit("--data_parallel gives rank r the card cuda:r; "
                             "pass --device cuda, not one card")
        have = torch.cuda.device_count()
        if n > have:
            raise SystemExit(f"--data_parallel {n} exceeds the {have} "
                             f"available CUDA device(s)")
    port = free_port()
    argv = list(argv) if argv is not None else sys.argv[1:]
    spawn_ranks(_rank_entry, lambda r: (r, n, port, backend, argv), n,
                timeout_s=None)
    return 0


def _rank_entry(rank, world, port, backend, argv):
    """A rank started by --data_parallel: join the group, train, exit with
    the run's code."""
    import torch.distributed as dist

    from sg2im_tpu_torch.parallel.mesh import init_process_group

    args = build_parser().parse_args(argv)
    config = dataclasses.replace(config_from_args(args),
                                 data_parallel=world)
    device = _rank_device(torch.device(args.device), rank)
    init_process_group(backend, "127.0.0.1", port, rank, world)
    try:
        with deterministic():
            rc = _train(args, config, device, rank, world)
    finally:
        dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def _train(args, config: TrainConfig, device, rank: int = 0,
           world: int = 1) -> int:
    from sg2im_tpu_torch.ckpt import (
        export_reference_checkpoint,
        load_reference_bundle,
    )
    from sg2im_tpu_torch.ckpt.store import wait_pending
    from sg2im_tpu_torch.data import round_up
    from sg2im_tpu_torch.data.decode import resolve_decoder
    from sg2im_tpu_torch.data.loader import PaddedLoader, prefetch_to_device
    from sg2im_tpu_torch.train.trainer import Trainer
    from sg2im_tpu_torch.utils.timing import profile_trace, timeit

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    warm = None
    if config.checkpoint_start_from:
        warm = load_reference_bundle(config.checkpoint_start_from)
        config = _warm_config(config, warm["model_kwargs"])

    vocab, train_ds, val_ds = build_datasets(config)
    say(f"Image decoder: {resolve_decoder(config.decoder)} "
          f"(--decoder {config.decoder})")
    if warm is not None:
        if (len(warm["vocab"]["object_idx_to_name"])
                != len(vocab["object_idx_to_name"])):
            say("WARNING: checkpoint vocab size differs from dataset "
                  "vocab; using the checkpoint's (weights define it)")
        vocab = warm["vocab"]
    if args.pad_triples_to is None and config.dataset == "vg":
        # The true relationship cap from the h5, not preprocess's default
        # of 30 (silent triple truncation would impoverish graphs).
        rel_cap = int(train_ds.data["relationship_subjects"].shape[1])
        config = dataclasses.replace(config, pad_triples_to=round_up(
            rel_cap + config.max_objects_per_image + 1, 8))
    say(f"Training dataset has {len(train_ds)} images")
    # Each rank loads its own batch_size / world rows of every global
    # batch, from its own slice of every epoch's permutation.
    loader_kw = dict(batch_size=config.batch_size // world,
                     O_max=config.pad_objects_to,
                     T_max=config.pad_triples_to,
                     num_workers=config.loader_num_workers,
                     seed=config.seed,
                     shard=(rank, world) if world > 1 else None)
    train_loader = PaddedLoader(train_ds, shuffle=True, **loader_kw)
    # The train-set check sweeps a loader of its own: a sweep of the
    # training loader would advance its epoch, and a resumed run could not
    # find its place.
    check_loader = PaddedLoader(train_ds, shuffle=True, **loader_kw)
    val_loader = PaddedLoader(val_ds, shuffle=config.shuffle_val, **loader_kw)

    trainer = Trainer(config, vocab, device=device)
    state = trainer.init_state(seed=config.seed)
    if warm is not None:
        repl = {"g": warm["generator"]}
        for name in ("d_obj", "d_img"):
            if warm[name] is not None and getattr(state, name) is not None:
                repl[name] = warm[name]
        for name, sd in repl.items():
            have = getattr(state, name)
            if set(sd) != set(have):
                raise SystemExit(
                    f"{config.checkpoint_start_from}: {name} state names "
                    f"differ from the model's: "
                    f"{sorted(set(sd) ^ set(have))[:8]}")
            repl[name] = {k: sd[k].to(device=device, dtype=have[k].dtype)
                          for k in have}
        state = state.replace(**repl)
        say(f"Warm-started from {config.checkpoint_start_from} "
              f"({sorted(repl)})")

    history = {"losses": defaultdict(list), "losses_ts": [],
               "checkpoint_ts": [], "train_iou": [], "val_iou": [],
               "val_losses": defaultdict(list)}
    # Per-eval triptychs + batch tensors, kept like the reference
    # checkpoint dict (train.py:611-661), in the checkpoint's history.npz.
    sample_history = {kind: [] for kind in SAMPLE_KINDS}
    os.makedirs(config.output_dir, exist_ok=True)
    log_scalars = make_scalar_logger(config, rank)
    ckpt_path = os.path.join(config.output_dir,
                             f"{config.checkpoint_name}_state")
    if config.restore_from_checkpoint and os.path.exists(ckpt_path):
        state, meta = trainer.load_checkpoint(ckpt_path)
        say(f"Restored checkpoint at t={int(state.step)}")
        for k, v in (meta.get("extra") or {}).items():
            if k in history:
                history[k] = defaultdict(list, v) if isinstance(v, dict) \
                    else v
        sample_history = unflatten_samples(meta.get("arrays") or {})

    t = int(state.step)
    train_loader.start_at(t)
    switched = 0 <= config.eval_mode_after < t
    last_end, waited = time.perf_counter(), 0.0
    with profile_trace(args.profile_dir, device):
        while t < config.num_iterations:
            host_batches = iter(train_loader)
            batches = prefetch_to_device(host_batches, device=device)
            try:
                for batch in batches:
                    if t >= config.num_iterations:
                        break
                    if (not switched and config.eval_mode_after >= 0
                            and t >= config.eval_mode_after):
                        say("switching to eval mode")
                        state = trainer.reset_g_optimizer(state)
                        switched = True
                    with torch.profiler.record_function("train_step"), \
                            timeit("step", config.timing) as tbox:
                        state, metrics = trainer.step(state, batch)
                    t += 1
                    if config.timing:
                        now = time.perf_counter()
                        log_scalars({
                            "kind": "timing", "t": t,
                            "step_ms": tbox["ms"],
                            "loader_wait_ms": 1e3 * (
                                train_loader.wait_seconds - waited),
                            "iter_ms": 1e3 * (now - last_end)})
                        last_end, waited = now, train_loader.wait_seconds

                    if t % config.print_every == 0:
                        say(f"t = {t} / {config.num_iterations}")
                        if config.timing:
                            for name, ms in trainer.step_breakdown(
                                    state, batch).items():
                                say(f"  {name}: {ms:.2f}ms")
                        scalars = {}
                        for name, val in sorted(metrics.items()):
                            v = float(val)
                            say(f"  [{name}]: {v:.4f}")
                            history["losses"][name].append(v)
                            scalars[name] = v
                        history["losses_ts"].append(t)
                        log_scalars({"kind": "train", "t": t, **scalars})

                    if t % config.checkpoint_every == 0:
                        _checkpoint(trainer, state, t, config, check_loader,
                                    val_loader, history, sample_history,
                                    log_scalars, ckpt_path, say)

                    if (config.snapshot_every > 0
                            and t % config.snapshot_every == 0
                            and rank == 0):
                        # One naming scheme per run, so that sorted names
                        # are chronological: K names when every snapshot
                        # lands on the 1K grid, exact iterations otherwise.
                        tag = (f"{t // 1000:05d}K"
                               if config.snapshot_every % 1000 == 0
                               else f"{t:07d}")
                        snap = os.path.join(config.output_dir,
                                            f"snapshot_{tag}.pt")
                        export_reference_checkpoint(
                            snap, state.g, config.generator_kwargs(), vocab,
                            args=dataclasses.asdict(config))
                        say("Saved snapshot to", snap)
            finally:
                batches.close()
                host_batches.close()
    wait_pending()  # --async_checkpoint: never exit mid-write
    return 0


def _checkpoint(trainer, state, t, config, check_loader, val_loader,
                history, sample_history, log_scalars, ckpt_path, say):
    """The train and val sweeps with their triptychs, then the save (every
    rank sweeps its rows; rank 0 writes)."""
    say("checking on train")
    _, t_samples, t_bd, t_iou = trainer.check_model(
        state, iter(check_loader), num_samples=config.num_val_samples,
        return_samples=True)
    say("train iou:", t_iou)
    history["train_iou"].append(t_iou)
    sample_history["train_samples"].append(t_samples)
    sample_history["train_batch_data"].append(t_bd)
    say("checking on val")
    val_losses, v_samples, v_bd, val_iou = trainer.check_model(
        state, iter(val_loader), num_samples=config.num_val_samples,
        return_samples=True)
    say("val iou:", val_iou)
    history["checkpoint_ts"].append(t)
    history["val_iou"].append(val_iou)
    sample_history["val_samples"].append(v_samples)
    sample_history["val_batch_data"].append(v_bd)
    for k, v in val_losses.items():
        history["val_losses"][k].append(v)
    log_scalars({"kind": "eval", "t": t, "train_iou": float(t_iou),
                 "val_iou": float(val_iou),
                 **{f"val_{k}": float(v) for k, v in val_losses.items()}})
    trainer.save_checkpoint(
        state, ckpt_path,
        extra={k: (dict(v) if isinstance(v, defaultdict) else v)
               for k, v in history.items()},
        arrays=flatten_samples(sample_history),
        wait=not config.async_checkpoint)
    say("Saved checkpoint to", ckpt_path)


if __name__ == "__main__":
    raise SystemExit(main())
