"""Data-parallel dry run: ranks in processes of their own against the
one-process step on the same global batch (counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python -m sg2im_tpu_torch.parallel.dryrun --world 2 --backend gloo \\
        --device cpu|cuda:0|cuda [--config tiny|coco64] [--out result.json]

Each of ``--world`` ranks joins a ``torch.distributed`` group of that size
(``--backend``; Gloo also runs on CUDA tensors, so two ranks can share one
card: ``--device cuda:0``; ``--device cuda`` gives rank r ``cuda:r``),
builds the Trainer, takes one train step on its rows of the global batch,
sweeps ``check_model`` over them, saves a checkpoint (rank 0), restores it
on every rank and takes one more step.  This process then takes the same
two steps without a group on the whole batch, from the same seed and with
the same layout noise, and the run fails unless every rank reports the
same losses and they equal the one-process losses within
``LOSS_RTOL`` / ``LOSS_ATOL``.  Prints one JSON line, the summary.

``--config tiny`` is the JAX dry run's tiny vocabulary and configuration
(``__graft_entry__.py::_dryrun_vocab_config``, copied); ``coco64`` the
COCO-64 flagship at ``TrainConfig``'s widths and b32
(``tools/profile_train.coco64``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5  # tests/test_torch_train_step.py's bars
RANK_TIMEOUT_S = 600.0


def tiny(world: int):
    """The JAX dry run's vocabulary, configuration (2 rows per rank) and
    batch (numpy, NHWC)."""
    from sg2im_tpu_torch.train.config import TrainConfig

    vocab = {
        "object_idx_to_name": ["__image__", "a", "b", "c"],
        "object_name_to_idx": {"__image__": 0, "a": 1, "b": 2, "c": 3},
        "pred_idx_to_name": ["__in_image__", "p1"],
        "pred_name_to_idx": {"__in_image__": 0, "p1": 1},
    }
    config = TrainConfig(
        dataset="coco", batch_size=2 * world, image_size=(16, 16),
        embedding_dim=8, gconv_dim=12, gconv_hidden_dim=16,
        gconv_num_layers=2, refinement_network_dims=(12, 8), mask_size=4,
        layout_noise_dim=4, crop_size=8, d_obj_arch="C3-8-2",
        d_img_arch="C3-8-2", pad_objects_to=4, pad_triples_to=6)
    rng = np.random.RandomState(0)
    N, O, T = config.batch_size, config.pad_objects_to, config.pad_triples_to
    H, W = config.image_size
    lo = rng.uniform(0, 0.5, (N, O, 2)).astype(np.float32)
    batch = {
        "imgs": rng.randn(N, H, W, 3).astype(np.float32),
        "objs": rng.randint(1, 4, (N, O)).astype(np.int32),
        "boxes": np.concatenate([lo, lo + 0.3], -1),
        "triples": np.stack([
            rng.randint(0, O, (N, T)), rng.randint(0, 2, (N, T)),
            rng.randint(0, O, (N, T))], -1).astype(np.int32),
        "obj_mask": np.ones((N, O), np.float32),
        "triple_mask": np.ones((N, T), np.float32),
        "masks": (rng.rand(N, O, 4, 4) > 0.5).astype(np.float32),
    }
    return vocab, config, batch


def coco64(world: int):
    from sg2im_tpu_torch.tools.profile_train import coco64 as flagship

    return flagship()


CONFIGS = {"tiny": tiny, "coco64": coco64}


def launch_counts() -> dict:
    """The kernel wrappers' launch counts in this process (the names of
    chip_smoke.py's kernels line) and the collectives issued."""
    from sg2im_tpu_torch.ops import conv_kernel as ck
    from sg2im_tpu_torch.ops import layout_kernel as lk
    from sg2im_tpu_torch.ops import prng_kernel as pk
    from sg2im_tpu_torch.ops import relayout as rl
    from sg2im_tpu_torch.parallel import collectives

    return {"layout_compose_boxes": lk.layout_compose.launches,
            "layout_compose_boxes_bf16": lk.layout_compose.launches_bf16,
            "layout_compose_weights": lk.layout_compose_weights.launches,
            "conv3x3_bf16": ck.conv3x3.launches,
            "conv3x3_s8": ck.conv3x3_int8.launches,
            "relayout_s2d": rl.space_to_depth.launches,
            "relayout_d2s": rl.depth_to_space.launches,
            "threefry_normal": pk.threefry_normal.launches,
            "collectives": collectives.all_reduce.calls}


def rank_device(device: str, rank: int) -> torch.device:
    """``cuda`` gives rank r its own card; any other device is shared."""
    if device == "cuda":
        return torch.device("cuda", rank)
    return torch.device(device)


def _floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def steps(trainer, batch, work_dir, keep_state=None) -> dict:
    """The dry run's sequence on one rank (or on one process without a
    group): step, check_model, save, restore, step.  ``keep_state``: a
    path to write the state after the first step to (CPU tensors)."""
    from sg2im_tpu_torch.train.state import tensors

    state = trainer.init_state(seed=0)
    state, m1 = trainer.step(state, batch)
    out = {"step1": _floats(m1)}
    if keep_state:
        torch.save({k: v.detach().cpu() for k, v in tensors(state).items()},
                   keep_state)
    val_losses, val_iou = trainer.check_model(state, [batch])
    out["val_losses"], out["val_iou"] = val_losses, float(val_iou)
    path = os.path.join(work_dir, f"ckpt_world{trainer.world}")
    trainer.save_checkpoint(state, path)
    restored, _ = trainer.load_checkpoint(path)
    for k, v in tensors(state).items():
        if not torch.equal(v.cpu(), tensors(restored)[k].cpu()):
            raise AssertionError(f"restored {k} differs from the saved one")
    _, m2 = trainer.step(restored, batch)
    out["step2"] = _floats(m2)
    return out


def _make(config):
    """(vocab, TrainConfig, global batch) of a config name, or of a
    picklable function of the world size that returns them."""
    return CONFIGS[config] if isinstance(config, str) else config


def _rank_main(rank, world, backend, device, port, config, work_dir,
               timeout_s, keep_states):
    """One rank: join the group, run :func:`steps` on this rank's rows,
    write ``rank<r>.json`` into ``work_dir``."""
    import torch.distributed as dist

    from sg2im_tpu_torch.parallel.mesh import init_process_group, shard_batch
    from sg2im_tpu_torch.train.trainer import Trainer

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_process_group(backend, "127.0.0.1", port, rank, world, timeout_s)
    try:
        vocab, cfg, batch = _make(config)(world)
        cfg = dataclasses.replace(cfg, data_parallel=world)
        trainer = Trainer(cfg, vocab, device=dev)
        local = shard_batch(batch, rank, world)
        keep = (os.path.join(work_dir, f"rank{rank}_step1.pt")
                if keep_states else None)
        out = steps(trainer, local, work_dir, keep)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["launches"] = launch_counts()
        with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def close(a: float, b: float) -> bool:
    return abs(a - b) <= LOSS_ATOL + LOSS_RTOL * abs(b)


def run(world: int = 2, backend: str = "gloo", device: str = "cpu",
        config="tiny", timeout_s: float = RANK_TIMEOUT_S,
        work_dir: str | None = None, keep_states: bool = False) -> dict:
    """The dry run (see the module docstring) -> the summary: each rank's
    results, the one-process results, the largest relative loss
    difference and whether the run passed.  Raises on a failed rank.
    ``config``: a name of :data:`CONFIGS`, or a picklable function of the
    world size giving (vocab, TrainConfig, global numpy batch).
    ``work_dir`` (default: a temporary directory) receives the ranks'
    results and, with ``keep_states``, their states after step 1 and the
    one-process state as ``rank<r>_step1.pt`` / ``single_step1.pt``."""
    from sg2im_tpu_torch.parallel.mesh import free_port, spawn_ranks
    from sg2im_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        work = work_dir or tmp
        port = free_port()
        spawn_ranks(_rank_main, lambda r: (
            r, world, backend, device, port, config, work, timeout_s,
            keep_states), world, timeout_s)
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        vocab, cfg, batch = _make(config)(world)
        trainer = Trainer(dataclasses.replace(cfg, data_parallel=1), vocab,
                          device=rank_device(device, 0))
        single = steps(trainer, batch, work,
                       os.path.join(work, "single_step1.pt")
                       if keep_states else None)
    worst, ok = 0.0, True
    for r, res in enumerate(ranks):
        for leg in ("step1", "step2", "val_losses"):
            for k, ref in single[leg].items():
                got = res[leg][k]
                if got != ranks[0][leg][k]:
                    ok = False  # every rank reports the global value
                if not close(got, ref):
                    ok = False
                worst = max(worst, abs(got - ref) / max(abs(ref), 1e-12))
        if not close(res["val_iou"], single["val_iou"]):
            ok = False
    return {"world": world, "backend": backend, "device": device,
            "config": config if isinstance(config, str) else
            getattr(config, "__name__", str(config)), "ok": ok, "max_rel_loss_diff": worst,
            "single": single, "ranks": ranks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    p.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S,
                   help="seconds a rank may take, its group's join included")
    p.add_argument("--out", default=None, help="also write the summary here")
    args = p.parse_args(argv)
    summary = run(args.world, args.backend, args.device, args.config,
                  args.timeout)
    line = json.dumps({k: summary[k] for k in (
        "world", "backend", "device", "config", "ok", "max_rel_loss_diff")}
        | {"total_loss": summary["ranks"][0]["step1"]["total_loss"],
           "single_total_loss": summary["single"]["step1"]["total_loss"]})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    if not summary["ok"]:
        print(f"dryrun FAILED: losses differ beyond {LOSS_RTOL} relative",
              file=sys.stderr)
        return 1
    print(f"dryrun OK: {args.world} ranks on {args.device} ({args.backend}) "
          "equal the one-process step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
