"""Where a train step's time goes on the card: the device-time split of the
port's GAN step at the COCO-64 flagship (b32), per phase and by kernel.

    python -m sg2im_tpu_torch.tools.profile_train [--steps 10] [--out DIR]

For each configuration (f32 'legacy', and bf16 'split', the fast one) it
runs warm-up steps, then:

1. ``--steps`` steps with an event on the stream at each phase boundary
   of the step (``train_step.marker``): G forward (with the losses and the
   discriminators' scoring of the fakes), G backward, G's Adam, and each
   discriminator's forward, backward and Adam; the median device ms of
   each phase.  A phase's span includes any time the card waited for the
   host inside it;
2. three steps under ``torch.profiler``: the kernels' device time and
   count per step, the idle share of the step's span, and the ten kernels
   that took longest.

Prints one JSON object per configuration and writes them all to
``<out>/profile_train.json`` (``--out``, default the working directory).
The step time and img/s are chip_smoke.py's (events around each whole
step, no marks): this tool reports only where the time goes.
Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from sg2im_tpu_torch.tools._measure import kernel_table

CONFIGS = {"f32/legacy": {},
           "bf16/split": dict(bf16_compute=True, crn_mode="split")}
PHASE_GROUPS = {"G forward": ("g_forward",),
                "G backward": ("g_backward",),
                "D steps": ("d_obj_forward", "d_obj_backward",
                            "d_img_forward", "d_img_backward"),
                "optimizers": ("g_optimizer", "d_obj_optimizer",
                               "d_img_optimizer")}


def coco64(batch: int = 32, **kw):
    """bench.py:155-184: vocab, TrainConfig and the batch (numpy, NHWC) of
    ``batch`` rows."""
    from sg2im_tpu_torch.train.config import TrainConfig

    vocab = {"object_idx_to_name": [f"o{i}" for i in range(179)],
             "pred_idx_to_name": [f"p{i}" for i in range(7)]}
    cfg = TrainConfig(dataset="coco", batch_size=batch, image_size=(64, 64),
                      pad_objects_to=16, pad_triples_to=24, **kw)
    rng = np.random.RandomState(0)
    N, O, T = batch, 16, 24
    lo = rng.uniform(0, 0.5, (N, O, 2)).astype(np.float32)
    batch = {
        "imgs": rng.randn(N, 64, 64, 3).astype(np.float32),
        "objs": rng.randint(1, 179, (N, O)).astype(np.int32),
        "boxes": np.concatenate([lo, lo + 0.3], -1),
        "triples": np.stack([rng.randint(0, 9, (N, T)),
                             rng.randint(0, 7, (N, T)),
                             rng.randint(0, 9, (N, T))], -1).astype(np.int32),
        "obj_mask": np.concatenate([np.ones((N, 9), np.float32),
                                    np.zeros((N, 7), np.float32)], 1),
        "triple_mask": np.ones((N, T), np.float32),
        "masks": (rng.rand(N, O, 16, 16) > 0.5).astype(np.float32),
    }
    return vocab, cfg, batch


def phase_times(trainer, state, batch, steps):
    """Median device ms per phase over ``steps`` marked steps."""
    marks = []

    def marker(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[-1].append((name, e))

    trainer.train_step.marker = marker
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks.append([("start", start)])
        state, _ = trainer.step(state, batch)
    trainer.train_step.marker = None
    torch.cuda.synchronize()
    per = {}
    for step in marks:
        for (_, a), (name, b) in zip(step, step[1:]):
            per.setdefault(name, []).append(a.elapsed_time(b))
    return state, {k: float(np.median(v)) for k, v in per.items()}


def kernel_profile(trainer, state, batch, steps=3):
    """(kernel device ms per step, kernels per step, idle share of the
    steps' span, top ten kernels by device ms per step)."""
    box = [state]

    def step():
        box[0], _ = trainer.step(box[0], batch)

    t = kernel_table(step, "cuda", iters=steps)
    return (t["device_ms"], t["kernels"], t["idle"],
            [(k["name"], k["ms"]) for k in t["top"]])


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--out", default=".")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    from sg2im_tpu_torch.train.trainer import Trainer

    card = card_name()
    print(card)
    results = []
    for name, extra in CONFIGS.items():
        vocab, cfg, batch_np = coco64(**extra)
        tr = Trainer(cfg, vocab, device="cuda")
        batch = tr.to_device(batch_np)
        state = tr.init_state(seed=0)
        for _ in range(args.warmup):
            state, _ = tr.step(state, batch)
        state, phases = phase_times(tr, state, batch, args.steps)
        busy, count, idle, top = kernel_profile(tr, state, batch)
        groups = {g: sum(phases.get(k, 0.0) for k in keys)
                  for g, keys in PHASE_GROUPS.items()}
        N = batch["imgs"].shape[0]
        res = {"config": name, "card": card, "batch": N,
               "phase_ms": groups, "phases_ms": phases,
               "kernel_ms_per_step": busy, "kernels_per_step": count,
               "idle_share": idle,
               "top_kernels_ms": top}
        print(json.dumps(res))
        results.append(res)
        del tr, state, batch
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_train.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
