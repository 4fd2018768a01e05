"""Trained-weights fidelity loop of the port: train -> native checkpoint
-> reference-layout ``.pt`` -> the PSNR gate on weights the port learned.

Port of ``scripts/trained_fidelity.py``.  Trains a small generator on
``tools.train_proof``'s disk dataset (category -> colour) through
``sg2im_tpu_torch.cli.train``, exports it with ``cli.checkpoint_tools
export``, renders golden PNGs of :func:`make_scene_graphs` with the
port's float32 engine on the CPU, and runs ``cli.verify_pretrained`` on
``--device`` against them: the gate is u8 PSNR >= ``--min_psnr`` (40 dB).
The JAX script's gate ran the upstream torch model in-process
(``--run_reference``); that model is not part of this repo, so the
goldens come from the port's CPU engine instead, and the test suite has
the JAX package score the port-trained ``.pt``
(``tests/test_torch_proofs.py``).

    python -m sg2im_tpu_torch.tools.trained_fidelity [--iters 3000]
        [--images 1024] [--out DIR] [--skip_train] [--device cpu]

Everything it writes goes under ``--out``: the dataset, the run
(``<out>/run``), ``trained_coco64.pt``, ``trained_scene_graphs.json``,
``golden/``, ``gate_out/`` and ``TRAINED_FIDELITY.md``.  The last line is
a JSON object with the gate's dB; exit code 1 if the gate fails or the box
head is dead.

The box head must be alive.  The generator's MLPs end in upstream's final
ReLU (``build_mlp``'s ``final_nonlinearity``), so a box output that the
init leaves at 0 for every object passes no gradient and never recovers,
and a box needs all four: the gate would score a generator whose boxes
are degenerate.  Two checks, each failing the run whatever the gate's
PSNR, with the cause in the message and in the report: before training,
:func:`box_head_probe` runs the freshly built generator on the first
training batch, and the head is dead when one of its four outputs is 0
for every real object (every output 0 is the case of seed 0 at the tool's
defaults; on some batches one output of seed 0 wakes for a few objects,
and the other three stay 0); after the final check_model, a box IoU of 0
on both splits is.  The report carries each output's share of non-zero
objects at init and the final IoU.

Seed contract: the port's weight init is torch's own
(``Trainer.init_state`` draws the weights from a CPU ``torch.Generator``,
so a seed gives the same weights on either device); the JAX package's
flax init streams are not reproduced, its layout noise is (threefry).  At
these widths seed 0 of the port's init leaves the box outputs at 0 under
the final ReLU, so the tool trains at ``SEED``, the smallest seed >= 0
whose init the probe shows alive, and whose CPU tiny run (``--images 48
--iters 20 --batch_size 8``) ends with a box IoU above 0.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

from sg2im_tpu_torch.tools.train_proof import (
    build_dataset,
    card_name,
    dataset_flags,
    run_cli,
)

# Small but real generator: every flag is an upstream ``scripts/train.py``
# flag (the JAX script's MODEL_FLAGS).
MODEL_FLAGS = [
    "--embedding_dim", "64",
    "--gconv_dim", "64",
    "--gconv_hidden_dim", "256",
    "--gconv_num_layers", "3",
    "--refinement_network_dims", "256,128,64",
    "--mask_size", "16",
    "--mask_loss_weight", "0.1",
]
# The smallest seed >= 0 whose init leaves the box head alive at
# MODEL_FLAGS (see the module docstring); seed 0's is dead.
SEED = 1


def make_scene_graphs(seed: int = 7, n_graphs: int = 8):
    """Deterministic gate scene graphs over the trained vocabulary
    (thing1..thing6 and ground): 2-5 things and the ground, geometric
    predicates, like the training distribution; the graphs of the JAX
    script and of ``artifacts/trained_scene_graphs.json``."""
    rng = np.random.RandomState(seed)
    things = [f"thing{i}" for i in range(1, 7)]
    preds = ["left of", "right of", "above", "below"]
    graphs = []
    for _ in range(n_graphs):
        objs = [things[i] for i in
                rng.choice(6, size=rng.randint(2, 6), replace=False)]
        objs.append("ground")
        rels = []
        for i in range(len(objs) - 1):
            j = int(rng.randint(0, len(objs) - 1))
            if j == i:
                continue
            rels.append([i, preds[int(rng.randint(len(preds)))], j])
        # Every thing stands above the ground plane.
        rels.append([0, "above", len(objs) - 1])
        graphs.append({"objects": objs, "relationships": rels})
    return graphs


def train_flags(paths, iters: int, batch: int, workers: int, seed: int,
                device: str):
    """The train CLI's flags of the run: the dataset at ``paths``, the
    loop and MODEL_FLAGS."""
    return dataset_flags(*paths) + [
        "--batch_size", str(batch),
        "--num_iterations", str(iters),
        "--print_every", "50",
        "--checkpoint_every", str(iters),
        "--loader_num_workers", str(workers),
        "--num_val_samples", str(2 * batch),
        "--seed", str(seed),
        "--device", device,
    ] + MODEL_FLAGS


def box_head_probe(flags) -> list[float]:
    """Per box output (x0, y0, x1, y1), the share of the real objects for
    which it is non-zero, from the generator that the train CLI's
    ``flags`` build and initialise, on the first batch of their training
    loader (G in eval mode, zero layout noise, on the flags' device).  An
    output at 0 for every object passes no gradient under the final ReLU:
    the head is dead when one of the four is."""
    import torch

    from sg2im_tpu_torch.cli import train as cli
    from sg2im_tpu_torch.data.loader import PaddedLoader
    from sg2im_tpu_torch.train.trainer import Trainer

    args = cli.build_parser().parse_args(flags)
    config = cli.config_from_args(args)
    vocab, train_ds, _ = cli.build_datasets(config)
    batch = next(iter(PaddedLoader(
        train_ds, shuffle=True, batch_size=config.batch_size,
        O_max=config.pad_objects_to, T_max=config.pad_triples_to,
        num_workers=0, seed=config.seed)))
    trainer = Trainer(config, vocab, device=args.device)
    state = trainer.init_state(seed=config.seed)
    b = trainer.to_device(batch)
    G = trainer.generator.eval()
    N = b["objs"].shape[0]
    noise = (torch.zeros((N, config.layout_noise_dim) + config.image_size,
                         device=trainer.device)
             if config.layout_noise_dim > 0 else None)
    with torch.no_grad():
        boxes = torch.func.functional_call(
            G, state.g, (b["objs"], b["triples"], b["obj_mask"],
                         b["triple_mask"]), dict(layout_noise=noise))[1]
    real = boxes[b["obj_mask"] > 0]
    return [float(v) for v in (real != 0).float().mean(0)]


def run_training(out_dir: str, flags):
    """Train with the CLI's ``flags`` into ``<out_dir>/run`` -> (run dir,
    :func:`train_proof.run_cli`'s dict)."""
    run_dir = os.path.join(out_dir, "run")
    return run_dir, run_cli(flags, run_dir)


def write_goldens(pt_path: str, graphs, golden_dir: str):
    """The port's float32 engine on the CPU, zero noise: img%06d.png."""
    from PIL import Image

    from sg2im_tpu_torch.inference import InferenceEngine

    os.makedirs(golden_dir, exist_ok=True)
    engine = InferenceEngine.from_torch_checkpoint(pt_path, device="cpu")
    u8, _ = engine.generate(graphs, noise="zeros")
    for i, img in enumerate(u8):
        Image.fromarray(img).save(os.path.join(golden_dir, f"img{i:06d}.png"))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "trained_fidelity"))
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse an existing --out run (export and gate "
                         "only)")
    ap.add_argument("--min_psnr", type=float, default=40.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the training and of the gate "
                         "('cpu' runs on the host; the JAX script's --cpu)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    report = os.path.join(args.out, "TRAINED_FIDELITY.md")
    run_dir = os.path.join(args.out, "run")
    run = shares = None
    if not args.skip_train:
        print(f"building {args.images}-image disk dataset ...", flush=True)
        flags = train_flags(build_dataset(args.out, args.images), args.iters,
                            args.batch_size, args.workers, SEED,
                            args.device)
        shares = box_head_probe(flags)
        print(f"box head at init (seed {SEED}): non-zero for "
              f"{', '.join(f'{v:.4f}' for v in shares)} of the objects "
              f"(x0, y0, x1, y1)", flush=True)
        if min(shares) == 0.0:
            dead = [k for k, v in zip(("x0", "y0", "x1", "y1"), shares)
                    if v == 0.0]
            cause = (f"the box head is dead at init: seed {SEED} leaves "
                     f"box output(s) {', '.join(dead)} at 0 for every object "
                     f"of the first batch under the final ReLU, so no "
                     f"gradient reaches them")
            with open(report, "w") as f:
                f.write(f"# Trained-weights fidelity loop\n\nFAILED before "
                        f"training: {cause}.\n")
            print(f"FAIL: {cause}", file=sys.stderr)
            print(json.dumps({"pass": False, "seed": SEED,
                              "box_nonzero_share_init": shares,
                              "cause": cause}))
            return 1
        run_dir, run = run_training(args.out, flags)
    ckpt_dir = os.path.join(run_dir, "checkpoint_state")
    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"no checkpoint at {ckpt_dir}")

    from sg2im_tpu_torch.cli import verify_pretrained
    from sg2im_tpu_torch.cli.checkpoint_tools import export

    pt_path = os.path.join(args.out, "trained_coco64.pt")
    if export(ckpt_dir, pt_path) != 0:
        raise SystemExit("checkpoint_tools export failed")
    graphs = make_scene_graphs()
    sg_path = os.path.join(args.out, "trained_scene_graphs.json")
    with open(sg_path, "w") as f:
        json.dump(graphs, f, indent=1)
    golden = os.path.join(args.out, "golden")
    write_goldens(pt_path, graphs, golden)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = verify_pretrained.main([
            "--checkpoint", pt_path, "--scene_graphs_json", sg_path,
            "--output_dir", os.path.join(args.out, "gate_out"),
            "--golden_dir", golden, "--min_psnr", str(args.min_psnr),
            "--device", args.device])
    sys.stdout.write(buf.getvalue())
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if not lines:
        raise SystemExit(f"verify_pretrained exited {rc} with no result")
    result = json.loads(lines[-1])
    db = result["psnr"]["golden_u8:ALL"]

    l1 = [v for _, v in run["l1"]] if run else []
    l1_line = (f"{np.mean(l1[:3]):.4f} -> {np.mean(l1[-3:]):.4f}"
               if len(l1) >= 6 else "(training skipped or too short)")
    iou = run["iou"] if run else None
    iou_line = (f"{iou['train_iou']:.4f}, {iou['val_iou']:.4f}" if iou
                else "(training skipped)")
    dead = iou is not None and max(iou.values()) == 0.0
    cause = ("the box head is dead after training: the final check_model's "
             "box IoU is 0 on both splits" if dead else None)
    share_line = ("(training skipped)" if shares is None else
                  f"{', '.join(f'{v:.4f}' for v in shares)} (seed "
                  f"{SEED})")
    fail_line = f"\n**FAILED**: {cause}.\n" if cause else ""
    card = card_name() if args.device.startswith("cuda") else None
    where = f"on {card}" if card else f"--device {args.device}"
    with open(report, "w") as f:
        f.write(f"""# Trained-weights fidelity loop (sg2im_tpu_torch.tools.trained_fidelity)

Date: {time.strftime('%Y-%m-%d')}, {where}.  Train -> native checkpoint ->
`checkpoint_tools export` .pt -> `verify_pretrained --device {args.device}`
against golden PNGs of the same .pt from the port's float32 engine on the
CPU.

| item | value |
|---|---|
| dataset | {args.images} disk JPEGs (train_proof's category->colour task, seed 0) |
| model | coco64, embed/gconv 64, hidden 256, 3 gconv layers, CRN (256,128,64), mask 16 |
| training | {args.iters} iters @ batch {args.batch_size}, seed {SEED}{f", wall {run['wall']:.1f} s" if run else " (reused run)"} |
| L1 pixel loss (first 3 -> last 3 records) | {l1_line} |
| objects with non-zero x0, y0, x1, y1 at init (first batch) | {share_line} |
| box IoU of the final check_model (train, val) | {iou_line} |
| exported .pt | `{pt_path}` ({os.path.getsize(pt_path) / 1e6:.1f} MB) |
| gate scene graphs | `{sg_path}` ({len(graphs)} graphs) |
| **gate (u8 PSNR, {args.device} vs the CPU engine)** | **{db:.2f} dB** (bar: {args.min_psnr:.0f} dB) |
| ops without a deterministic implementation | {'; '.join(f'{k} (x{v})' for k, v in (run or {}).get('nondeterministic', {}).items()) or 'none warned'} |
{fail_line}""")
    print(f"wrote {report}")
    if cause:
        print(f"FAIL: {cause}", file=sys.stderr)
    ok = rc == 0 and not dead
    print(json.dumps({"psnr_u8_db_trained": db, "pass": ok,
                      "gate_pass": rc == 0, "seed": SEED,
                      "box_nonzero_share_init": shares,
                      "box_head_alive": not dead, "cause": cause,
                      "l1": run["l1"] if run else [], "iou": iou,
                      "wall_s": run["wall"] if run else None}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
