"""Disk-backed training proof of the port: the production path learns.

Port of ``scripts/train_proof.py``.  JSON-annotated JPEGs on disk ->
``CocoSceneGraphDataset`` (decode, RLE, heuristic triples) ->
``PaddedLoader`` threads -> ``sg2im_tpu_torch.cli.train`` on the card, for
hundreds of steps on a task that can be learned: each category is a solid
colour patch at its box, so the CRN has real signal (category -> colour).
Passes when the mean of the last four printed L1 pixel losses is below the
mean of the first four.

    python -m sg2im_tpu_torch.tools.train_proof [--images 2048] [--iters 500]
        [--bf16 1 --crn_mode split] [--out DIR] [--device cpu]

Reads the loss trace from the run's ``log.jsonl`` (every 25 steps), and
times each of those records as the CLI logs it: the steady-state rate is
the steps between the first and last record over their wall time (it
leaves out start-up and the final check_model; it includes epoch starts),
beside the median interval between records.  Also measures the loader
alone, one thread's decode, and one batch's host-to-card copy (staged
into one pageable and one pinned buffer, the median of CUDA events around
each of 10 single copies, with GB/s), and
lists every PyTorch operation that warned that it has no deterministic
implementation.  Writes ``TRAIN_PROOF.md``
and ``train_proof.json`` (the numbers, for ``tools.loader_bench
--proof_report``) under ``--out``; the dataset and the run (``<out>/run``,
replaced on each call) go there too.  ``--compare_to`` an earlier run's
``train_proof.json`` (same flags, any length) checks the determinism
claim: the two L1 traces must be bit-identical on their common prefix.
Exit code 1 if the loss did not fall or the traces differ.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import tempfile
import time
import warnings

import numpy as np

CATEGORY_COLORS = {
    1: (220, 40, 40), 2: (40, 200, 60), 3: (60, 80, 220),
    4: (230, 200, 40), 5: (200, 60, 200), 6: (40, 210, 210),
}
STUFF_COLOR = (110, 130, 90)
PRINT_EVERY = 25


def build_dataset(root: str, n_images: int, hw: int = 64, seed: int = 0):
    """COCO-schema instances and stuff JSON and JPEG images under ``root``,
    byte for byte those of the JAX script at the same arguments: a ground
    plane (stuff, RLE) on the bottom third and 2-5 coloured boxes
    (instances, polygons).  -> (image dir, instances path, stuff path)."""
    from PIL import Image

    from sg2im_tpu_torch.data.rle import mask_to_rle

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, inst_anns, stuff_anns = [], [], []
    for i in range(n_images):
        canvas = np.full((hw, hw, 3), 170, np.uint8)
        gh = hw // 3
        canvas[hw - gh:, :] = STUFF_COLOR
        m = np.zeros((hw, hw), np.uint8)
        m[hw - gh:, :] = 1
        img_id = 1000 + i
        stuff_anns.append({
            "id": 500000 + i, "image_id": img_id, "category_id": 90,
            "bbox": [0, hw - gh, hw, gh], "segmentation": mask_to_rle(m),
        })
        for _ in range(rng.randint(2, 6)):
            cat = int(rng.randint(1, len(CATEGORY_COLORS) + 1))
            # Sizes scale with the canvas, so that the 2% minimum object
            # size keeps the same objects at any hw.
            w = int(rng.randint(10 * hw // 64, 28 * hw // 64))
            h = int(rng.randint(10 * hw // 64, 28 * hw // 64))
            x = int(rng.randint(0, hw - w))
            y = int(rng.randint(0, hw - h))
            canvas[y:y + h, x:x + w] = CATEGORY_COLORS[cat]
            poly = [[x, y, x + w, y, x + w, y + h, x, y + h]]
            inst_anns.append({
                "id": len(inst_anns) + 1, "image_id": img_id,
                "category_id": cat, "bbox": [x, y, w, h],
                "segmentation": poly,
            })
        fn = f"img{i:06d}.jpg"
        Image.fromarray(canvas).save(os.path.join(img_dir, fn), quality=92)
        images.append({"id": img_id, "file_name": fn,
                       "width": hw, "height": hw})
    categories = [{"id": c, "name": f"thing{c}"} for c in CATEGORY_COLORS]
    inst_path = os.path.join(root, "instances.json")
    stuff_path = os.path.join(root, "stuff.json")
    with open(inst_path, "w") as f:
        json.dump({"images": images, "categories": categories,
                   "annotations": inst_anns}, f)
    with open(stuff_path, "w") as f:
        json.dump({"images": images,
                   "categories": [{"id": 90, "name": "ground"}],
                   "annotations": stuff_anns}, f)
    return img_dir, inst_path, stuff_path


def open_dataset(img_dir, inst_path, stuff_path, **kw):
    """The proof's dataset as the CLI builds it (64x64, 16x16 masks)."""
    from sg2im_tpu_torch.data.coco import CocoSceneGraphDataset

    return CocoSceneGraphDataset(
        image_dir=img_dir, instances_json=inst_path, stuff_json=stuff_path,
        image_size=(64, 64), mask_size=16, seed=0, **kw)


def measure_loader(ds, batch_size: int, num_workers: int, n_batches: int):
    """Images a second of ``PaddedLoader`` alone over ``n_batches``
    batches (or the rest of the epoch), after one batch that warms the
    pool."""
    from sg2im_tpu_torch.data.loader import PaddedLoader

    loader = PaddedLoader(ds, batch_size=batch_size, O_max=16, T_max=16,
                          num_workers=num_workers, seed=0)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        n += batch["imgs"].shape[0]
        if n >= n_batches * batch_size:
            break
    dt = time.perf_counter() - t0
    it.close()
    return n / dt


def card_name():
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0].strip() if smi.returncode == 0 and lines else None


def dataset_flags(img_dir, inst_path, stuff_path):
    """The CLI's COCO flags for the proof's dataset (train and val are the
    same split, as in the JAX script)."""
    return ["--dataset", "coco", "--image_size", "64,64",
            "--coco_train_image_dir", img_dir,
            "--coco_val_image_dir", img_dir,
            "--coco_train_instances_json", inst_path,
            "--coco_val_instances_json", inst_path,
            "--coco_train_stuff_json", stuff_path,
            "--coco_val_stuff_json", stuff_path]


def run_cli(flags, run_dir):
    """``sg2im_tpu_torch.cli.train.main(flags)`` into a fresh ``run_dir``
    (its output directory).  -> dict: ``wall`` s, ``l1`` [[t, L1 pixel
    loss], ...] and ``iou`` (the last check_model's train and val box
    IoU, or None) from ``log.jsonl``, ``logged_at`` [[t, perf_counter s], ...] when each train record was
    logged (after its step's losses reached the host), ``nondeterministic``
    {warning: count} of operations without a deterministic
    implementation.  Raises SystemExit if the CLI fails."""
    from sg2im_tpu_torch.cli import train as cli

    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    logged_at = []
    base = cli.make_scalar_logger

    def stamped(config, process_index=0):
        write = base(config, process_index)

        def log(record):
            write(record)
            if record.get("kind") == "train":
                logged_at.append([record["t"], time.perf_counter()])

        return log

    cli.make_scalar_logger = stamped
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rc = cli.main(flags + ["--output_dir", run_dir])
    finally:
        cli.make_scalar_logger = base
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"the train CLI exited {rc}")
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    nondet = {}
    for w in caught:
        msg = str(w.message)
        if "deterministic" in msg:
            key = msg.split(". ")[0]
            nondet[key] = nondet.get(key, 0) + 1
    evals = [r for r in records if r["kind"] == "eval"]
    return {"wall": wall, "logged_at": logged_at,
            "l1": [[r["t"], r["L1_pixel_loss"]] for r in records
                   if r["kind"] == "train"],
            "iou": ({k: evals[-1][k] for k in ("train_iou", "val_iou")}
                    if evals else None),
            "nondeterministic": nondet}


def stage_batch(batch: dict):
    """Every array of ``batch``, in order, packed byte for byte into one
    contiguous uint8 host tensor."""
    import torch

    return torch.from_numpy(np.concatenate(
        [np.ascontiguousarray(v).reshape(-1).view(np.uint8)
         for v in batch.values()]))


def h2d_copy(batch: dict, device: str, reps: int = 10):
    """One batch's host-to-card copy as one staged buffer: the batch is
    packed into one contiguous pageable host buffer (:func:`stage_batch`)
    and into one pinned one, and a card buffer is allocated, all outside
    the timing; then the median over ``reps`` single copies of each host
    buffer into the card's, each between two CUDA events on the stream
    that does the copy, queued behind a spin kernel so that the host's
    enqueueing falls outside them -> {"bytes", "pageable_ms", "pinned_ms",
    "pageable_gb_s", "pinned_gb_s"}, or None when ``device`` is not a
    card."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    host = stage_batch(batch)
    pinned = host.pin_memory()
    out = {"bytes": int(host.numel())}
    dst = torch.empty_like(host, device=device)
    stream = torch.cuda.current_stream(device)
    for name, src, non_blocking in (("pageable", host, False),
                                    ("pinned", pinned, True)):
        times = []
        for _ in range(reps + 1):  # the first one warms the copy path
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            # A few ms of spinning ahead of the events: the host enqueues
            # both events and the copy before the card reaches them, so
            # the span holds the copy and not the host's enqueueing.
            torch.cuda._sleep(10_000_000)
            a.record(stream)
            dst.copy_(src, non_blocking=non_blocking)
            b.record(stream)
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
        ms = float(np.median(times[1:]))
        out[f"{name}_ms"] = ms
        out[f"{name}_gb_s"] = out["bytes"] / ms / 1e6
    return out


def rates(logged_at, batch_size: int):
    """Steady-state img/s between the first and last logged record, and
    the median interval between records (s) with its img/s."""
    times = [s for _, s in logged_at]
    if len(times) < 2:
        return None, None, None
    steps = logged_at[-1][0] - logged_at[0][0]
    steady = steps * batch_size / (times[-1] - times[0])
    med = float(np.median(np.diff(times)))
    per = (logged_at[1][0] - logged_at[0][0]) * batch_size
    return steady, med, per / med


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "train_proof"))
    ap.add_argument("--bf16", type=int, default=0,
                    help="1: train with --bf16_compute (the mixed-precision "
                         "CRN chain), for the bf16 stability proof")
    ap.add_argument("--checkpoint_every", type=int, default=None,
                    help="eval / checkpoint interval (default: only at the "
                         "end)")
    ap.add_argument("--cache", type=int, default=0,
                    help="1: train through the --cache_dir decoded-sample "
                         "cache (the samples are the same either way)")
    ap.add_argument("--eval_mode_after", type=int, default=None,
                    help="passthrough: eval-mode BatchNorm and a fresh G "
                         "Adam from this iteration")
    ap.add_argument("--snapshot_every", type=int, default=None,
                    help="passthrough: reference-layout .pt snapshot "
                         "cadence")
    ap.add_argument("--crn_mode", default=None,
                    help="passthrough: CRN stage-conv formulation "
                         "('split' = the fast training mode)")
    ap.add_argument("--decoder", default=None,
                    help="passthrough: image decode backend "
                         "(data/decode.py: pil|native|native_fast)")
    ap.add_argument("--report", default=None,
                    help="markdown report path (default "
                         "<out>/TRAIN_PROOF.md)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run ('cpu' runs on the host; "
                         "the JAX script's --cpu)")
    ap.add_argument("--compare_to", default=None,
                    help="train_proof.json of an earlier run with the same "
                         "flags: its L1 trace must equal this run's, bit "
                         "for bit, on their common prefix")
    return ap


def train_flags(args, data_flags):
    """The JAX script's CLI flags for ``args`` (``--output_dir`` aside)."""
    flags = data_flags + [
        "--batch_size", str(args.batch_size),
        "--num_iterations", str(args.iters),
        "--print_every", str(PRINT_EVERY),
        "--checkpoint_every", str(args.checkpoint_every or args.iters),
        "--loader_num_workers", str(args.workers),
        "--num_val_samples", str(2 * args.batch_size),
        "--device", args.device,
    ]
    if args.bf16:
        flags += ["--bf16_compute", "1"]
    if args.cache:
        flags += ["--cache_dir", os.path.join(args.out, "cache")]
    if args.eval_mode_after is not None:
        flags += ["--eval_mode_after", str(args.eval_mode_after)]
    if args.snapshot_every is not None:
        flags += ["--snapshot_every", str(args.snapshot_every)]
    if args.crn_mode:
        flags += ["--crn_mode", args.crn_mode]
    if args.decoder:
        flags += ["--decoder", args.decoder]
    return flags


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    print(f"building {args.images}-image disk dataset ...", flush=True)
    t0 = time.perf_counter()
    paths = build_dataset(args.out, args.images)
    print(f"  built in {time.perf_counter() - t0:.1f}s")
    ds = open_dataset(*paths)
    print(f"dataset: {len(ds)} images, vocab "
          f"{len(ds.vocab['object_idx_to_name'])} objects")
    loader_rate = measure_loader(ds, args.batch_size, args.workers,
                                 n_batches=30)
    print(f"loader-only throughput: {loader_rate:.0f} images/sec "
          f"({args.workers} workers)", flush=True)

    run = run_cli(train_flags(args, dataset_flags(*paths)),
                  os.path.join(args.out, "run"))
    l1 = [v for _, v in run["l1"]]
    if len(l1) < 2:
        raise SystemExit(f"{len(l1)} logged L1 values: run at least "
                         f"{2 * PRINT_EVERY} iterations")
    head, tail = float(np.mean(l1[:4])), float(np.mean(l1[-4:]))
    steady, med_s, med_rate = rates(run["logged_at"], args.batch_size)
    decreased = tail < head

    # One thread's decode cost per image, for sizing the host.
    n = min(100, len(ds))
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    ms_img = (time.perf_counter() - t0) / n * 1e3

    from sg2im_tpu_torch.data.loader import PaddedLoader

    probe_it = iter(PaddedLoader(ds, batch_size=args.batch_size, O_max=16,
                                 T_max=16, num_workers=1, seed=0))
    probe = next(probe_it)
    probe_it.close()
    h2d = h2d_copy(probe, args.device)
    card = card_name() if h2d is not None else None
    ncpu = multiprocessing.cpu_count()
    mode = ("bf16" if args.bf16 else "f32") + f"/{args.crn_mode or 'legacy'}"

    print("\n==== train proof ====")
    print(f"{mode} iters={args.iters} wall={run['wall']:.1f}s incl. start-up;"
          f" steady-state {steady:.1f} img/s, median interval "
          f"{med_s:.3f} s ({med_rate:.1f} img/s)")
    print(f"L1 pixel loss: first-4-record mean {head:.4f} -> last-4-record "
          f"mean {tail:.4f} ({(1 - tail / head) * 100:.1f}% decrease)")
    print(f"loader-only: {loader_rate:.0f} img/s vs train consumption "
          f"{steady:.0f} img/s")
    if run["nondeterministic"]:
        print("operations without a deterministic implementation: "
              + "; ".join(f"{k} (x{v})"
                          for k, v in run["nondeterministic"].items()))

    summary = {
        "mode": mode, "device": args.device, "card": card,
        "images": args.images, "dataset_images": len(ds),
        "iters": args.iters, "batch_size": args.batch_size,
        "workers": args.workers, "wall_s": run["wall"],
        "l1": run["l1"], "l1_head": head, "l1_tail": tail, "iou": run["iou"],
        "decreased": decreased, "steady_img_s": steady,
        "median_interval_s": med_s, "median_img_s": med_rate,
        "intervals_s": np.diff([s for _, s in run["logged_at"]]).tolist(),
        "loader_img_s": loader_rate, "decode_ms_per_image": ms_img,
        "cpus": ncpu, "h2d": h2d,
        "nondeterministic": run["nondeterministic"],
    }
    same = True
    if args.compare_to:
        with open(args.compare_to) as f:
            earlier = json.load(f)["l1"]
        n = min(len(earlier), len(run["l1"]))
        same = n > 0 and earlier[:n] == run["l1"][:n]
        summary["compared_to"] = {"path": args.compare_to, "records": n,
                                  "bit_identical": same}
        print(f"L1 trace against {args.compare_to}: {n} common records, "
              f"{'bit-identical' if same else 'DIFFERENT'}")
    with open(os.path.join(args.out, "train_proof.json"), "w") as f:
        json.dump(summary, f, indent=1)
    report = args.report or os.path.join(args.out, "TRAIN_PROOF.md")
    with open(report, "w") as f:
        f.write(render_report(summary))
    print(f"wrote {report}")
    if not decreased:
        print(f"FAIL: the L1 pixel loss did not decrease ({head:.4f} -> "
              f"{tail:.4f})")
    if not same:
        print(f"FAIL: the L1 trace differs from {args.compare_to}'s")
    return 0 if decreased and same else 1


def render_report(s) -> str:
    where = (f"on {s['card']}" if s["card"] else
             f"on the host's CPU (--device {s['device']})")
    if s["h2d"]:
        h = s["h2d"]
        copy = (f"{h['pageable_ms']:.3f} ms pageable, {h['pinned_ms']:.3f} "
                f"ms pinned for {h['bytes'] / 1e6:.2f} MB "
                f"({h['bytes'] / h['pinned_ms'] / 1e6:.2f} GB/s pinned; "
                f"median of CUDA events over 10 copies)")
    else:
        copy = "not measured (no card)"
    c = s.get("compared_to")
    repeat = (f"| L1 trace against `{c['path']}` | {c['records']} common "
              f"records, {'bit-identical' if c['bit_identical'] else 'DIFFERENT'} |\n"
              if c else "")
    iou = (f"{s['iou']['train_iou']:.4f}, {s['iou']['val_iou']:.4f}"
           if s["iou"] else "no check_model")
    nondet = ("; ".join(f"{k} (x{v})" for k, v in
                        s["nondeterministic"].items()) or "none warned")
    return f"""# Disk-backed training proof (sg2im_tpu_torch.tools.train_proof)

Date: {time.strftime('%Y-%m-%d')}, {where}; the production path (disk JPEG +
JSON -> CocoSceneGraphDataset -> PaddedLoader({s['workers']} workers) ->
sg2im_tpu_torch.cli.train, {s['mode']}).

| metric | value |
|---|---|
| dataset | {s['images']} disk JPEGs ({s['dataset_images']} pass the filters), COCO schema, learnable colour-coded categories |
| iterations | {s['iters']} @ batch {s['batch_size']} (COCO-64 default model) |
| wall time | {s['wall_s']:.1f} s (start-up and the final check_model included) |
| steady-state train throughput | {s['steady_img_s']:.1f} images/sec (between the first and last logged records; epoch starts included) |
| median interval between records | {s['median_interval_s']:.3f} s ({s['median_img_s']:.1f} images/sec) |
| loader-only throughput | {s['loader_img_s']:.0f} images/sec ({s['workers']} workers on {s['cpus']} CPU cores) |
| single-thread decode cost | {s['decode_ms_per_image']:.2f} ms/image |
| host->device batch copy | {copy} |
| L1 pixel loss | {s['l1_head']:.4f} -> {s['l1_tail']:.4f} ({(1 - s['l1_tail'] / s['l1_head']) * 100:.1f}% decrease: {'PASS' if s['decreased'] else 'FAIL'}) |
| box IoU of the final check_model (train, val) | {iou} |
| ops without a deterministic implementation | {nondet} |
{repeat}
L1 trace (step: loss): {', '.join(f'{t}: {v:.4f}' for t, v in s['l1'])}.
"""


if __name__ == "__main__":
    raise SystemExit(main())
