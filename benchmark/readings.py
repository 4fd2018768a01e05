"""The readings that a cell's limits are set from, on the card at the
cell's own size: the numbers of sound runs of the program over many seeds
(the lower readings), of the control (the upper readings) and of the
faults a cell can have.

    python3 benchmark/readings.py --workload vg128-gen-b128 \
        --seeds 11,12,13 --seconds 2 --what program

``--what``: 'program' (sound runs); 'turbo' (the program's own int8 path
in the bf16 CRN's place, the control of a served configuration);
'tf32' (the reference in the program's place with TF32 on for its float32
matmuls and convolutions, the control of the float32 parts);
'half_batch' (training: the reference in the program's place on the first
half of each batch, its means over that half).  One JSON line a seed,
with the numbers and, for training, each step's loss gaps.  The runs of
the benchmark itself never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402  (sets the caches)


def loss_steps(prog, refr) -> list:
    """Each checked step's relative gaps of (G, D_obj, D_img) totals."""
    return [[abs(p - r) / abs(r) for p, r in zip(ps, rs)]
            for ps, rs in zip(prog["losses"], refr["losses"])]


def worst_leaves(prog, refr) -> dict:
    """For the gradient and update numbers: the leaf that sets each, its
    gap, its reference norm and the median kept leaf's."""
    import statistics

    from benchmark.drivers import train
    from benchmark.harness import checks

    out = {}
    for what in ("grads", "updates"):
        best = None
        for m in train.MODELS:
            keep = checks.kept_leaves(refr["grads"][m])
            med = statistics.median(refr[what][m][k] for k in keep)
            for k in keep:
                r = refr[what][m][k]
                gap = abs(prog[what][m][k] - r) / max(r, med)
                if best is None or gap > best[0]:
                    best = (gap, f"{m}.{k}", r, med)
        out[what] = best
    return out


def worst_images(prog, refs, top: int = 3) -> list:
    """The images whose uint8 difference is largest: (mean squared
    difference, the reference image's range before its min-max rescale),
    beside the median image's."""
    import numpy as np

    rows = []
    for (imgs, _, _), (r_imgs, _, _, _, ranges) in zip(prog, refs):
        d = ((imgs.astype(np.float64) - r_imgs) ** 2).reshape(
            len(imgs), -1).mean(1)
        rows += list(zip(d.tolist(), ranges.tolist()))
    rows.sort(reverse=True)
    med = rows[len(rows) // 2]
    return {"worst": rows[:top], "median": med, "images": len(rows)}


def reading(workload: str, seed: int, seconds: float, what: str,
            device="cuda:0") -> dict:
    from benchmark.harness import device as dev
    from benchmark.harness import files

    bench = files.benchmark()
    w = files.workload(bench, workload)
    cfg = files.config(bench, w["config"])
    traffic = files.traffic(w["traffic"])
    kind = traffic["driver"]
    drv = files.driver(kind).Driver(
        bench_run.Context(workload, cfg, traffic, seed, device))
    if what == "turbo" and kind == "generate":
        drv.setup(quantize="int8")
    elif what == "turbo" and kind == "serve":
        drv.setup(extra_args=["--quantize", "int8"])
    elif what == "turbo":
        raise SystemExit("the program has no int8 path for training")
    else:
        drv.setup()
    dev.sync(device)
    drv.window(seconds)
    drv.release()
    out = {"workload": workload, "seed": seed, "what": what}
    if kind == "train":
        from benchmark.drivers import train

        refr = train.reference_readings(cfg, traffic, seed, device)
        if what == "program":
            cand = drv.readings
        elif what == "tf32":
            cand = train.reference_readings(cfg, traffic, seed, device,
                                            tf32=True)
        elif what == "half_batch":
            rows = traffic["batch_size"] // 2
            cand = train.reference_readings(cfg, traffic, seed, device,
                                            rows=rows)
        else:
            raise SystemExit(f"no {what!r} reading for training")
        out["numbers"] = train.compare(cand, refr)
        out["loss_steps"] = loss_steps(cand, refr)
        out["worst_leaves"] = worst_leaves(cand, refr)
        return out
    from benchmark.drivers import generate

    refs = drv.reference_outputs()
    if what == "tf32":
        cand = [r[:3] for r in drv.reference_outputs(tf32=True)]
        if kind == "serve":
            cand = [(i, b, None) for i, b, _ in cand]
    elif what in ("program", "turbo"):
        cand = drv.program_outputs()
    else:
        raise SystemExit(f"no {what!r} reading for {kind}")
    out["numbers"] = generate.compare(cand, refs)
    out["worst_images"] = worst_images(cand, refs)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default=2.0, type=float)
    p.add_argument("--what", default="program",
                   choices=("program", "turbo", "tf32", "half_batch"))
    args = p.parse_args(argv)
    for s in args.seeds.split(","):
        t = time.time()
        r = reading(args.workload, int(s), args.seconds, args.what)
        r["seconds"] = time.time() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
