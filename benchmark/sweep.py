"""The highest rate a served cell sustains: one set-up of the cell, then an
open-loop stretch at each rate, from the lowest up.

    python3 benchmark/sweep.py --workload vg128-serve-poisson --seed 5 \
        --rates 100,200,400 --seconds 10

One JSON line a rate: the offered requests and graphs a second, the
graphs completed within the stretch a second, the median and 95th
percentile latency, the median latency of the stretch's first and last
quarter (a backlog that grows shows as a last quarter far above the
first), graphs per engine call and the generator's worst lateness.  The
cell's rate is fixed in its traffic file at about four fifths of the
highest rate whose backlog does not grow; the benchmark's runs never run
this.  No served cell is in ``BENCHMARK.json`` yet: the one measured
waits in ``PERF.md``'s Open questions, its entries, traffic and limits in
``tests/later_cells.json``, and has to be added there before this runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402  (sets the caches)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", default=10.0, type=float)
    args = p.parse_args(argv)

    from benchmark.harness import files, readers

    bench = files.benchmark()
    w = files.workload(bench, args.workload)
    cfg = files.config(bench, w["config"])
    traffic = files.traffic(w["traffic"])
    drv = files.driver(traffic["driver"]).Driver(bench_run.Context(
        args.workload, cfg, traffic, args.seed, "cuda:0"))
    drv.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        traffic["rate"] = rate
        win = drv.window(args.seconds)
        lat = np.array(win["latencies_ms"])
        due = drv.last["due"]
        size = drv.last["size"]
        done = due + lat / 1e3 <= args.seconds
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "rate": rate, "requests": len(lat),
            "offered_graphs_s": float(size.sum()) / args.seconds,
            "completed_graphs_s": float(size[done].sum()) / args.seconds,
            "p50_ms": readers.percentile(lat, 50),
            "p95_ms": readers.percentile(lat, 95),
            "first_quarter_p50_ms": statistics.median(lat[:q]),
            "last_quarter_p50_ms": statistics.median(lat[-q:]),
            "graphs_per_call": win["images"] / max(win["engine_calls"], 1),
            "failed": win["failed"], "lateness_s": win["lateness_s"]}),
            flush=True)
    drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
