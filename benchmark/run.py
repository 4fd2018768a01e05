"""The benchmark of sg2im_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload vg128-gen-b128 --seed 7 \
        --seconds 20 --trace 0

runs one cell of ``BENCHMARK.json`` from the root of a checkout: it builds
the program's weights and inputs from ``--seed`` on the card, sets the
program up and warms every shape the cell's traffic uses, measures for
``--seconds``, and with ``--trace 1`` then traces a short slice of the same
traffic under ``torch.profiler`` (the device's activity alone; a second
slice with the host's operations names the idle gaps).  It then frees the program, recomputes
what the window produced with the plain reference of
``benchmark/reference/`` and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit (also the last lines of standard error).

A cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``, whose ``driver`` names ``drivers/<driver>.py``);
its limits are ``limits/<workload>.json``, each metric is read by
``metrics/<metric>.py`` and each hand kernel's least work is
``kernels/<kernel>.py``.  To add a cell, add those files that are new and
its entries in ``BENCHMARK.json``; no file changes.

It exits 3 without enough CUDA cards and 4 if the process holds a module
of JAX or of the JAX package once the window has closed, printing no
result either way.  Build and kernel caches stay under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "benchmark-cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sg2im_tpu")


class Context:
    """What a ``drivers/<driver>.py`` is handed: the configuration, the
    traffic, the seed, the device."""

    def __init__(self, workload, cfg, traffic, seed, device):
        self.workload, self.cfg, self.traffic = workload, cfg, traffic
        self.seed, self.device = seed, device


class Record:
    """What a metric reader reads: ``cfg``, ``traffic``, ``setup_s``,
    ``window`` (the window dict from ``drivers/<driver>.py``), ``slice``
    (the traced slice or None), ``peak_s`` (the window's FLOPs at their
    peaks, in seconds, or None) and ``bench_dir`` (where the cell's files
    were found)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda:0", root: Path = ROOT, t_start: float | None = None,
        bench_dir: Path | None = None) -> dict:
    """One run of a cell -> the result line's dict."""
    import torch

    from benchmark.harness import checks, files
    from benchmark.harness import device as dev
    from benchmark.harness.trace import traced

    bench_dir = bench_dir or files.BENCH_DIR
    bench = files.benchmark(root)
    w = files.workload(bench, workload)
    cfg = files.config(bench, w["config"], root)
    traffic = files.traffic(w["traffic"], bench_dir)
    limits = files.limits(workload, bench_dir)
    drv = files.driver(traffic["driver"]).Driver(
        Context(workload, cfg, traffic, seed, device))
    drv.setup()
    dev.sync(device)
    setup_s = time.time() - (T_START if t_start is None else t_start)
    window = drv.window(seconds)
    print(f"window: {window['units']} units, {window['attempted']} "
          f"attempted, {window['failed']} failed in {window['seconds']} s",
          file=sys.stderr)
    sl = peak_s = None
    if trace:
        with traced(device) as sl:
            drv.trace_slice(sl)
        # The same traffic again with the host's operations recorded, for
        # the names of the idle gaps alone.
        with traced(device, host=True) as named:
            drv.trace_slice(named)
        sl.gaps = named.gaps
        for what, x in (("device alone", sl), ("with the host", named)):
            print(f"traced slice, {what}: {len(x.units)} units, busy "
                  f"{x.busy_s} of {x.window_s} s", file=sys.stderr)
        peak_s = drv.peak_seconds()
    info = (dev.info(device, w["chips"]) if torch.device(device).type
            == "cuda" else {"platform": "cpu"})
    drv.release()
    numbers = drv.check()
    correct, shown = checks.verdict(numbers, limits)
    correct = correct and window["failed"] == 0 and window["units"] > 0
    record = Record(cfg=cfg, traffic=traffic, setup_s=setup_s, window=window,
                    slice=sl, peak_s=peak_s, bench_dir=bench_dir)
    metrics = {}
    for m in files.cell_metrics(bench, workload, trace):
        v = files.reader(m["name"], bench_dir)(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if sl is not None:
        info.update(busy_s=sl.busy_s, window_s=sl.window_s)
    out = {"correct": bool(correct), "attempted": int(window["attempted"]),
           "failed": int(window["failed"]), "metrics": metrics,
           "device": info}
    if sl is not None:
        out["breakdown"] = {"device_ops": [list(x) for x in sl.device_ops],
                            "idle_gaps": [list(x) for x in sl.gaps]}
    out["checks"] = shown
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import checks, files

    chips = files.workload(files.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        print(f"the process holds modules of JAX or the JAX package: "
              f"{leaked}", file=sys.stderr)
        return 4
    checks.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
