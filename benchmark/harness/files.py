"""Everything of one cell, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file (``traffic/<traffic>.json``), its
limits (``limits/<workload>.json``), its driver (``drivers/<driver>.py``,
named by the traffic file), the readers of its metrics
(``metrics/<metric>.py``) and the kernel bounds (every
``kernels/*.py``).  A new cell, configuration, mix, metric or kernel bound
is a new file and a new entry; no existing file changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def limits(workload_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "limits" / f"{workload_name}.json")


def load_file(path: Path):
    """The module of one Python file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """``read(record) -> float | None`` of ``metrics/<metric>.py``."""
    return load_file(bench_dir / "metrics" / f"{metric}.py").read


def kernels(bench_dir: Path = BENCH_DIR) -> list:
    """The kernel bound modules: each has ``NAME`` (what its device events'
    names hold) and ``bound_s(unit, cfg) -> seconds or None``."""
    return [load_file(p) for p in sorted((bench_dir / "kernels").glob("*.py"))]


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Does ``cell`` report ``metric``: listed under its ``workloads``, or,
    without that key, for an end-to-end metric every cell, for a per-layer
    metric every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
    return bool(moved) and reports(moved[0], cell, bench)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: end-to-end without the trace,
    per-layer with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if reports(m, cell, bench)]
