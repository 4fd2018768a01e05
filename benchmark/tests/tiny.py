"""A checkout-shaped directory whose cells are the benchmark's own at a tiny
size, for driving whole runs on the CPU: the real ``BENCHMARK.json``, the
real traffic, limits, metric and kernel files, and configurations cut to
widths a test can hold.  Beside them it holds the cells of
``later_cells.json``, which drive the training and serving drivers that no
cell of ``BENCHMARK.json`` uses yet: their entries, traffic and limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness import files

TINY_MODEL = {"image_size": [32, 32], "embedding_dim": 16, "gconv_dim": 16,
              "gconv_hidden_dim": 32, "gconv_pooling": "avg",
              "gconv_num_layers": 2, "mlp_normalization": "none",
              "refinement_dims": [32, 16, 8], "normalization": "batch",
              "activation": "leakyrelu-0.2", "mask_size": 8,
              "layout_noise_dim": 4}
TINY_TRAIN = {"d_obj_arch": "C4-8-2,C4-16-2",
              "d_img_arch": "C4-8-2,C4-16-2", "crop_size": 16}
TINY_TRAFFIC = {"batch": 4, "batch_size": 4, "sample_within": 2,
                "sample_calls": 1, "ref_block": 2, "rate": 20.0,
                "clients": 4, "grace_s": 10}
DATA = ("traffic", "limits", "metrics", "kernels")
LATER = files.load_json(Path(__file__).with_name("later_cells.json"))


def cells() -> list[str]:
    """The benchmark's cells and the later ones."""
    return [w["name"] for w in
            files.benchmark()["workloads"] + LATER["workloads"]]


def tiny_config(cfg: dict) -> dict:
    cfg = dict(cfg, model=dict(TINY_MODEL))
    if "train" in cfg:
        cfg["train"] = dict(cfg["train"], **TINY_TRAIN)
    return cfg


def build(root: Path) -> Path:
    """Fill ``root`` and return its benchmark directory."""
    bench_dir = root / "benchmark"
    for d in DATA:
        shutil.copytree(files.BENCH_DIR / d, bench_dir / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = files.benchmark()
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + LATER[key]
    for what in ("traffic", "limits"):
        for name, data in LATER[what].items():
            (bench_dir / what / f"{name}.json").write_text(json.dumps(data))
    for c in bench["configs"]:
        out = root / c["file"]
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(tiny_config(
            files.load_json(files.ROOT / c["file"]))))
    for path in (bench_dir / "traffic").glob("*.json"):
        t = files.load_json(path)
        t.update({k: v for k, v in TINY_TRAFFIC.items() if k in t})
        if t["driver"] == "generate":
            t["pool"] = 2
        if t["driver"] == "serve":
            t["server_args"] = ["--batch_window_ms", "5", "--max_graphs", "8",
                                "--warmup", "1"]
        path.write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir
