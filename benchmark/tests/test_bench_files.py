"""BENCHMARK.json against the shape its readers expect, every file a cell needs
present, and a cell, configuration, mix, metric and kernel bound that are
new found by name in a directory of their own, with no file edited."""

import json
import re
import shutil

import pytest
import torch

from benchmark import run
from benchmark.harness import files
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_its_shape():
    b = files.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", []):
            assert files.reports(e2e[m["moves"]], cell, b)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:
        reported = {m["name"] for m in files.cell_metrics(b, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert files.cell_metrics(b, cell, True)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  files.benchmark()["workloads"]])
def test_every_file_of_a_cell_is_there(cell):
    b = files.benchmark()
    w = files.workload(b, cell)
    files.config(b, w["config"])
    traffic = files.traffic(w["traffic"])
    files.driver(traffic["driver"]).Driver
    assert files.limits(cell)["checks"]
    for trace in (False, True):
        for m in files.cell_metrics(b, cell, trace):
            assert callable(files.reader(m["name"]))
    for k in files.kernels():
        assert isinstance(k.NAME, str) and callable(k.bound_s)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return root, tiny.build(root)


@pytest.mark.parametrize("cell", tiny.cells())
def test_a_sound_run_is_correct(cell, tiny_root):
    """A whole run of each cell at a tiny size on the CPU, with the cell's
    own limits: the reference agrees with the program."""
    root, bench_dir = tiny_root
    torch.set_num_threads(2)
    out = run.run(cell, 2**31 + 17, 0.5, False, device="cpu", root=root,
                  t_start=0.0, bench_dir=bench_dir)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {m["name"] for m in files.cell_metrics(
        files.benchmark(root), cell, False)} == set(out["metrics"])


def test_the_later_cells_have_the_shape_of_the_benchmarks():
    """The entries that ``later_cells.json`` holds for cells to come pass
    the checks that ``BENCHMARK.json``'s do, and each has its files."""
    b = files.benchmark()
    for key in ("workloads", "end_to_end", "per_layer"):
        b[key] = b[key] + tiny.LATER[key]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for w in tiny.LATER["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["traffic"] in tiny.LATER["traffic"]
        assert tiny.LATER["limits"][w["name"]]["checks"]
        files.driver(tiny.LATER["traffic"][w["traffic"]]["driver"]).Driver
        reported = {m["name"] for m in files.cell_metrics(b, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        for m in files.cell_metrics(b, w["name"], True):
            assert callable(files.reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path):
    """A throwaway configuration, traffic mix, metric and kernel bound,
    added beside the others: the run finds each by its name, and no file
    of the benchmark changes."""
    before = {p: p.read_bytes() for p in files.BENCH_DIR.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    bench_dir = tiny.build(tmp_path)
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "benchmark/configs/vg128.json").read_text())
    cfg["name"] = "vg_tiny_new"
    cfg["model"]["image_size"] = [16, 16]
    cfg["model"]["refinement_dims"] = [16, 8]
    (tmp_path / "benchmark/configs/vg_tiny_new.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic/gen-vg-b128.json").read_text())
    mix.update(batch=3, max_objects=4)
    (bench_dir / "traffic/gen-new-mix.json").write_text(json.dumps(mix))
    shutil.copy(bench_dir / "limits/vg128-gen-b128.json",
                bench_dir / "limits/vg_tiny_new.gen.json")
    (bench_dir / "metrics/objects_per_call.new.py").write_text(
        "def read(record):\n"
        "    return record.window['images'] / record.window['units']\n")
    (bench_dir / "kernels/Z9_new.py").write_text(
        "NAME = 'no_such_kernel'\n\n\ndef bound_s(unit, cfg):\n"
        "    return 1.0\n")
    b["configs"].append({"name": "vg_tiny_new", "source": "a test",
                         "file": "benchmark/configs/vg_tiny_new.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "vg_tiny_new.gen", "config": "vg_tiny_new",
                           "traffic": "gen-new-mix", "chips": 1,
                           "why": "a test"})
    b["end_to_end"][0]["workloads"].append("vg_tiny_new.gen")
    b["end_to_end"].append({"name": "objects_per_call.new", "unit": "graphs",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["vg_tiny_new.gen"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    torch.set_num_threads(2)
    out = run.run("vg_tiny_new.gen", 3, 0.3, False, device="cpu",
                  root=tmp_path, t_start=0.0, bench_dir=bench_dir)
    assert out["correct"], out["checks"]
    assert out["metrics"]["objects_per_call.new"]["value"] == 3.0
    assert "no_such_kernel" in [k.NAME for k in files.kernels(bench_dir)]
    after = {p: p.read_bytes() for p in files.BENCH_DIR.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before
