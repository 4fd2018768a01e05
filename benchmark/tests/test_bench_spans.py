"""The readers of the program's spans (``harness/spans.py`` and the
``metrics/`` files that use it), on the CPU: a cell's tiny driver traced in
two profiler sessions as ``run.py`` traces it, after an earlier run in the
same process, and each reader held to the first session's spans alone;
None where the store holds no spans."""

import statistics
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run
from benchmark.harness import files, readers, spans
from benchmark.tests import tiny

GEN = {"encode_ms.gen": "sg2im.engine.encode",
       "forward_issue_ms.gen": "sg2im.model.forward",
       "fetch_wait_ms.gen": "sg2im.engine.fetch"}
NEW = ("encode_ms.gen", "engine_self_ms.gen", "forward_issue_ms.gen",
       "fetch_wait_ms.gen", "obj_slot_use_pct.gen")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return root, tiny.build(root)


def timing():
    from sg2im_tpu_torch.utils import timing

    return timing


def traced_run(cell, tiny_root, seed):
    """A cell's tiny driver: set-up, a short window, then two traced
    slices of its traffic under CPU profiler sessions.  -> (the record,
    the spans recorded during the first slice)."""
    root, bench_dir = tiny_root
    torch.set_num_threads(2)
    bench = files.benchmark(root)
    w = files.workload(bench, cell)
    cfg = files.config(bench, w["config"], root)
    traffic = files.traffic(w["traffic"], bench_dir)
    drv = files.driver(traffic["driver"]).Driver(
        run.Context(cell, cfg, traffic, seed, "cpu"))
    drv.setup()
    try:
        window = drv.window(0.2)
        firsts = []
        for _ in range(2):
            before = len(timing().recorded_spans())
            with profile(activities=[ProfilerActivity.CPU]):
                drv.trace_slice(SimpleNamespace(units=[]))
            firsts.append(timing().recorded_spans()[before:])
    finally:
        drv.release()
    record = run.Record(cfg=cfg, traffic=traffic, setup_s=0.0, window=window,
                        slice=None, peak_s=None, bench_dir=bench_dir)
    return record, firsts[0]


@pytest.fixture(scope="module")
def gen_run(tiny_root):
    timing().clear_spans()
    traced_run("coco64-gen-b128", tiny_root, 5)  # an earlier run
    return traced_run("vg128-gen-b128", tiny_root, 2**31 + 11)


def test_the_generate_readers_read_the_first_slice(gen_run, tiny_root):
    record, first = gen_run
    _, bench_dir = tiny_root
    n = record.traffic["trace_units"]
    gens = [s for s in first if s.name == "sg2im.engine.generate"]
    both = [s for s in timing().recorded_spans()
            if s.name == "sg2im.engine.generate"][-2 * n:]
    assert len(gens) == n and both[:n] == gens
    part = {g.id: {} for g in gens}
    for s in first:
        if s.parent in part:
            part[s.parent][s.name] = s.ms
    want = {m: statistics.median(part[g.id][name] for g in gens)
            for m, name in GEN.items()}
    want["engine_self_ms.gen"] = statistics.median(
        g.ms - sum(part[g.id].values()) for g in gens)
    want["obj_slot_use_pct.gen"] = 100.0 * sum(
        g.attrs["objects"] for g in gens) / sum(
        g.attrs["obj_slots"] for g in gens)
    for m in NEW:
        got = files.reader(m, bench_dir)(record)
        assert got == pytest.approx(want[m], rel=1e-12), m
    assert 0 < want["obj_slot_use_pct.gen"] <= 100
    assert sum(len(p) for p in part.values()) == 3 * n


@pytest.mark.parametrize("keep", ["all", "last-run", "one-short"])
def test_the_slices_are_the_stores_last_calls(gen_run, keep):
    """The two slices are the store's last 2n generate calls, whatever
    earlier runs left before them; with fewer than 2n, nothing is read."""
    record, _ = gen_run
    n = record.traffic["trace_units"]
    store = timing().recorded_spans()
    gens = [s for s in store if s.name == "sg2im.engine.generate"]
    assert len(gens) == 4 * n
    last = gens[-2 * n:]
    if keep == "last-run":
        store = store[store.index(gens[2 * n - 1]) + 1:]
    elif keep == "one-short":
        store = [s for s in store if s.name != "sg2im.engine.generate"
                 or s in last[1:]]
    calls = spans.generate_calls(record, store)
    if keep == "one-short":
        assert calls is None
    else:
        assert [c["ms"] for c in calls] == [g.ms for g in last]
        assert [c["objects"] for c in calls] == [
            g.attrs["objects"] for g in last]


def test_every_reader_gives_none_without_spans(gen_run, tiny_root,
                                               monkeypatch):
    """An empty store, and a program without one (the readers run on
    checkouts that predate the spans)."""
    record, _ = gen_run
    _, bench_dir = tiny_root
    for how in ("empty", "absent"):
        if how == "empty":
            monkeypatch.setattr(timing(), "recorded_spans", lambda: [])
        else:
            monkeypatch.delattr(timing(), "recorded_spans")
        for m in NEW + ("queue_wait_ms.serve",):
            assert files.reader(m, bench_dir)(record) is None, (m, how)


def test_the_queue_reader_reads_the_serve_cells_first_slice(tiny_root):
    """The serve cell's tiny run, alone in the store: its two slices queue
    as many requests, and the reader takes the first slice's."""
    timing().clear_spans()
    record, first = traced_run("vg128-serve-poisson", tiny_root, 2**31 + 3)
    waits = [s.ms for s in first if s.name == "sg2im.serve.queue"]
    assert waits
    assert len(spans.queue_waits_ms()) == len(waits)
    _, bench_dir = tiny_root
    got = files.reader("queue_wait_ms.serve", bench_dir)(record)
    assert got == readers.percentile(waits, 95)
