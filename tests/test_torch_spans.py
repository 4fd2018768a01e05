"""The port's spans (``sg2im_tpu_torch/utils/timing.py``) in the engine and
the server's batcher, on the CPU: nothing recorded without a profiler
session; under one, a generate call's four spans with their parents and
counters, the parts nested inside the call, the spans on the profiler's
own clock, a bounded store, and each served request's queue span tied to
the engine call that served it."""

from __future__ import annotations

import contextlib
import json
import threading
import time
import urllib.request

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sg2im_tpu_torch.utils import timing

OBJECTS = ["__image__", "cat", "dog", "tree", "grass", "sky"]
PREDICATES = ["__in_image__", "left of", "above", "near"]
VOCAB = {"object_idx_to_name": OBJECTS, "pred_idx_to_name": PREDICATES,
         "object_name_to_idx": {n: i for i, n in enumerate(OBJECTS)},
         "pred_name_to_idx": {n: i for i, n in enumerate(PREDICATES)}}
MODEL = {"image_size": (16, 16), "embedding_dim": 8, "gconv_dim": 8,
         "gconv_hidden_dim": 16, "gconv_num_layers": 1,
         "refinement_dims": (16, 8), "mask_size": 4, "layout_noise_dim": 2}
GRAPHS = [
    {"objects": ["cat", "tree"], "relationships": [[0, "left of", 1]]},
    {"objects": ["dog", "grass", "sky"],
     "relationships": [[0, "above", 1], [2, "near", 0]]},
    {"objects": ["tree"], "relationships": []},
]
PARTS = ("sg2im.engine.encode", "sg2im.model.forward", "sg2im.engine.fetch")
TIMEOUT = 60  # seconds, per HTTP call, server start and thread join


def _state():
    from sg2im_tpu_torch.models.sg2im import Sg2ImGenerator

    torch.manual_seed(0)
    return Sg2ImGenerator(VOCAB, **MODEL).state_dict()


@pytest.fixture(scope="module")
def engine():
    from sg2im_tpu_torch.inference import InferenceEngine

    e = InferenceEngine(VOCAB, MODEL, _state(), device="cpu")
    e.generate(GRAPHS, seed=1)
    return e


@contextlib.contextmanager
def _on():
    """Spans on: a CPU profiler session over the block, the store
    emptied first."""
    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def test_spans_are_off_without_a_profiler_session(engine):
    timing.clear_spans()
    assert not timing.spans_on()
    with timing.span("sg2im.test") as s:
        assert s is None
    timing.record_span("sg2im.test", 0, 1)
    engine.generate(GRAPHS, seed=2)
    assert timing.recorded_spans() == []


@pytest.mark.parametrize("graphs", [GRAPHS, GRAPHS[:2], GRAPHS[1]],
                         ids=["3-of-4-rows", "2-rows", "one-dict"])
def test_a_call_records_its_four_spans(engine, graphs):
    """One call under a profiler session: generate around encode, forward
    and fetch, each part inside the call and none overlapping another, so
    the call's own time (the call less its parts) is what the parts leave;
    the counters are the encoded batch's."""
    from sg2im_tpu_torch.data import encode_scene_graphs

    with _on():
        imgs, _ = engine.generate(graphs, seed=3)
    spans = timing.recorded_spans()
    assert sorted(s.name for s in spans) == sorted(
        PARTS + ("sg2im.engine.generate",))
    gen = next(s for s in spans if s.name == "sg2im.engine.generate")
    parts = sorted((s for s in spans if s is not gen),
                   key=lambda s: s.start_ns)
    assert [s.name for s in parts] == list(PARTS)
    assert gen.parent is None
    assert all(s.parent == gen.id for s in parts)
    assert gen.start_ns <= parts[0].start_ns
    for a, b in zip(parts, parts[1:]):
        assert a.end_ns <= b.start_ns
    assert parts[-1].end_ns <= gen.end_ns
    own = gen.ms - sum(s.ms for s in parts)
    assert 0 <= own <= gen.ms
    assert own + sum(s.ms for s in parts) == pytest.approx(gen.ms)

    graphs = [graphs] if isinstance(graphs, dict) else graphs
    batch = encode_scene_graphs(graphs, VOCAB, align=engine.pad_align)
    rows = engine.pad_rows(len(graphs))
    assert gen.attrs == {"objects": int(batch.obj_mask.sum()),
                         "obj_slots": rows * batch.objs.shape[1]}
    assert gen.attrs["objects"] == sum(len(g["objects"]) + 1 for g in graphs)
    assert len(imgs) == len(graphs)


def test_spans_stand_on_the_profilers_clock():
    """A span and a ``record_function`` opened right after it start within
    1 ms of each other on the profiler's absolute clock
    (``trace_start_ns() + time_range.start``), after a warm-up."""
    with _on() as prof:
        for i in range(3):
            with timing.span(f"sg2im.test.{i}"):
                with record_function(f"test.mark.{i}"):
                    pass
    start = prof.profiler.kineto_results.trace_start_ns()
    marks = {e.name: start + e.time_range.start * 1000
             for e in prof.events() if e.name.startswith("test.mark.")}
    spans = {s.name: s for s in timing.recorded_spans()}
    for i in (1, 2):
        off = marks[f"test.mark.{i}"] - spans[f"sg2im.test.{i}"].start_ns
        assert abs(off) < 1e6, off


def test_the_store_is_bounded():
    with _on():
        for i in range(timing.SPAN_STORE + 10):
            timing.record_span("sg2im.test", i, i + 1)
    spans = timing.recorded_spans()
    assert len(spans) == timing.SPAN_STORE
    assert spans[0].start_ns == 10 and spans[-1].start_ns == \
        timing.SPAN_STORE + 9
    timing.clear_spans()
    assert timing.recorded_spans() == []


@contextlib.contextmanager
def _server(tmp_path, window_ms):
    from sg2im_tpu_torch.cli.serve import build_parser, serve_forever

    ckpt = tmp_path / "tiny.pt"
    torch.save({"model_kwargs": dict(MODEL), "vocab": VOCAB,
                "model_state": _state()}, ckpt)
    args = build_parser().parse_args(
        ["--checkpoint", str(ckpt), "--device", "cpu", "--port", "0",
         "--warmup", "1", "--max_graphs", "8",
         "--batch_window_ms", str(window_ms)])
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, args=(args, ready),
                         daemon=True)
    t.start()
    assert ready.wait(timeout=TIMEOUT), "server failed to start"
    try:
        yield f"http://127.0.0.1:{ready.httpd.server_address[1]}"
    finally:
        ready.httpd.shutdown()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


def _post(base, payload):
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("window_ms", [0, 100], ids=["alone", "coalesced"])
def test_each_request_waits_in_one_queue_span_tied_to_its_call(
        tmp_path, window_ms):
    """Concurrent requests through the CPU server: one
    ``sg2im.serve.queue`` span each, ended by the drain, so that the
    engine call that served it is the first generate span to start after
    that end; every call serves at least one request, and the calls'
    objects are the requests' (one call a request without a window)."""
    sizes = [1, 2, 1, 3]
    replies = [None] * len(sizes)

    def client(i):
        replies[i] = _post(base, {"scene_graphs": GRAPHS[:sizes[i]],
                                  "seed": i})

    with _server(tmp_path, window_ms) as base, _on():
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
            time.sleep(0.005)
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    assert all(r is not None and len(r["images"]) == n
               for r, n in zip(replies, sizes))
    spans = timing.recorded_spans()
    queued = [s for s in spans if s.name == "sg2im.serve.queue"]
    gens = sorted((s for s in spans if s.name == "sg2im.engine.generate"),
                  key=lambda s: s.start_ns)
    assert len(queued) == len(sizes)
    assert all(s.ms >= 0 and s.parent is None for s in queued + gens)
    served = {}
    for q in queued:
        g = next(g for g in gens if g.start_ns >= q.end_ns)
        served.setdefault(g.id, []).append(q)
    assert set(served) == {g.id for g in gens}
    if window_ms == 0:
        assert len(gens) == len(sizes)
    else:
        assert len(gens) < len(sizes)
    objects = sum(len(g["objects"]) + 1
                  for n in sizes for g in GRAPHS[:n])
    assert sum(g.attrs["objects"] for g in gens) == objects
