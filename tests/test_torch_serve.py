"""The port's serving CLI (sg2im_tpu_torch/cli/serve.py): live HTTP round
trips on a real socket, on the CPU.

The assertions of tests/test_serve.py (the JAX server's), held by the
port's server on the learned checkpoint ``artifacts/trained_coco64.pt``:
healthz, PNG and npy replies, determinism of noise='zeros', seeds, request
validation, the batcher's coalescing and isolation, /metrics, concurrent
clients, CPU replicas, the int8 calibration flags.  Each server runs
in-process on port 0 and is shut down by its fixture; every HTTP call has
its own timeout.  Tolerances: a request answered alone equals
``engine.generate`` on the same graphs and seed bit for bit; coalesced, its
rows stay within 1 u8 level (the convolutions' sum order may depend on the
batch size); against the JAX package's engine, the u8 PSNR gate of 40 dB
that tests/test_torch_engine.py uses for this checkpoint.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "trained_coco64.pt")
GRAPHS = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")
TIMEOUT = 30  # seconds, per HTTP call and per server start

SG = {"objects": ["thing2", "ground"], "relationships": [[0, "above", 1]]}


def _graphs():
    with open(GRAPHS) as f:
        return json.load(f)


@contextlib.contextmanager
def _server(*flags):
    """A port server on the CPU, on port 0: yields (base url, ready event
    carrying .httpd and .state); shut down and joined on exit."""
    from sg2im_tpu_torch.cli.serve import build_parser, serve_forever

    args = build_parser().parse_args(
        ["--checkpoint", CKPT, "--device", "cpu", "--port", "0"]
        + list(flags))
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, args=(args, ready),
                         daemon=True)
    t.start()
    assert ready.wait(timeout=TIMEOUT), "server failed to start"
    try:
        yield f"http://127.0.0.1:{ready.httpd.server_address[1]}", ready
    finally:
        ready.httpd.shutdown()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def server():
    with _server("--warmup", "1", "--max_graphs", "4") as (base, _):
        yield base


@pytest.fixture(scope="module")
def batch_server():
    with _server("--warmup", "1", "--max_graphs", "8",
                 "--batch_window_ms", "200") as (base, ready):
        yield base, ready


def _post(base, payload, path="/generate"):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=TIMEOUT) as r:
        return r.headers, r.read()


def _refused(call, *args):
    """(HTTP code, JSON body) of a call that must fail; the reply closed."""
    with pytest.raises(urllib.error.HTTPError) as exc:
        call(*args)
    with exc.value as err:
        return err.code, json.loads(err.read())


def _healthz(base):
    return json.loads(_get(base, "/healthz")[1])


def _npy(reply, j=0):
    raw = base64.b64decode(reply["images"][j])
    return np.frombuffer(raw, np.uint8).reshape(reply["shape"])


def _concurrently(fn, args_list):
    """Run fn(*args) in one thread each; returns (results, errors)."""
    results, errors = [], []

    def one(*a):
        try:
            results.append(fn(*a))
        except Exception as e:  # noqa: BLE001 -- reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=one, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * TIMEOUT)
        assert not t.is_alive()
    return results, errors


def test_healthz(server):
    h = _healthz(server)
    assert h["status"] == "ok" and h["device"] == "cpu"
    assert h["image_size"] == [64, 64]


def test_generate_png_roundtrip(server):
    from PIL import Image

    out = _post(server, {"scene_graphs": [SG], "noise": "zeros"})
    assert len(out["images"]) == 1
    img = np.asarray(Image.open(io.BytesIO(
        base64.b64decode(out["images"][0]))))
    assert img.shape == tuple(out["shape"]) == (64, 64, 3)
    # One box per NAMED object: pads and __image__ trimmed.
    assert np.asarray(out["boxes"]).shape == (1, 2, 4)
    assert out["latency_ms"] > 0
    npy = _post(server, {"scene_graphs": [SG], "noise": "zeros",
                         "return": "npy"})
    np.testing.assert_array_equal(img, _npy(npy))


def test_build_engines_accepts_noise_impl_threefry():
    """'threefry' is the engine's own draw (the JAX package's), so the JAX
    server's flag builds the same engine as no flag."""
    from sg2im_tpu_torch.cli.serve import build_engines, build_parser

    argv = ["--checkpoint", CKPT, "--device", "cpu"]
    (engine,) = build_engines(build_parser().parse_args(
        argv + ["--noise_impl", "threefry"]))
    assert engine.noise_impl == "threefry"
    a = engine.draw_noise(2, seed=3)
    assert np.array_equal(a.numpy(), engine.draw_noise(2, seed=3).numpy())


def test_generate_zeros_deterministic_npy(server):
    a = _post(server, {"scene_graphs": [SG, SG], "noise": "zeros",
                       "return": "npy"})
    b = _post(server, {"scene_graphs": [SG, SG], "noise": "zeros",
                       "return": "npy"})
    assert a["images"] == b["images"]  # byte-identical
    assert _npy(a).shape == (64, 64, 3)
    assert a["images"][0] == a["images"][1]  # identical graphs


def test_generate_seeded_noise_changes_output(server):
    a = _post(server, {"scene_graphs": [SG], "seed": 1, "return": "npy"})
    b = _post(server, {"scene_graphs": [SG], "seed": 2, "return": "npy"})
    aa = _post(server, {"scene_graphs": [SG], "seed": 1, "return": "npy"})
    assert a["images"] != b["images"]
    assert a["images"] == aa["images"]


def test_seeded_reply_equals_engine_generate(server):
    """A request answered alone is engine.generate on the same graphs and
    seed, bit for bit (the server's engine deprocesses on the device)."""
    from sg2im_tpu_torch.inference import InferenceEngine

    graphs = _graphs()[:3]
    engine = InferenceEngine.from_torch_checkpoint(CKPT, device="cpu")
    want, out = engine.generate(graphs, seed=9)
    got = _post(server, {"scene_graphs": graphs, "seed": 9,
                         "return": "npy"})
    for j in range(3):
        np.testing.assert_array_equal(_npy(got, j), want[j])
    n_objs = [len(g["objects"]) for g in graphs]
    for j, n in enumerate(n_objs):
        np.testing.assert_array_equal(
            np.asarray(got["boxes"][j], np.float32),
            out["boxes"][j, :n].numpy())


BAD_BODIES = {
    "missing graphs": {},
    "empty graphs": {"scene_graphs": []},
    "more than --max_graphs": {"scene_graphs": [SG] * 5},
    "bad noise": {"scene_graphs": [SG], "noise": "sideways"},
    "bad format": {"scene_graphs": [SG], "return": "bmp"},
    "unintable seed": {"scene_graphs": [SG], "seed": {"a": 1}},
    "seed beyond 64 bits": {"scene_graphs": [SG], "seed": 1 << 70},
    "non-dict body": [1, 2],
    "string body": "hello",
}


@pytest.mark.parametrize("name", sorted(BAD_BODIES))
def test_request_validation(server, name):
    code, body = _refused(_post, server, BAD_BODIES[name])
    assert code == 400 and "error" in body


def test_unknown_path_is_404(server):
    assert _refused(_post, server, {"scene_graphs": [SG]}, "/nope")[0] == 404
    assert _refused(_get, server, "/nope")[0] == 404


def test_unknown_object_name_is_client_error_not_crash(server):
    code, body = _refused(_post, server, {"scene_graphs": [
        {"objects": ["not-in-vocab"], "relationships": []}]})
    assert code == 400 and "error" in body
    out = _post(server, {"scene_graphs": [SG], "noise": "zeros"})
    assert len(out["images"]) == 1  # still healthy


def test_unpinned_random_noise_varies_per_request(server):
    a = _post(server, {"scene_graphs": [SG], "return": "npy"})
    b = _post(server, {"scene_graphs": [SG], "return": "npy"})
    assert a["seed"] != b["seed"]
    assert a["images"] != b["images"]
    c = _post(server, {"scene_graphs": [SG], "return": "npy",
                       "seed": a["seed"]})
    assert c["images"] == a["images"]  # the reported seed reproduces


def test_query_strings_are_ignored_in_routing(server):
    assert json.loads(_get(server, "/healthz?probe=1")[1])["status"] == "ok"
    out = _post(server, {"scene_graphs": [SG], "noise": "zeros"},
                path="/generate?trace=1")
    assert len(out["images"]) == 1


def test_metrics_endpoint(server):
    _post(server, {"scene_graphs": [SG, SG], "noise": "zeros"})
    assert _refused(_post, server, {"scene_graphs": []})[0] == 400
    m = json.loads(_get(server, "/metrics?format=json")[1])
    assert m["requests"] >= 1 and m["images"] >= m["requests"] + 1
    assert m["errors"]["400"] >= 1
    lat = m["request_latency_ms"]
    assert lat["count"] == m["requests"]
    assert 0 < lat["p50_ms"] <= lat["p99_ms"] <= lat["max_ms"]

    headers, body = _get(server, "/metrics")
    assert headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    assert 'sg2im_request_latency_ms_bucket{le="+Inf"}' in text
    assert 'sg2im_errors_total{code="400"}' in text
    values = {line.split(" ")[0]: int(float(line.rsplit(" ", 1)[1]))
              for line in text.splitlines() if not line.startswith("#")}
    assert values["sg2im_requests_total"] >= m["requests"]
    assert values["sg2im_images_total"] >= m["images"]
    cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("sg2im_request_latency_ms_bucket")]
    assert cums == sorted(cums)
    assert cums[-1] == values["sg2im_request_latency_ms_count"] >= 1


def test_concurrent_clients(server):
    results, errors = _concurrently(
        lambda s: _post(server, {"scene_graphs": [SG], "seed": s,
                                 "return": "npy"}),
        [(s,) for s in range(6)])
    assert not errors and len(results) == 6
    assert {r["seed"] for r in results} == set(range(6))


def test_batcher_coalesces_concurrent_requests(batch_server):
    """Mixed single- and three-graph requests coalesce; each request's
    pinned seed gives the rows it gets alone (within 1 u8 level)."""
    base, ready = batch_server
    h0 = _healthz(base)
    results, errors = _concurrently(
        lambda s, n: (s, n, _post(base, {"scene_graphs": [SG] * n,
                                         "seed": s, "return": "npy"})),
        [(s, 3 if s == 2 else 1) for s in range(5)])
    assert not errors and len(results) == 5
    h1 = _healthz(base)
    assert h1["engine_calls"] - h0["engine_calls"] < 5, "no coalescing"
    assert h1["batched_requests"] > h0["batched_requests"]
    for seed, n, r in results:
        solo = _post(base, {"scene_graphs": [SG] * n, "seed": seed,
                            "return": "npy"})
        assert len(r["images"]) == n
        for j in range(n):
            diff = _npy(r, j).astype(int) - _npy(solo, j)
            assert np.abs(diff).max() <= 1
    by_seed = {s: r for s, _, r in results}
    assert by_seed[0]["images"][0] != by_seed[1]["images"][0]


def test_coalesced_noise_at_noise_downsample_2_is_the_jax_servers():
    """At --noise_downsample 2 the JAX server draws a request's noise
    otherwise coalesced than alone, and the port's server reproduces that:
    coalesced, a request's rows are the full-resolution float32
    ``normal(PRNGKey(seed), (n, H, W, D))`` passed to the engine as
    explicit noise; alone, the engine's own seeded draw at f 2.  Each is
    held to the engine called on that noise, bit for bit, and the two
    images of one seed differ."""
    import torch

    from sg2im_tpu_torch.cli.serve import (
        _Batcher,
        _Request,
        build_engines,
        build_parser,
    )
    from sg2im_tpu_torch.ops import prng

    args = build_parser().parse_args(
        ["--checkpoint", CKPT, "--device", "cpu", "--noise_downsample", "2"])
    (engine,) = build_engines(args)
    D = engine.model.layout_noise_dim
    H, W = engine.model.image_size
    assert engine.noise_downsample == 2 and D > 0
    graphs = _graphs()[:2]
    batcher = _Batcher(engine, max_graphs=8, window_ms=0)
    try:
        a, b = _Request([SG], "random", 7), _Request(graphs, "random", 8)
        batcher._run([a, b])
        alone = _Request([SG], "random", 7)
        batcher._run([alone])
    finally:
        batcher.close()
    assert a.error is None and b.error is None and alone.error is None
    full = torch.cat([prng.normal(prng.prng_key(7), (1, H, W, D)),
                      prng.normal(prng.prng_key(8), (2, H, W, D))])
    want, _ = engine.generate([SG] + graphs, noise=full)
    np.testing.assert_array_equal(a.result[0], want[:1])
    np.testing.assert_array_equal(b.result[0], want[1:])
    f2 = engine.draw_noise(1, 7).permute(0, 2, 3, 1)
    assert torch.equal(f2[:, ::2, ::2], f2[:, 1::2, 1::2])
    want_alone, _ = engine.generate([SG], noise=f2)
    np.testing.assert_array_equal(alone.result[0], want_alone)
    np.testing.assert_array_equal(alone.result[0],
                                  engine.generate([SG], seed=7)[0])
    assert np.abs(alone.result[0].astype(int) - a.result[0]).max() > 1


def test_batcher_isolates_bad_requests(batch_server):
    base, _ = batch_server
    bad = {"scene_graphs": [{"objects": ["not-in-vocab"],
                             "relationships": []}]}
    good = {"scene_graphs": [SG], "noise": "zeros"}

    def post(body):
        try:
            return _post(base, body)
        except urllib.error.HTTPError as e:
            with e:
                return e.code

    results, errors = _concurrently(post, [(bad,), (good,), (good,)])
    assert not errors
    assert sorted(r for r in results if isinstance(r, int)) == [400]
    oks = [r for r in results if isinstance(r, dict)]
    assert len(oks) == 2 and all(len(o["images"]) == 1 for o in oks)


def test_zeros_reply_matches_jax_engine(server):
    """The port's server against the JAX package's engine on the same
    checkpoint and graphs, zero noise: u8 PSNR >= 40 dB."""
    from sg2im_tpu.inference import InferenceEngine as JaxEngine

    graphs = _graphs()[:4]
    want, _ = JaxEngine.from_torch_checkpoint(CKPT).generate(graphs,
                                                             noise="zeros")
    got = _post(server, {"scene_graphs": graphs, "noise": "zeros",
                         "return": "npy"})
    got = np.stack([_npy(got, j) for j in range(4)]).astype(np.float64)
    mse = np.mean((got - want) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0


def test_replica_server_roundtrip_and_determinism():
    """--replicas 2 on the CPU: requests rotate over both engines, and a
    pinned seed gives the same bytes from either."""
    with _server("--warmup", "1", "--max_graphs", "4",
                 "--replicas", "2") as (base, ready):
        payload = {"scene_graphs": [SG], "noise": "random", "seed": 11}
        imgs = [_post(base, payload)["images"][0] for _ in range(4)]
        assert len(set(imgs)) == 1, "replicas diverged for a pinned seed"
        assert _healthz(base)["engine_calls"] == 4  # warmup not counted
        assert [b.engine_calls for b in ready.state.batcher.batchers] \
            == [2, 2]


def test_replicas_with_coalescing_window():
    with _server("--warmup", "1", "--max_graphs", "8", "--replicas", "2",
                 "--batch_window_ms", "300") as (base, ready):
        results, errors = _concurrently(
            lambda: _post(base, {"scene_graphs": [SG], "noise": "zeros"}),
            [()] * 6)
        assert not errors and len(results) == 6
        assert len({r["images"][0] for r in results}) == 1
        calls = [b.engine_calls for b in ready.state.batcher.batchers]
        assert sum(calls) < 6, f"no coalescing happened: {calls}"
        assert all(c >= 1 for c in calls), f"an idle replica: {calls}"


def test_replicas_share_first_traffic_int8_calibration():
    """--replicas 2 --quantize int8 without a calibration file: replica 0
    calibrates on the first request and both replicas then hold its
    scales and answer a pinned seed with the same bytes."""
    with _server("--warmup", "1", "--max_graphs", "8", "--replicas", "2",
                 "--quantize", "int8") as (base, ready):
        assert _healthz(base)["int8_calibrated"] is False
        _post(base, {"scene_graphs": _graphs(), "seed": 3})
        assert _healthz(base)["int8_calibrated"] is True
        e0, e1 = (b.engine for b in ready.state.batcher.batchers)
        assert e0.scales() == e1.scales()
        payload = {"scene_graphs": [SG], "seed": 5, "return": "npy"}
        assert len({_post(base, payload)["images"][0]
                    for _ in range(4)}) == 1
        assert [b.engine_calls for b in ready.state.batcher.batchers] \
            == [3, 2]


def test_calibration_file_lifecycle(tmp_path):
    """--calibrate_graphs + --save_calibration write the scales at
    startup; a server restarted with --calibration_file serves the same
    bytes for the same request."""
    graphs = str(tmp_path / "calibration_graphs.json")
    with open(graphs, "w") as f:
        json.dump(_graphs()[:4], f)
    cal = str(tmp_path / "scales.json")
    payload = {"scene_graphs": [SG], "seed": 7, "return": "npy"}
    with _server("--warmup", "1", "--quantize", "int8", "--calibrate_graphs",
                 graphs, "--save_calibration", cal) as (base, _):
        assert os.path.exists(cal)  # written at startup, before traffic
        assert _healthz(base)["int8_calibrated"] is True
        a = _post(base, payload)
    with _server("--warmup", "1", "--quantize", "int8",
                 "--calibration_file", cal) as (base, _):
        assert _healthz(base)["int8_calibrated"] is True
        b = _post(base, payload)
    assert a["images"] == b["images"]


def test_save_calibration_after_first_traffic(tmp_path):
    cal = str(tmp_path / "scales.json")
    with _server("--warmup", "1", "--quantize", "int8",
                 "--save_calibration", cal) as (base, ready):
        assert not os.path.exists(cal)  # warmup scales are discarded
        _post(base, {"scene_graphs": _graphs(), "seed": 1})
        assert os.path.exists(cal)
        with open(cal) as f:
            assert json.load(f)["scales"] == ready.state.engine.scales()


def test_startup_calibration_flag_validation():
    from sg2im_tpu_torch.cli.serve import build_parser, startup_calibration

    args = build_parser().parse_args(
        ["--checkpoint", "x.pt", "--calibration_file", "c.json"])
    with pytest.raises(SystemExit, match="quantize int8"):
        startup_calibration(args, [])
    args = build_parser().parse_args(
        ["--checkpoint", "x.pt", "--quantize", "int8",
         "--calibration_file", "c.json", "--calibrate_graphs", "g.json"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        startup_calibration(args, [])
    args = build_parser().parse_args(["--checkpoint", "x.pt"])
    assert startup_calibration(args, []) is False


def test_build_engines_flag_mapping():
    import torch

    from sg2im_tpu_torch.cli.serve import build_engines, build_parser

    def engine(*flags):
        args = build_parser().parse_args(
            ["--checkpoint", CKPT, "--device", "cpu"] + list(flags))
        (e,) = build_engines(args)
        return e

    e = engine("--bf16", "1", "--dense_precision", "highest", "--crn_mode",
               "split", "--deprocess_on_device", "0", "--quantize", "int8",
               "--noise_downsample", "2")
    assert e.model_kwargs["compute_dtype"] == torch.bfloat16
    assert e.model_kwargs["crn_mode"] == "split"
    assert e.model_kwargs["crn_quant"] == "int8"
    assert e.model_kwargs["crn_quant_max_res"] == 64  # the default band
    assert e.noise_downsample == 2
    e = engine("--quantize", "int8", "--quantize_max_res", "0",
               "--quantize_head", "0")
    assert "crn_quant_max_res" not in e.model_kwargs  # unbounded
    assert e.model_kwargs["crn_quant_head"] is False
    e = engine("--crn_mode", "phase")
    assert e.model.crn_mode == "phase"
    # defaults: f32 legacy, full-resolution noise
    e = engine()
    for k in ("compute_dtype", "crn_mode", "crn_quant"):
        assert k not in e.model_kwargs
    assert e.noise_downsample == 1
    assert e.device.type == "cpu"
    args = build_parser().parse_args(["--checkpoint", CKPT])
    assert args.device == "cuda"  # the card unless asked otherwise


REFUSED = {
    # (The first id is older than the mesh engine: the case now holds the
    # JAX server's refusal of more data rows than devices.)
    "--data_parallel names item 12": (["--device", "cuda",
                                       "--data_parallel", "64"], SystemExit,
                                      "exceeds"),
    "--data_parallel with --replicas": (["--data_parallel", "2",
                                         "--replicas", "2"], SystemExit,
                                        "mutually exclusive"),
    "--quantize_head without int8": (["--quantize_head", "1"], SystemExit,
                                     "require --quantize int8"),
    "--quantize_max_res without int8": (["--quantize_max_res", "32"],
                                        SystemExit,
                                        "require --quantize int8"),
    "--replicas 0": (["--replicas", "0"], SystemExit, ">= 1"),
    "--noise_impl rbg": (["--noise_impl", "rbg"], SystemExit,
                         "noise_impl rbg is refused.*no single reference"),
    "--dense_precision high": (["--dense_precision", "high"], SystemExit,
                               "dense_precision.*true float32"),
    "--replicas beyond the cards": (["--device", "cuda", "--replicas",
                                     "64"], SystemExit, "exceeds"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_build_engines_refusals(name):
    from sg2im_tpu_torch.cli.serve import build_engines, build_parser

    flags, exc, match = REFUSED[name]
    argv = ["--checkpoint", CKPT, "--device", "cpu"] + flags
    with pytest.raises(exc, match=match):
        build_engines(build_parser().parse_args(argv))


def test_latency_histogram_quantiles():
    from sg2im_tpu_torch.cli.serve import _LatencyHistogram

    h = _LatencyHistogram()
    assert h.to_json()["count"] == 0 and h.quantile(0.5) == 0.0
    for ms in [3.0] * 50 + [10.0] * 40 + [100.0] * 9 + [5000.0]:
        h.observe(ms)
    j = h.to_json()
    assert j["count"] == 100
    assert j["min_ms"] == 3.0 and j["max_ms"] == 5000.0
    assert abs(j["mean_ms"] - (150 + 400 + 900 + 5000) / 100) < 1e-6
    assert 2.0 < j["p50_ms"] <= 4.0
    assert 8.0 < j["p90_ms"] <= 16.0
    assert 64.0 < j["p99_ms"] <= 128.0
    assert h.quantile(1.0) <= 5000.0


def test_latency_histogram_matches_jax_server():
    from sg2im_tpu.cli.serve import _LatencyHistogram as JaxHistogram
    from sg2im_tpu_torch.cli.serve import _LatencyHistogram

    ours, theirs = _LatencyHistogram(), JaxHistogram()
    rng = np.random.RandomState(0)
    for ms in rng.lognormal(3.0, 2.0, 500):
        ours.observe(float(ms))
        theirs.observe(float(ms))
    assert ours.BOUNDS == theirs.BOUNDS
    assert ours.to_json() == theirs.to_json()


@pytest.mark.parametrize("text", ["1", "0", "true", "False", "maybe"])
def test_flag_types_match_jax_package(text):
    import argparse

    from sg2im_tpu.utils import flags as jflags
    from sg2im_tpu_torch.utils import flags

    try:
        want = jflags.bool_flag(text)
    except argparse.ArgumentTypeError:
        with pytest.raises(argparse.ArgumentTypeError):
            flags.bool_flag(text)
    else:
        assert flags.bool_flag(text) is want
    assert flags.int_tuple("1,4,16") == jflags.int_tuple("1,4,16")


def test_psnr_matches_jax_package():
    from sg2im_tpu.utils.metrics import psnr as jpsnr
    from sg2im_tpu_torch.utils.metrics import psnr

    rng = np.random.RandomState(2)
    a = rng.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    b = rng.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    assert psnr(a, b) == jpsnr(a, b)
    assert psnr(a, a) == float("inf")
    assert psnr(a / 255.0, b / 255.0, max_val=1.0) == jpsnr(
        a / 255.0, b / 255.0, max_val=1.0)
