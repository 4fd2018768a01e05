"""Serving CLI: HTTP scene-graph -> image endpoint around InferenceEngine.

Counterpart of ``sg2im_tpu/cli/serve.py``, with the same flags (plus
``--device``), the same JSON replies and the same Prometheus counters.
Load a checkpoint once, run every serving path once per bucket
(``InferenceEngine.warmup``: the kernels' nvcc build and cuDNN's first
calls happen there), then serve.  It runs on a CUDA card unless
``--device cpu`` is given.

Endpoints (stdlib ``http.server``; no extra dependencies):

  GET  /healthz    -> {"status": "ok", model/vocab/bucket info}
  GET  /metrics    -> Prometheus text exposition (request/image/error
                   counters + request-latency histogram); append
                   ``?format=json`` for a JSON view with computed
                   p50/p90/p99 quantiles
  POST /generate   body {"scene_graphs": [...same JSON schema as
                   scene_graphs/*.json...], "noise": "random"|"zeros",
                   "seed": int, "return": "png"|"npy"}
                   -> {"images": [base64 PNG or npy per graph],
                       "boxes": per graph, one [x0,y0,x1,y1] per named
                       object (pads and the implicit __image__ node are
                       trimmed), "seed": int, "latency_ms": float}

Device access is serialized with a lock (one forward at a time per
engine); several scene graphs per request are padded to power-of-two
buckets.  ``--batch_window_ms W`` also coalesces CONCURRENT requests: the
first waiting request leads, collects followers for W ms (up to
--max_graphs in all) and runs ONE forward for all of them.

Noise follows the JAX server exactly, on both of its paths:

* a request served alone runs ``engine.generate(seed=...)``, which draws
  the engine's seeded noise: ``jax.random.normal(PRNGKey(seed), (n, H / f,
  W / f, D))`` at ``--noise_downsample`` f, in the engine's noise dtype,
  nearest-upsampled to (H, W);
* a coalesced request's rows are drawn by the batcher at full resolution
  in float32, ``jax.random.normal(PRNGKey(seed), (n, H, W, D))``, whatever
  f and the engine's noise dtype, and handed to the engine as explicit
  noise, which it takes as it is (zeros for 'zeros' requests).

So at the defaults (f 1, float32) a pinned seed gives the same rows alone
and coalesced, and equal to the JAX server's.  At f > 1 (or with a
bfloat16 noise dtype) the JAX server itself draws a request's noise
differently coalesced and alone, and this server reproduces that rather
than mending it.  Rows are independent through the generator (eval-mode
norms), so batchmates don't change each other's images beyond the
convolutions' sum order (within 1 u8 level).

Example:
  python -m sg2im_tpu_torch.cli.serve --checkpoint vg128.pt --port 8041 \\
      --bf16 1 --crn_mode split --warmup 1,16 --batch_window_ms 5 &
  curl -s localhost:8041/generate -d '{"scene_graphs": [
      {"objects": ["sheep", "grass"],
       "relationships": [[0, "by", 1]]}]}' | python -m json.tool
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from sg2im_tpu_torch.models.sg2im import CRN_MODES
from sg2im_tpu_torch.utils.flags import bool_flag, int_tuple
from sg2im_tpu_torch.utils.timing import record_span, spans_on


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="reference-layout .pt checkpoint")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine ('cuda' fails without "
                        "a card rather than running on the CPU); with "
                        "--replicas N on a card, cuda:0 .. cuda:N-1")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8041, type=int)
    p.add_argument("--warmup", default="1", type=int_tuple,
                   help="comma list of batch-size buckets to run once at "
                        "startup (e.g. 1,4,16)")
    p.add_argument("--bf16", default=False, type=bool_flag,
                   help="bf16 CRN serving mode")
    p.add_argument("--dense_precision", default=None,
                   choices=[None, "high", "highest"],
                   help="the JAX server's Dense precision; only 'highest' "
                        "is accepted (and changes nothing): the GCN and "
                        "heads always run in true float32")
    p.add_argument("--crn_mode", default=None, choices=(None,) + CRN_MODES,
                   help="CRN formulation: 'split' skips the CRN concat, "
                        "'phase' and 'packed' run stages in the packed "
                        "domain, 'split_noise' gives the noise its own "
                        "pyramid")
    p.add_argument("--quantize", default=None, choices=[None, "int8"],
                   help="TURBO tier: int8 kernel for the high-res CRN stage "
                        "convs (an accuracy trade; checkpoints unaffected)")
    p.add_argument("--quantize_head", default=None, type=bool_flag,
                   help="int8 tier: quantize the CRN output head's 3x3.  "
                        "Default: the engine's band (the head is exempt "
                        "whenever its input stage is)")
    p.add_argument("--quantize_max_res", default=None, type=int,
                   help="int8 tier: only quantize CRN stages whose layout "
                        "resolution is <= this.  Default 64; 0 or "
                        "negative = unbounded")
    p.add_argument("--calibration_file", default=None,
                   help="int8 tier: load activation scales saved by "
                        "--save_calibration (either package's format) at "
                        "startup: no first-traffic auto-calibration, "
                        "restarts serve identical bytes")
    p.add_argument("--calibrate_graphs", default=None,
                   help="int8 tier: path to a scene-graphs JSON (same "
                        "schema as /generate) to calibrate on at startup")
    p.add_argument("--save_calibration", default=None,
                   help="int8 tier: write the activation scales to this "
                        "path once calibrated (at startup with "
                        "--calibrate_graphs, else after the first-traffic "
                        "auto-calibration)")
    p.add_argument("--noise_impl", default=None,
                   choices=[None, "threefry", "rbg"],
                   help="PRNG of the per-request noise: 'threefry' (the "
                        "default, the JAX package's draws); 'rbg' is "
                        "refused (XLA's RngBitGenerator has no single "
                        "reference to match)")
    p.add_argument("--noise_downsample", default=1, type=int,
                   choices=[1, 2, 4],
                   help="draw per-request layout noise at (H/f, W/f) and "
                        "nearest-upsample on the device (the noise becomes "
                        "block-constant over fxf tiles)")
    p.add_argument("--deprocess_on_device", default=True, type=bool_flag,
                   help="accepted and ignored, so that the JAX server's "
                        "command lines stay valid: the engine always "
                        "deprocesses on its device (uint8 out, bytes equal "
                        "to the host deprocess)")
    p.add_argument("--max_graphs", default=64, type=int,
                   help="reject requests with more scene graphs (bounds "
                        "device memory)")
    p.add_argument("--batch_window_ms", default=0.0, type=float,
                   help="coalesce concurrent requests into one forward: "
                        "the leading request waits this long for followers "
                        "(0 = serve each request individually)")
    p.add_argument("--data_parallel", default=0, type=int,
                   help="serve ONE engine over a mesh of N data rows, one "
                        "card each (parallel.mesh.make_mesh(n_data=N)): "
                        "each coalesced batch splits over the cards, each "
                        "row on its own worker thread; exclusive with "
                        "--replicas.  With --device cpu the rows share the "
                        "CPU")
    p.add_argument("--replicas", default=1, type=int,
                   help="run N independent engine replicas, one per card, "
                        "and dispatch whole requests round-robin; each "
                        "replica coalesces its own queue under "
                        "--batch_window_ms.  With --device cpu the N "
                        "engines share the CPU")
    return p


def build_engines(args):
    """Engine(s) for the flag set: one engine, or N replicas
    (``--replicas``) from one read of the checkpoint."""
    import torch

    from sg2im_tpu_torch.ckpt import load_reference_checkpoint
    from sg2im_tpu_torch.inference import RBG_REFUSED, InferenceEngine

    # The JAX server's precision knob has no other torch counterpart, and
    # its 'rbg' PRNG no reference.
    if args.dense_precision not in (None, "highest"):
        raise SystemExit(
            f"--dense_precision {args.dense_precision} is refused: the GCN "
            "and heads run in true float32 (TF32 off), which is 'highest'")
    if args.noise_impl == "rbg":
        raise SystemExit(f"--noise_impl rbg is refused: {RBG_REFUSED}")
    kw = {}
    if args.noise_impl:
        kw["noise_impl"] = args.noise_impl
    if args.bf16:
        kw["compute_dtype"] = torch.bfloat16
    if args.crn_mode and args.crn_mode != "legacy":
        kw["crn_mode"] = args.crn_mode
    if args.quantize:
        kw["quantize"] = args.quantize
        qo = {}
        if args.quantize_head is not None:
            qo["head"] = args.quantize_head
        if args.quantize_max_res is not None:
            # 0 / negative = unbounded (None = the model default).
            qo["max_res"] = (args.quantize_max_res
                             if args.quantize_max_res > 0 else None)
        if qo:
            kw["quant_opts"] = qo
    elif args.quantize_head is not None or args.quantize_max_res is not None:
        raise SystemExit(
            "--quantize_head/--quantize_max_res require --quantize int8")
    if args.noise_downsample != 1:
        kw["noise_downsample"] = args.noise_downsample
    n_rep = args.replicas
    if n_rep < 1:
        raise SystemExit(f"--replicas must be >= 1, got {n_rep}")
    device = torch.device(args.device)
    if args.data_parallel > 1:
        from sg2im_tpu_torch.parallel.mesh import make_mesh

        if n_rep > 1:
            raise SystemExit(
                "--replicas and --data_parallel are mutually exclusive "
                "(per-card replicas vs one mesh-sharded engine)")
        n = args.data_parallel
        if device.type == "cuda":
            n_dev = torch.cuda.device_count()
            if n > n_dev:
                raise SystemExit(f"--data_parallel {n} exceeds the {n_dev} "
                                 f"available CUDA device(s)")
            mesh = make_mesh(n_data=n)
        else:
            mesh = make_mesh(n_data=n, devices=[device] * n)
        return [InferenceEngine.from_torch_checkpoint(
            args.checkpoint, mesh=mesh, **kw)]
    if n_rep == 1:
        return [InferenceEngine.from_torch_checkpoint(
            args.checkpoint, device=device, **kw)]
    if device.type == "cuda":
        n_dev = torch.cuda.device_count()
        if n_rep > n_dev:
            raise SystemExit(f"--replicas {n_rep} exceeds the {n_dev} "
                             f"available CUDA device(s)")
        devices = [torch.device("cuda", i) for i in range(n_rep)]
    else:
        devices = [device] * n_rep
    bundle = load_reference_checkpoint(args.checkpoint)  # read ONCE
    return [InferenceEngine.from_bundle(bundle, device=d, **kw)
            for d in devices]


def share_calibration(engines):
    """Copy engine 0's int8 scales to every other replica, so that all of
    them run the same static program and a request's bytes do not depend
    on where it was routed."""
    scales = engines[0].scales()
    for e in engines[1:]:
        e.set_calibration(scales)


def startup_calibration(args, engines):
    """Apply the int8 calibration-file flags before warmup.

    --calibration_file loads saved scales into every engine;
    --calibrate_graphs calibrates engine 0 on a scene-graphs JSON and
    copies the scales to the other replicas; --save_calibration writes the
    scales now if either produced them (otherwise the first-traffic hook in
    _State writes them later).  Returns True if a save happened."""
    cf, cg, sv = (args.calibration_file, args.calibrate_graphs,
                  args.save_calibration)
    if not (cf or cg or sv):
        return False
    if args.quantize != "int8":
        raise SystemExit(
            "--calibration_file/--calibrate_graphs/--save_calibration "
            "require --quantize int8")
    if cf and cg:
        raise SystemExit(
            "--calibration_file and --calibrate_graphs are mutually "
            "exclusive (load saved scales OR measure fresh ones)")
    if cf:
        for e in engines:
            e.load_calibration(cf)
        print(f"loaded int8 calibration from {cf}", flush=True)
    elif cg:
        with open(cg) as f:
            sgs = json.load(f)
        if isinstance(sgs, dict):
            sgs = [sgs]
        engines[0].calibrate(sgs)
        share_calibration(engines)
        print(f"calibrated int8 scales on {len(sgs)} scene graph(s) "
              f"from {cg}", flush=True)
    if sv and engines[0].calibrated:
        engines[0].save_calibration(sv)
        print(f"saved int8 calibration to {sv}", flush=True)
        return True
    return False


def _png_bytes(img_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="PNG")
    return buf.getvalue()


class _LatencyHistogram:
    """Thread-safe fixed-bucket latency histogram (milliseconds).

    Log2-spaced upper bounds from 1 ms to ~131 s.  Quantiles are estimated
    by linear interpolation inside the winning bucket (exact min/max are
    tracked separately), the Prometheus ``histogram_quantile`` estimator:
    good to within one bucket's width, with no per-request allocation.
    """

    BOUNDS = tuple(float(2 ** i) for i in range(18))  # 1ms .. 131072ms

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.BOUNDS) + 1)  # +overflow
        self.count = 0
        self.sum_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0

    def observe(self, ms: float):
        i = 0
        while i < len(self.BOUNDS) and ms > self.BOUNDS[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum_ms += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)

    def snapshot(self):
        with self._lock:
            return (list(self._counts), self.count, self.sum_ms,
                    self.min_ms, self.max_ms)

    def quantile(self, q: float, counts=None, total=None,
                 max_ms=None) -> float:
        """Interpolated q-quantile in ms (0 when empty).  With snapshot
        counts, ``max_ms`` must be the same snapshot's max, so that the
        result never exceeds it."""
        if counts is None:
            counts, total, _, _, max_ms = self.snapshot()
        if max_ms is None:
            max_ms = self.max_ms
        if not total:
            return 0.0
        rank = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                lo = self.BOUNDS[i - 1] if i > 0 else 0.0
                hi = (self.BOUNDS[i] if i < len(self.BOUNDS)
                      else max_ms)
                frac = (rank - seen) / c
                return min(lo + frac * (hi - lo), max_ms)
            seen += c
        return max_ms

    def to_json(self):
        counts, total, sum_ms, mn, mx = self.snapshot()
        return {
            "count": total,
            "mean_ms": round(sum_ms / total, 3) if total else 0.0,
            "min_ms": round(mn, 3) if total else 0.0,
            "max_ms": round(mx, 3),
            "p50_ms": round(self.quantile(0.5, counts, total, mx), 3),
            "p90_ms": round(self.quantile(0.9, counts, total, mx), 3),
            "p99_ms": round(self.quantile(0.99, counts, total, mx), 3),
        }


class _Request:
    """One in-flight /generate request inside the batcher."""

    __slots__ = ("sgs", "noise_mode", "seed", "done", "result", "error",
                 "queued")

    def __init__(self, sgs, noise_mode, seed):
        self.sgs = sgs
        self.noise_mode = noise_mode
        self.seed = seed
        self.done = threading.Event()
        self.result = None  # (imgs ndarray, boxes ndarray)
        self.error = None
        self.queued = None  # time.time_ns() of its queueing, spans on


def _boxes(out) -> np.ndarray:
    return out["boxes"].float().cpu().numpy()


class _Batcher:
    """Coalesces concurrent requests into one padded forward.

    Leader election by device lock: the thread that wins the lock sleeps
    ``window_ms`` to collect followers, drains the queue (respecting the
    ``max_graphs`` bound), has ONE ``engine.generate`` run over the
    concatenated scene graphs, and distributes slices.  Each request's
    noise rows are its own seed's draws (``engine.draw_noise``, one launch
    of the threefry kernel each), exactly what an unbatched call would
    have used.

    Every engine call (warmup included) runs on the batcher's one
    ``worker`` thread: cuDNN's execution plans are cached per thread, and
    http.server handles each request in a new thread, where a forward
    would build every convolution's plan again (about 0.1 s per request at
    vg128 on an H100).

    While spans are on (``utils.timing``), each request records
    ``sg2im.serve.queue`` from its arrival to the drain that takes it
    (without a window, to the device lock won); the engine's generate
    span that serves it is the first to start after that end.
    """

    def __init__(self, engine, max_graphs: int, window_ms: float):
        self.engine = engine
        self.max_graphs = max_graphs
        self.window_s = max(0.0, window_ms) / 1e3
        self.worker = ThreadPoolExecutor(1, thread_name_prefix="sg2im-engine")
        self.device_lock = threading.Lock()
        self.queue_lock = threading.Lock()
        self.pending: list[_Request] = []
        self.engine_calls = 0
        self.batched_requests = 0

    def close(self):
        self.worker.shutdown()
        self.engine.close()

    def submit(self, sgs, noise_mode: str, seed: int):
        """Blocks until served.  Returns (imgs, boxes); raises the
        request's own error (batchmates are unaffected)."""
        req = _Request(sgs, noise_mode, seed)
        if spans_on():
            req.queued = time.time_ns()
        if self.window_s <= 0:
            with self.device_lock:
                self._serve([req])
        else:
            with self.queue_lock:
                self.pending.append(req)
            with self.device_lock:
                if not req.done.is_set():  # we lead
                    time.sleep(self.window_s)
                    self._serve(self._drain(must_include=req))
        if req.error is not None:
            raise req.error
        return req.result

    def _drain(self, must_include: _Request) -> list[_Request]:
        """Pop queued requests up to the max_graphs bound: the leader
        first, then FIFO; every request is sliced back out by its own
        offsets."""
        with self.queue_lock:
            self.pending.remove(must_include)
            take, total = [must_include], len(must_include.sgs)
            rest = []
            for r in self.pending:
                if total + len(r.sgs) <= self.max_graphs:
                    take.append(r)
                    total += len(r.sgs)
                else:
                    rest.append(r)
            self.pending = rest
            return take

    def _serve(self, reqs):
        """One call over ``reqs`` on the worker, the device lock held;
        ends the requests' queue spans."""
        if spans_on():
            now = time.time_ns()
            for r in reqs:
                if r.queued is not None:
                    record_span("sg2im.serve.queue", r.queued, now)
        self.worker.submit(self._run, reqs).result()

    def _merged_noise(self, reqs):
        """Explicit (n, H, W, D) float32 noise for the merged batch, on the
        engine's device, as the JAX server's ``_merged_noise`` gives it:
        each 'random' request's full-resolution float32 rows
        ``normal(PRNGKey(seed), (n, H, W, D))`` whatever the engine's
        ``noise_downsample`` and ``noise_dtype``, zeros for 'zeros'.  None
        when the model is noiseless."""
        import torch

        from sg2im_tpu_torch.ops.prng import prng_key
        from sg2im_tpu_torch.ops.prng_kernel import threefry_normal

        e = self.engine
        D = e.model.layout_noise_dim
        if D == 0:
            return None
        H, W = e.model.image_size
        rows = [torch.zeros((len(r.sgs), D, H, W), device=e.device)
                if r.noise_mode == "zeros" else threefry_normal(
                    prng_key(r.seed), (len(r.sgs), D, H, W), f=1,
                    dtype=torch.float32, device=e.device,
                    memory_format=torch.channels_last)
                for r in reqs]
        return torch.cat(rows).permute(0, 2, 3, 1)

    def _validate(self, reqs):
        """Encode each request's graphs alone, so that a client error
        (unknown object/predicate name, bad relationship endpoint) fails
        that request WITHOUT poisoning the merged call of its batchmates.
        Returns the valid subset."""
        from sg2im_tpu_torch.data import encode_scene_graphs

        good = []
        for r in reqs:
            try:
                encode_scene_graphs(r.sgs, self.engine.vocab)
                good.append(r)
            except Exception as e:  # noqa: BLE001 — belongs to this req
                r.error = e
                r.done.set()
        return good

    def _run(self, reqs):
        if not reqs:
            return
        if len(reqs) == 1:
            r = reqs[0]
            try:
                imgs, out = self.engine.generate(
                    r.sgs, noise=None if r.noise_mode == "random"
                    else "zeros", seed=r.seed)
                r.result = (imgs, _boxes(out))
            except Exception as e:  # noqa: BLE001 — belongs to this req
                r.error = e
            self.engine_calls += 1
            r.done.set()
            return
        reqs = self._validate(reqs)
        if len(reqs) <= 1:
            return self._run(reqs)
        try:
            all_sgs = [g for r in reqs for g in r.sgs]
            imgs, out = self.engine.generate(
                all_sgs, noise=self._merged_noise(reqs))
            boxes = _boxes(out)
            self.engine_calls += 1
            self.batched_requests += len(reqs)
            ofs = 0
            for r in reqs:
                n = len(r.sgs)
                r.result = (imgs[ofs:ofs + n], boxes[ofs:ofs + n])
                ofs += n
                r.done.set()
        except Exception:  # noqa: BLE001 — each request runs on its own
            # Unexpected merged failure (validation already filtered
            # client errors): isolate by serving each individually.
            for r in reqs:
                self._run([r])


class _Dispatcher:
    """Round-robin front for engine replicas: each replica gets its own
    :class:`_Batcher` (device lock + coalescing queue), and whole requests
    rotate across them.  Same-seed reproducibility holds across replicas
    of one device type: every replica runs the same forward on the same
    weights.

    int8 tier: the calibration is shared, not per replica.  The FIRST
    request goes to replica 0 (concurrent arrivals wait behind it), whose
    engine calibrates on that batch; its scales are then copied to every
    replica before normal dispatch resumes."""

    def __init__(self, engines, max_graphs: int, window_ms: float):
        self.batchers = [_Batcher(e, max_graphs, window_ms)
                         for e in engines]
        self.window_ms = window_ms
        self._next = 0
        self._lock = threading.Lock()
        self._cal_lock = threading.Lock()
        self._needs_cal = any(
            e.model_kwargs.get("crn_quant") is not None and not e.calibrated
            for e in engines)

    def submit(self, sgs, noise_mode: str, seed: int):
        if self._needs_cal:
            with self._cal_lock:
                if self._needs_cal:
                    # Calibration request: replica 0 records the scales on
                    # this batch (its output is a valid turbo response),
                    # then every replica gets a copy.
                    result = self.batchers[0].submit(sgs, noise_mode, seed)
                    if self.batchers[0].engine.calibrated:
                        share_calibration([b.engine for b in self.batchers])
                        self._needs_cal = False
                    return result
        with self._lock:
            n = len(self.batchers)
            start = self._next
            self._next = (self._next + 1) % n
            b = self.batchers[start]
            if self.window_ms <= 0:
                # No coalescing: prefer the first idle replica over a busy
                # one (locked() is a heuristic read; worst case plain
                # round-robin).  With a window, joining a busy replica's
                # queue is how requests coalesce.
                for k in range(n):
                    cand = self.batchers[(start + k) % n]
                    if not cand.device_lock.locked():
                        b = cand
                        break
        return b.submit(sgs, noise_mode, seed)

    @property
    def engine_calls(self):
        return sum(b.engine_calls for b in self.batchers)

    @property
    def batched_requests(self):
        return sum(b.batched_requests for b in self.batchers)


class _State:
    """Engine(s) + batcher/dispatcher + counters shared across handler
    threads."""

    def __init__(self, engine, max_graphs: int, window_ms: float = 0.0,
                 save_calibration: str | None = None):
        engines = engine if isinstance(engine, (list, tuple)) else [engine]
        self.engines = list(engines)
        self.engine = self.engines[0]
        self.max_graphs = max_graphs
        # --save_calibration without startup calibration: write the scales
        # once the first-traffic auto-calibration records them.
        self.save_calibration_path = save_calibration
        self._calibration_saved = False
        if len(self.engines) > 1:
            self.batcher = _Dispatcher(self.engines, max_graphs, window_ms)
            self.batchers = self.batcher.batchers
        else:
            self.batcher = _Batcher(self.engine, max_graphs, window_ms)
            self.batchers = [self.batcher]
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.images = 0
        self.latency = _LatencyHistogram()
        self.errors = {"400": 0, "404": 0, "500": 0}
        # Per-request seed stream for unpinned 'random' noise; starts at a
        # process-random offset so that restarts don't replay the stream.
        self._seed_iter = random.SystemRandom().randrange(1 << 31)

    def close(self):
        for b in self.batchers:
            b.close()

    def next_seed(self) -> int:
        with self._stats_lock:
            self._seed_iter = (self._seed_iter + 1) % (1 << 31)
            return self._seed_iter

    def count(self, n_images: int):
        with self._stats_lock:
            self.requests += 1
            self.images += n_images

    def count_error(self, code: int):
        with self._stats_lock:
            key = str(code)
            self.errors[key] = self.errors.get(key, 0) + 1

    def maybe_save_calibration(self):
        """First-traffic hook for --save_calibration: once the int8 tier
        has calibrated, write the scales exactly once."""
        if not self.save_calibration_path or self._calibration_saved:
            return
        e = self.engine
        if e.model_kwargs.get("crn_quant") is None or not e.calibrated:
            return
        with self._stats_lock:
            if self._calibration_saved:
                return
            self._calibration_saved = True
        e.save_calibration(self.save_calibration_path)
        print(f"saved int8 calibration to {self.save_calibration_path}",
              flush=True)

    def stats_snapshot(self):
        """(requests, images, errors) read under the lock that count() and
        count_error() write under."""
        with self._stats_lock:
            return self.requests, self.images, dict(self.errors)

    def prometheus_text(self) -> str:
        """Prometheus 0.0.4 text exposition of the serving counters."""
        counts, total, sum_ms, _, _ = self.latency.snapshot()
        requests, images, errors = self.stats_snapshot()
        lines = [
            "# HELP sg2im_requests_total Served /generate requests.",
            "# TYPE sg2im_requests_total counter",
            f"sg2im_requests_total {requests}",
            "# HELP sg2im_images_total Images generated.",
            "# TYPE sg2im_images_total counter",
            f"sg2im_images_total {images}",
            "# HELP sg2im_engine_calls_total Engine forwards.",
            "# TYPE sg2im_engine_calls_total counter",
            f"sg2im_engine_calls_total {self.batcher.engine_calls}",
            "# HELP sg2im_batched_requests_total Requests served by a "
            "coalesced forward.",
            "# TYPE sg2im_batched_requests_total counter",
            f"sg2im_batched_requests_total "
            f"{self.batcher.batched_requests}",
            "# HELP sg2im_errors_total Error responses by HTTP code.",
            "# TYPE sg2im_errors_total counter",
        ]
        for code in sorted(errors):
            lines.append(
                f'sg2im_errors_total{{code="{code}"}} {errors[code]}')
        lines += [
            "# HELP sg2im_request_latency_ms End-to-end /generate "
            "latency (request receipt to response build).",
            "# TYPE sg2im_request_latency_ms histogram",
        ]
        cum = 0
        for bound, c in zip(self.latency.BOUNDS, counts):
            cum += c
            lines.append(
                f'sg2im_request_latency_ms_bucket{{le="{bound:g}"}} '
                f"{cum}")
        lines.append(
            f'sg2im_request_latency_ms_bucket{{le="+Inf"}} {total}')
        lines.append(f"sg2im_request_latency_ms_sum {sum_ms:.3f}")
        lines.append(f"sg2im_request_latency_ms_count {total}")
        return "\n".join(lines) + "\n"


def make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        # quieter than the default (one line per request to stderr)
        def log_message(self, fmt, *a):  # pragma: no cover
            pass

        def _reply(self, code: int, payload: dict):
            if code >= 400:
                state.count_error(code)
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str):
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            path = path.rstrip("/")
            if path == "/metrics":
                fmt = parse_qs(query).get("format", [""])[0]
                if fmt == "json":
                    requests, images, errors = state.stats_snapshot()
                    return self._reply(200, {
                        "requests": requests,
                        "images": images,
                        "engine_calls": state.batcher.engine_calls,
                        "batched_requests":
                            state.batcher.batched_requests,
                        "errors": errors,
                        "request_latency_ms": state.latency.to_json(),
                    })
                return self._reply_text(200, state.prometheus_text())
            if path not in ("/healthz", ""):
                return self._reply(404, {"error": "unknown path"})
            e = state.engine
            requests, images, _ = state.stats_snapshot()
            payload = {
                "status": "ok",
                "device": str(e.device),
                "image_size": list(e.model_kwargs.get("image_size",
                                                      (64, 64))),
                "num_objects": len(e.vocab["object_idx_to_name"]),
                "num_predicates": len(e.vocab["pred_idx_to_name"]),
                "requests": requests,
                "images": images,
                "engine_calls": state.batcher.engine_calls,
                "batched_requests": state.batcher.batched_requests,
            }
            if e.model_kwargs.get("crn_quant") is not None:
                payload["int8_calibrated"] = all(
                    x.calibrated for x in state.engines)
            return self._reply(200, payload)

        def do_POST(self):
            if self.path.split("?")[0].rstrip("/") != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                sgs = req.get("scene_graphs")
                if not isinstance(sgs, list) or not sgs:
                    raise ValueError("'scene_graphs' must be a non-empty "
                                     "list of scene-graph dicts")
                if len(sgs) > state.max_graphs:
                    raise ValueError(
                        f"{len(sgs)} graphs > --max_graphs "
                        f"{state.max_graphs}")
                noise = req.get("noise", "random")
                if noise not in ("random", "zeros"):
                    raise ValueError("'noise' must be 'random' or 'zeros'")
                # Unpinned 'random' draws a fresh seed per request;
                # pinning 'seed' makes the response reproducible.
                seed = req.get("seed")
                seed = state.next_seed() if seed is None else int(seed)
                fmt = req.get("return", "png")
                if fmt not in ("png", "npy"):
                    raise ValueError("'return' must be 'png' or 'npy'")
            except (ValueError, KeyError, TypeError, AttributeError,
                    json.JSONDecodeError) as err:
                return self._reply(400, {"error": str(err)})

            t0 = time.perf_counter()
            try:
                imgs, boxes = state.batcher.submit(sgs, noise, seed)
            except ValueError as err:
                # scene-graph encoding errors (unknown object/predicate
                # name, bad relationship endpoint, a seed out of range)
                # are client errors
                return self._reply(400, {"error": str(err)})
            except Exception as err:  # noqa: BLE001 -- surface to client
                return self._reply(500, {"error": repr(err)})
            latency_ms = (time.perf_counter() - t0) * 1000.0
            state.latency.observe(latency_ms)

            if fmt == "png":
                payload_imgs = [
                    base64.b64encode(_png_bytes(img)).decode("ascii")
                    for img in imgs]
            else:
                payload_imgs = [
                    base64.b64encode(np.ascontiguousarray(img).tobytes())
                    .decode("ascii") for img in imgs]
            state.count(len(sgs))
            state.maybe_save_calibration()
            # boxes: per graph, one [x0,y0,x1,y1] per NAMED object (the
            # encoder appends the __image__ node and pads the object dim
            # to a bucket; both trimmed so that the reply's shape depends
            # only on the client's own graphs).
            boxes_out = [boxes[j][:len(sg.get("objects", []))].tolist()
                         for j, sg in enumerate(sgs)]
            return self._reply(200, {
                "images": payload_imgs,
                "format": fmt,
                "seed": seed,
                "shape": list(imgs.shape[1:]),
                "boxes": boxes_out,
                "latency_ms": round(latency_ms, 2),
            })

    return Handler


def serve_forever(args, ready_event=None):
    """Build engine(s), warm buckets, serve.  ``ready_event`` (tests) is set
    once the socket is listening and warmup finished; it then carries the
    server (``.httpd``, stopped with ``.shutdown()``) and its ``.state``."""
    engines = build_engines(args)
    saved = startup_calibration(args, engines)
    state = _State(engines, args.max_graphs,
                   window_ms=args.batch_window_ms,
                   save_calibration=None if saved else args.save_calibration)
    try:
        if args.warmup:
            print(f"warming buckets {list(args.warmup)} ...", flush=True)
            # On each engine's worker thread, all replicas at once.
            warm = [b.worker.submit(b.engine.warmup, tuple(args.warmup))
                    for b in state.batchers]
            for i, (b, shapes) in enumerate(zip(state.batchers, warm)):
                tag = (f" replica {i} ({b.engine.device})"
                       if len(engines) > 1 else "")
                print(f"warmed padded shapes{tag}: {shapes.result()}",
                      flush=True)
        httpd = ThreadingHTTPServer((args.host, args.port),
                                    make_handler(state))
    except BaseException:
        state.close()
        raise
    if ready_event is not None:
        ready_event.httpd = httpd
        ready_event.state = state
        ready_event.set()
    print(f"serving on http://{args.host}:{httpd.server_address[1]}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        httpd.server_close()
        state.close()
    return 0


def main(argv=None):
    return serve_forever(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
