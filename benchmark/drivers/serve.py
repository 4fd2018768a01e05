"""The server's coalescing path: ``cli/serve.py``'s own set-up
(``serve_forever``: the checkpoint read, the engine, the bucket warm-up),
then requests submitted in-process to ``state.batcher.submit(graphs,
'random', seed)``, the call ``/generate`` makes, from client threads on an
open-loop Poisson schedule fixed by the seed.  Each request is timed from
its due time to its reply, so a stall counts against every request due
behind it.

Traffic keys: ``rate`` (requests/s), ``sizes`` ({graphs: probability}),
``pool`` (distinct graphs), ``min_objects``, ``max_objects``, ``clients``
(threads), ``server_args`` (the server's flags beside the
configuration's precision and CRN mode), ``sample_requests``
(compared, drawn from the seed, with the largest), ``grace_s`` (how long a
request due in the window may take past its close), ``trace_seconds``,
``ref_block``.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark.drivers import generate as gen_driver
from benchmark.harness import device, inputs
from benchmark.reference import generator as ref


def schedule(traffic, r: np.random.Generator, seconds: float, pool: int):
    """(due times, sizes, graph indices) of the requests due in
    ``seconds``: exponential gaps at the traffic's rate, sizes and graphs
    drawn from the seed."""
    rate = traffic["rate"]
    n = int(rate * seconds * 1.5) + 64
    due = np.cumsum(r.exponential(1.0 / rate, n))
    due = due[due < seconds]
    sizes = np.array([int(k) for k in traffic["sizes"]])
    p = np.array([traffic["sizes"][k] for k in traffic["sizes"]], float)
    size = r.choice(sizes, len(due), p=p / p.sum())
    picks = [r.integers(0, pool, s) for s in size]
    return due, size, picks


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.device = ctx.device

    def setup(self, extra_args=()):
        from sg2im_tpu_torch.cli import serve

        cfg, tr, seed = self.cfg, self.traffic, self.ctx.seed
        self.tmp = tempfile.mkdtemp(prefix="benchmark-serve-")
        ckpt = os.path.join(self.tmp, "generator.pt")
        W = inputs.make_weights(ref.spec(cfg), seed, "g", self.device)
        torch.save({"model_kwargs": dict(cfg["model"]),
                    "vocab": inputs.vocab(cfg),
                    "model_state": {k: v.cpu() for k, v in W.items()}},
                   ckpt)
        del W
        args = serve.build_parser().parse_args(
            ["--checkpoint", ckpt, "--device", str(self.device),
             "--host", "127.0.0.1", "--port", "0",
             "--bf16", str(int(cfg["serving"]["compute_dtype"] == "bfloat16")),
             "--crn_mode", cfg["serving"]["crn_mode"], *tr["server_args"],
             *extra_args])
        self.ready = threading.Event()
        self.server = threading.Thread(target=serve.serve_forever,
                                       args=(args, self.ready), daemon=True)
        self.server.start()
        while not self.ready.wait(1.0):
            if not self.server.is_alive():
                raise RuntimeError("the server ended during its set-up")
        self.batcher = self.ready.state.batcher
        self.engine = self.ready.state.engine
        r = inputs.rng(seed, "graphs")
        self.graphs = inputs.scene_graphs(cfg, tr, r, tr["pool"])
        self.seeds = inputs.call_seeds(seed, tr["max_requests"])
        self._warm()
        self.sent = 0

    def _warm(self):
        """Every shape the traffic reaches, on the engine's worker thread
        (cuDNN keeps its plans per thread): each pad bucket of the merged
        batch, at each object and triple padding the pool's graphs give, on
        the merged path (explicit noise) and on the path of a request
        alone (seeded)."""
        H, W = self.cfg["model"]["image_size"]
        D = self.cfg["model"]["layout_noise_dim"]
        by_size: dict[int, dict] = {}
        for g in self.graphs:
            by_size.setdefault(len(g["objects"]), g)
        largest = max(int(k) for k in self.traffic["sizes"])
        limit = self.engine.pad_rows(int(self.ready.state.max_graphs))
        buckets = [1 << i for i in range(limit.bit_length())]
        for k, g in sorted(by_size.items()):
            for n in buckets:
                graphs = [g] * n
                noise = np.zeros((n, H, W, D), np.float32)
                run = self.batcher.worker.submit
                run(self.engine.generate, graphs, noise=noise).result()
                if n <= largest:
                    run(self.engine.generate, graphs, seed=1).result()
        device.sync(self.device)

    def _drive(self, seconds, stream_offset, keep=None):
        """An open-loop stretch of ``seconds``: every request due in it is
        sent at its due time by a free client thread and timed from then to
        its reply.  -> (latencies ms, sizes, requests missing, the
        generator's worst lateness in seconds); the replies of the requests
        ``keep(n, sizes)`` names stay in ``self.last``."""
        r = inputs.rng(self.ctx.seed + stream_offset, "arrivals")
        due, size, picks = schedule(self.traffic, r, seconds,
                                    len(self.graphs))
        n = len(due)
        lat = np.full(n, np.inf)
        late = np.zeros(n)
        kept = {}
        nxt = [0]
        lock = threading.Lock()
        base = self.sent
        t0 = time.perf_counter() + 0.05

        def client():
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= n:
                    return
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                late[i] = time.perf_counter() - (t0 + due[i])
                graphs = [self.graphs[j] for j in picks[i]]
                try:
                    res = self.batcher.submit(graphs, "random",
                                              self.seeds[base + i])
                    lat[i] = (time.perf_counter() - (t0 + due[i])) * 1e3
                    if keep is not None and i in keep(n, size):
                        kept[i] = res
                except Exception as exc:  # noqa: BLE001 — counted as failed
                    print(f"request {i} failed: {exc!r}", file=sys.stderr)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(self.traffic["clients"])]
        for t in threads:
            t.start()
        end = t0 + seconds + self.traffic["grace_s"]
        for t in threads:
            t.join(max(0.0, end - time.perf_counter()))
        # A request that failed or never came back counts as missing,
        # timed to the moment the run gave up on it.
        missing = ~np.isfinite(lat)
        lat[missing] = (time.perf_counter() - (t0 + due[missing])) * 1e3
        self.sent += n
        self.last = {"due": due, "size": size, "picks": picks, "base": base,
                     "kept": kept}
        return lat, size, int(missing.sum()), float(late.max(initial=0.0))

    def _sample(self, n, size):
        if not hasattr(self, "_chosen"):
            r = inputs.rng(self.ctx.seed, "sample")
            k = min(self.traffic["sample_requests"], n)
            chosen = set(int(i) for i in r.choice(n, k, replace=False))
            chosen.add(int(np.argmax(size)))
            self._chosen = chosen
        return self._chosen

    def window(self, seconds: float) -> dict:
        calls0 = self.batcher.engine_calls
        lat, size, failed, late = self._drive(seconds, 0, keep=self._sample)
        self.window_last = self.last
        return {"seconds": seconds, "units": len(lat),
                "images": int(size.sum()), "attempted": len(lat),
                "failed": failed, "latencies_ms": lat.tolist(),
                "engine_calls": self.batcher.engine_calls - calls0,
                "lateness_s": late}

    def trace_slice(self, sl) -> None:
        self._drive(self.traffic["trace_seconds"], 1)

    def peak_seconds(self) -> None:
        return None

    def release(self) -> None:
        httpd = getattr(self.ready, "httpd", None)
        if httpd is not None:
            httpd.shutdown()
        self.server.join(60.0)
        del self.batcher, self.engine
        self.ready.state = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    def program_outputs(self):
        w = self.window_last
        return [(w["kept"][i][0], torch.from_numpy(w["kept"][i][1]), None)
                for i in sorted(w["kept"])]

    def reference_outputs(self, tf32: bool = False):
        w = self.window_last
        W = inputs.make_weights(ref.spec(self.cfg), self.ctx.seed, "g",
                                self.device)
        out = []
        with ref.precision(tf32):
            for i in sorted(w["kept"]):
                graphs = [self.graphs[j] for j in w["picks"][i]]
                out.append(gen_driver.reference_images(
                    self.cfg, W, graphs, self.seeds[w["base"] + i],
                    self.device, self.traffic["ref_block"]))
        return out

    def check(self) -> dict:
        prog = self.program_outputs()
        if not prog:
            return {}
        refs = self.reference_outputs()
        return gen_driver.compare(prog, refs)
