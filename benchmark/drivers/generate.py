"""Batch generation: one caller, back to back, ``InferenceEngine.generate``
on ``batch`` scene-graph dicts a call, drawn from a pool of distinct
batches, with a new noise seed each call (``cli/run_model``,
``sample_images``).

Traffic keys: ``batch``, ``pool``, ``min_objects``, ``max_objects``,
``sample_calls`` (calls compared, drawn from the seed among the first
``sample_within``), ``trace_units`` (calls in the traced slice),
``ref_block`` (rows a reference block).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark.harness import checks, device, inputs, peaks
from benchmark.reference import generator as ref
from benchmark.reference import threefry

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def engine_kwargs(cfg) -> tuple[dict, dict]:
    """(the generator's model_kwargs, the engine's serving options) of a
    configuration."""
    m = cfg["model"]
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in m.items()}
    s = cfg["serving"]
    opts = {"compute_dtype": DTYPES[s["compute_dtype"]],
            "crn_mode": s["crn_mode"]}
    return kw, opts


def call_unit(cfg, graphs) -> dict:
    """What a call asks of the hand kernels: its images and real objects
    (with '__image__'), the layout's element size, the noise values."""
    m = cfg["model"]
    H, W = m["image_size"]
    elem = 2 if cfg["serving"]["compute_dtype"] == "bfloat16" else 4
    return {"images": len(graphs),
            "objects": sum(len(g["objects"]) + 1 for g in graphs),
            "layout_elem": elem,
            "noise_values": len(graphs) * H * W * m["layout_noise_dim"]}


def flops_at_peak(cfg, graphs) -> float:
    """Seconds the reference's matmuls and convolutions of one call take at
    their types' peaks: the graph, heads and layout in float32, the CRN in
    the configuration's compute type; counted on the meta device at the
    call's shapes."""
    v = inputs.vocab(cfg)
    b = inputs.encode(graphs, v)
    W = {n: torch.empty(s, device="meta") for n, s, _ in ref.spec(cfg)}
    t = {k: torch.empty(x.shape, dtype=torch.long if x.dtype == np.int64
                        else torch.float32, device="meta")
         for k, x in b.items()}
    H, Wd = cfg["model"]["image_size"]
    noise = torch.empty(len(graphs), cfg["model"]["layout_noise_dim"], H, Wd,
                        device="meta")
    crn = "bf16" if cfg["serving"]["compute_dtype"] == "bfloat16" else "f32"
    fc = peaks.FlopCount()
    with torch.no_grad():
        ref.forward(W, cfg, t["objs"].zero_(), t["triples"].zero_(),
                    t["obj_mask"], t["triple_mask"], noise,
                    sections={"graph": lambda: fc.section("f32"),
                              "crn": lambda: fc.section(crn)})
    return fc.seconds_at_peak()


@torch.no_grad()
def reference_images(cfg, W, graphs, seed, device, block: int):
    """The reference's (uint8 images (n, H, W, 3), boxes, masks, obj_mask,
    each image's range before its min-max rescale) for ``graphs`` with the
    seeded noise of ``seed``, in blocks of rows."""
    v = inputs.vocab(cfg)
    b = inputs.encode(graphs, v)
    m = cfg["model"]
    H, Wd = m["image_size"]
    k = threefry.key(seed)
    imgs, boxes, masks, ranges = [], [], [], []
    for r0 in range(0, len(graphs), block):
        r1 = min(r0 + block, len(graphs))
        t = {key: torch.from_numpy(x[r0:r1]).to(device)
             for key, x in b.items()}
        noise = threefry.layout_noise(k, r1 - r0, m["layout_noise_dim"], H,
                                      Wd, device, row=r0)
        i, bx, mk, _ = ref.forward(W, cfg, t["objs"], t["triples"],
                                   t["obj_mask"], t["triple_mask"], noise)
        imgs.append(ref.to_uint8(i).cpu().numpy())
        flat = i.reshape(i.shape[0], -1)
        ranges.append((flat.amax(1) - flat.amin(1)).cpu().numpy())
        boxes.append(bx.cpu())
        masks.append(mk.cpu())
    return (np.concatenate(imgs), torch.cat(boxes), torch.cat(masks),
            torch.from_numpy(b["obj_mask"]), np.concatenate(ranges))


def compare(prog, refs) -> dict:
    """img_mse: the mean squared uint8 difference over every pixel of every
    compared image; box_err and mask_err: the largest box and (where the
    program returns them) mask difference over real objects."""
    out = {"box_err": 0.0}
    sq = n = 0.0
    for (imgs, boxes, masks), (r_imgs, r_boxes, r_masks, om, _) in zip(
            prog, refs):
        sq += checks.u8_mse(imgs, r_imgs) * imgs.size
        n += imgs.size
        out["box_err"] = max(out["box_err"],
                             checks.real_max_abs(boxes, r_boxes, om))
        if masks is not None:
            out["mask_err"] = max(out.get("mask_err", 0.0),
                                  checks.real_max_abs(masks, r_masks, om))
    out["img_mse"] = sq / n
    return out


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.device = ctx.device

    def setup(self, quantize=None):
        from sg2im_tpu_torch.inference import InferenceEngine

        cfg, tr, seed = self.cfg, self.traffic, self.ctx.seed
        model_kwargs, opts = engine_kwargs(cfg)
        if quantize:
            opts["quantize"] = quantize
        W = inputs.make_weights(ref.spec(cfg), seed, "g", self.device)
        self.engine = InferenceEngine(inputs.vocab(cfg), model_kwargs, W,
                                      device=self.device, **opts)
        del W
        r = inputs.rng(seed, "graphs")
        self.pool = [inputs.scene_graphs(cfg, tr, r, tr["batch"])
                     for _ in range(tr["pool"])]
        self.seeds = inputs.call_seeds(seed, tr["max_calls"])
        self.sample = set(int(i) for i in inputs.rng(seed, "sample").choice(
            tr["sample_within"], tr["sample_calls"], replace=False))
        # Every shape of the traffic: each pool batch once.
        for i, graphs in enumerate(self.pool):
            self.engine.generate(graphs, seed=self.seeds[-1 - i])
        device.sync(self.device)

    def _call(self, k):
        graphs = self.pool[k % len(self.pool)]
        imgs, out = self.engine.generate(graphs, seed=self.seeds[k])
        return graphs, imgs, out

    def window(self, seconds: float) -> dict:
        self.kept = {}
        calls = images = failed = 0
        t0 = time.perf_counter()
        while True:
            try:
                graphs, imgs, out = self._call(calls)
                images += len(imgs)
                if calls in self.sample:
                    self.kept[calls] = (imgs, out["boxes"].cpu(),
                                        out["masks"].cpu())
            except Exception as exc:  # noqa: BLE001 — a failed call counts
                failed += 1
                print(f"call {calls} failed: {exc!r}", file=sys.stderr)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t = time.perf_counter() - t0
        self.calls = calls
        return {"seconds": t, "units": calls, "images": images,
                "attempted": calls, "failed": failed}

    def trace_slice(self, sl) -> None:
        from torch.profiler import record_function

        for j in range(self.traffic["trace_units"]):
            with record_function("benchmark.generate"):
                graphs, _, _ = self._call(self.calls + j)
            sl.units.append(call_unit(self.cfg, graphs))

    def peak_seconds(self) -> float:
        """Seconds at peak of the window's calls."""
        per = [flops_at_peak(self.cfg, g) for g in self.pool]
        return sum(per[k % len(per)] for k in range(self.calls))

    def release(self) -> None:
        self.engine.close()
        del self.engine
        gc.collect()
        torch.cuda.empty_cache()

    def program_outputs(self):
        return [self.kept[k] for k in sorted(self.kept)]

    def reference_outputs(self, tf32: bool = False):
        W = inputs.make_weights(ref.spec(self.cfg), self.ctx.seed, "g",
                                self.device)
        with ref.precision(tf32):
            return [reference_images(
                self.cfg, W, self.pool[k % len(self.pool)], self.seeds[k],
                self.device, self.traffic["ref_block"])
                for k in sorted(self.kept)]

    def check(self) -> dict:
        if not self.kept:
            return {}
        return compare(self.program_outputs(), self.reference_outputs())
