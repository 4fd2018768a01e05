"""What the measurement tools share: their common flags, the card check,
timing on either device, the profiler's kernel table, FLOP counting, the
vg128 flagship and its bench inputs, the layout compose's timed instance
with its inputs and bars, and the report file.

A tool runs on the card (``--device cuda``, the default) and exits 1
without one; ``--device cpu`` runs it on the host, at the small sizes the
tests give it, where its times are the host's and name no device metric.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from sg2im_tpu_torch.utils.roofline import (
    FlopCounter,
    layout_bounds,
    mask_head_flops,
)
from sg2im_tpu_torch.utils.timing import profile_window

# K1's timed instance: the flagship's batch-128 layout compose, as every
# serving mode runs it (N, O, M, H, W, D).
LAYOUT_TIMED = (128, 16, 16, 128, 128, 128)
KERNEL_BAR = 1e-5  # max abs error vs the plain version (tests/test_pallas.py)


def base_parser(doc: str) -> argparse.ArgumentParser:
    """--device (default cuda) and --out (default the working directory)."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; exit 1 without one) or 'cpu'")
    p.add_argument("--out", default=".",
                   help="directory of the tool's <tool>.json")
    return p


def open_device(args) -> tuple[torch.device, str] | None:
    """(device, what it is: the card's name and power limit, or 'cpu'); None
    after printing why when a card was asked for and there is none."""
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("FAIL: no CUDA card (pass --device cpu to run on the host)",
                  file=sys.stderr)
            return None
        from sg2im_tpu_torch.tools.train_proof import card_name

        return device, card_name()
    return device, "cpu"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device="cuda", iters: int = 20, warmup: int = 3) -> float:
    """ms per call of ``fn`` after ``warmup`` calls: CUDA events around
    ``iters`` calls on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def windows_ms(fn, device, windows: int, iters: int) -> list[float]:
    """ms per call in each of ``windows`` windows of ``iters`` calls, on the
    host clock up to a synchronize (the caller warms up)."""
    out = []
    for _ in range(windows):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def kernel_table(fn, device, iters: int = 3,
                 top: int | None = 10) -> dict | None:
    """``torch.profiler`` over ``iters`` calls of ``fn`` on the card
    (:func:`~sg2im_tpu_torch.utils.timing.profile_window`): device ms and
    kernels per call (kernels and copies), the span per call (CUDA events
    around the calls), the idle share 1 - device / span, the ``top``
    kernels by device ms per call (all of them for None), and
    ``warmup_lost``, the window's warm-up launches the profiler lost.
    None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    with profile_window(device) as window:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
    span = a.elapsed_time(b) / iters
    kernels = window.device_events
    busy = sum(e.device_time for e in kernels) / 1e3 / iters
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name[:90], [0.0, 0])
        t[0] += e.device_time / 1e3 / iters
        t[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ms": busy, "kernels": len(kernels) / iters,
            "span_ms": span, "idle": 1.0 - busy / span if span > 0 else None,
            "top": [{"name": n, "ms": ms, "count": c / iters}
                    for n, (ms, c) in ranked],
            "warmup_lost": window.warmup_lost}


def run_worker(script, root, argv) -> dict:
    """``python -P script --worker *argv`` in a process of its own, from
    the checkout at ``root`` with that root alone on the path (the A/B
    tools' turns); -> its last line of output as JSON, less ``module``,
    the file of the package it imported, which must lie in ``root``."""
    import subprocess
    from pathlib import Path

    cmd = [sys.executable, "-P", str(script), "--worker", *map(str, argv)]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(root)})
    if proc.returncode != 0:
        raise RuntimeError(f"the worker of {root} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    module = Path(result.pop("module")).resolve()
    if not module.is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"the worker of {root} imported {module}")
    return result


def count_flops(fn, k1_shape=None) -> tuple[dict, dict]:
    """({operation type: operations}, {hand kernel: operations}) of one
    call of ``fn``; ``k1_shape`` (N, O, M, H, W, D) is the shape of the
    layout compose that ``fn`` launches on the card, whose closed form
    each launch adds, and of the mask head (N O slots of D channels to M x
    M), whose launches (one a step) add its phase form's operations a step
    on average.  The eager head the CPU runs counts its direct 3x3 convs,
    2.3 times the phase form's."""
    per_launch = {}
    if k1_shape is not None:
        from sg2im_tpu_torch.ops.layout_kernel import layout_compose
        from sg2im_tpu_torch.ops.mask_head import mask_head

        N, O, M, _, _, D = k1_shape
        per_launch[layout_compose] = (
            layout_bounds(*k1_shape, weights=False)[1], "f32")
        if M and M > 1:
            per_launch[mask_head] = (
                mask_head_flops(N * O, D, M) // (M.bit_length() - 1), "f32")
    with FlopCounter(per_launch) as fc:
        fn()
    return dict(fc.by_type), dict(fc.kernels)


def write_report(out_dir: str, tool: str, payload) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tool}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def layout_inputs(N, O, M, H, W, D, seed, degenerate=False, device="cuda"):
    """boxes (N, O, 4), masks (N, O, M, M), vecs (N, O, D) from a seed;
    vecs are zero on empty object slots, as the generator passes them."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-0.1, 0.6, (N, O, 2)).astype(np.float32)
    sz = rng.uniform(0.1, 0.5, (N, O, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + sz], -1)
    obj_mask = np.ones((N, O), np.float32)
    if degenerate:
        boxes[:, ::3, 2] = boxes[:, ::3, 0]            # zero width
        boxes[:, 1::4, 3] = boxes[:, 1::4, 1]          # zero height
        boxes[:, 2] = 0.0                              # a point: 0/0 at t=0
        boxes[0, 3] = [0.25, 0.25, 0.25, 0.25]
        obj_mask[:, 5::7] = 0.0                        # empty slots
    masks = rng.rand(N, O, M, M).astype(np.float32)
    vecs = rng.randn(N, O, D).astype(np.float32) * obj_mask[..., None]
    return tuple(torch.tensor(a, device=device) for a in (boxes, masks, vecs))


def within_one_rounding(out, want, bar: float = KERNEL_BAR) -> bool:
    """Whether a bf16 output is within one rounding of the f32 ``want``
    everywhere: |out - want| <= |want| 2^-8 + bar."""
    return bool(((out.float() - want).abs()
                 <= want.abs() * 2.0 ** -8 + bar).all())


def vg128_config():
    """The flagship vg128 (bench.py:77-92): vocab and generator kwargs."""
    objects = ["__image__"] + [f"o{i}" for i in range(1, 179)]
    preds = ["__in_image__"] + [f"p{i}" for i in range(1, 46)]
    vocab = {"object_idx_to_name": objects, "pred_idx_to_name": preds,
             "object_name_to_idx": {n: i for i, n in enumerate(objects)},
             "pred_name_to_idx": {n: i for i, n in enumerate(preds)}}
    kwargs = dict(image_size=(128, 128), embedding_dim=128, gconv_dim=128,
                  gconv_hidden_dim=512, gconv_num_layers=5,
                  refinement_dims=(1024, 512, 256, 128, 64),
                  normalization="batch", activation="leakyrelu-0.2",
                  mask_size=16, layout_noise_dim=32)
    return vocab, kwargs


def tiny_config():
    """A small generator of the vg128 shape for the host runs: 32 x 32
    images (the last CRN stage at 32, where 'packed' packs and the int8
    tier quantizes), GCN 16 (hidden 32, 2 layers), CRN 32 -> 16 -> 8,
    masks 4, noise 4, the vg128 vocabulary."""
    vocab, _ = vg128_config()
    kwargs = dict(image_size=(32, 32), embedding_dim=16, gconv_dim=16,
                  gconv_hidden_dim=32, gconv_num_layers=2,
                  refinement_dims=(32, 16, 8), normalization="batch",
                  activation="leakyrelu-0.2", mask_size=4,
                  layout_noise_dim=4)
    return vocab, kwargs


def random_state(vocab, kwargs, seed: int = 0, device=None) -> dict:
    """The generator's weights that the JAX package's init gives
    ``PRNGKey(seed)`` (bench.py:136-141 builds its model from
    ``PRNGKey(0)``), drawn on ``device`` (default the CPU)."""
    from sg2im_tpu_torch.models import Sg2ImGenerator
    from sg2im_tpu_torch.nn.init import init_state_dict
    from sg2im_tpu_torch.ops.prng import prng_key

    return init_state_dict(Sg2ImGenerator(vocab, **kwargs), "g",
                           prng_key(seed), device)


def bench_inputs(N: int, vocab, O: int = 16, T: int = 32, live: int = 11):
    """bench.py:126-134's inputs from ``RandomState(0)``: random object ids
    in O slots of which the first ``live`` are real, T real triples
    between the live slots -> a ``GraphBatch`` (numpy)."""
    from sg2im_tpu_torch.data import GraphBatch

    num_objs = len(vocab["object_idx_to_name"])
    num_preds = len(vocab["pred_idx_to_name"])
    rng = np.random.RandomState(0)
    objs = rng.randint(0, num_objs, (N, O)).astype(np.int32)
    triples = np.stack([rng.randint(0, live, (N, T)),
                        rng.randint(0, num_preds, (N, T)),
                        rng.randint(0, live, (N, T))], -1).astype(np.int32)
    obj_mask = np.zeros((N, O), np.float32)
    obj_mask[:, :live] = 1.0
    return GraphBatch(objs=objs, triples=triples, obj_mask=obj_mask,
                      triple_mask=np.ones((N, T), np.float32))


def device_batch(batch, device) -> tuple:
    """A GraphBatch's (objs, triples, obj_mask, triple_mask) on ``device``
    in the generator's types."""
    return (torch.as_tensor(batch.objs, device=device).long(),
            torch.as_tensor(batch.triples, device=device).long(),
            torch.as_tensor(batch.obj_mask, device=device).float(),
            torch.as_tensor(batch.triple_mask, device=device).float())


def measured_peaks(device, size: int, stream_shape) -> dict:
    """The run's own peaks: a bf16 and an f32 (TF32 off) ``size``^3
    ``torch.matmul`` in FLOP/s, and an f32 scale+add ``x + 1e-7 x`` over
    ``stream_shape`` (one kernel: one read, one write) in bytes/s."""
    from sg2im_tpu_torch.inference import full_fp32

    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    with torch.inference_mode(), full_fp32():
        for name, dtype in (("bf16_matmul", torch.bfloat16),
                            ("f32_matmul", torch.float32)):
            a = torch.randn((size, size), generator=gen, device=device,
                            dtype=dtype)
            b = torch.randn((size, size), generator=gen, device=device,
                            dtype=dtype)
            ms = time_ms(lambda: torch.matmul(a, b), device, iters=10)
            out[name + "_flops"] = 2 * size ** 3 / (ms / 1e3)
            del a, b
        x = torch.randn(stream_shape, generator=gen, device=device)
        ms = time_ms(lambda: torch.add(x, x, alpha=1e-7), device, iters=10)
        out["scale_add_bytes"] = 2 * x.numel() * 4 / (ms / 1e3)
        del x
    return out
