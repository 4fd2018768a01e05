"""The repo's one-line benchmark on the port: vg128 inference throughput on
the card, with its fidelity and training fields in the same line.

Port of ``bench.py`` (the JAX package's benchmark).  Its environment knobs
are flags with the same defaults:

    python -m sg2im_tpu_torch.tools.bench [--batch 128] [--iters 10]
        [--repeats 3] [--extras 1] [--mode infer|train] [--bf16 1]
        [--crn_mode split] [--config vg128|tiny] [--device cuda] [--out DIR]

``--batch`` is 128, and 32 under ``--mode train``.  The last line of
standard output is one JSON object with ``bench.py``'s keys:

* ``value``: the median img/s of ``--repeats`` windows of ``--iters``
  forwards of the generator at vg128 on ``bench.py:126-134``'s inputs
  (O 16 with 11 live objects, T 32, ``RandomState(0)``), bench.py's
  weights (the JAX package's init of ``PRNGKey(0)``, drawn on the card by
  the threefry kernel) and bench.py:143's pinned noise, ``jax.random.normal(
  PRNGKey(2), (N, 128, 128, 32))``, drawn on the card by the threefry
  kernel, in the chosen mode (bf16 /
  'split', the production mode, by default); each window ends with one
  ``synchronize()`` on the host clock; ``value_runs`` the windows,
  ``vs_baseline`` against ``BASELINE_MEASURED.json``'s
  ``torch_cpu_images_per_sec_128``;
* with ``--extras 1``: ``psnr_{db,u8_db}_vs_reference{_f32,,_turbo}``
  (raw at max_val 1.0, and u8 through ``imagenet_deprocess_batch``) of
  the card's f32, production and int8 engines on ``scripts/
  attrib_psnr.py``'s flagship proxy against the reference, and
  ``psnr_n_images``; ``psnr_u8_db_trained``, ``psnr_db_trained`` and
  ``trained_gate_pass`` from ``cli.verify_pretrained`` on
  ``artifacts/trained_coco64.pt``; ``train_*_b32`` and
  ``train_*_b32_fast`` (the COCO-64 b32 GAN step in f32 and in bf16 /
  'split'); ``serve_img_s_random`` (``InferenceEngine.generate_batch``
  with seeded noise, host work included) and ``turbo_img_s`` (the int8
  engine at its default band), each with its ``*_runs``;

plus ``card`` (the card's name and power limit), ``config``, ``batch``,
``mode`` and, with the extras, ``psnr_reference``.  ``--mode train``
times only the COCO-64 step in f32 / 'legacy', as bench.py's:
``coco64_gan_train_step`` with ``value_runs``.  The line is also written
to ``<out>/bench.json``.  ``--config tiny`` runs small generators and a
small train config, for host runs with ``--device cpu``.

Differences from ``bench.py``:

* The reference of the PSNR fields is the port's own float32 engine on
  the CPU (``psnr_reference`` says so), not the upstream model, which
  the repo does not hold; tier-1 holds that engine to the JAX package.
* ``BENCH_DENSE_PRECISION`` has no counterpart: the GCN and the heads
  always run in true float32, TF32 off.  ``turbo_img_s`` draws its noise
  in bfloat16 as bench.py's does, but by threefry: ``noise_impl='rbg'``
  is refused by the port, its bits having no single reference.
* Failures are not hidden: a failing part ends the run with exit code 1
  and its cause on standard error, where ``bench.py`` warns and leaves
  the field out.
* JSON has no infinity: a PSNR of bit-equal images (only in a
  ``--device cpu`` run, the CPU against itself) is written as null.

Runs on the card (``--device cuda``, the default) and exits 1 without
one.  Every engine is warmed up and timed on the calling thread (cuDNN
keeps its plans per thread), and each is freed before the next is built.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from sg2im_tpu_torch.models.sg2im import CRN_MODES
from sg2im_tpu_torch.tools import _measure as M

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PSNR_REFERENCE = "sg2im_tpu_torch f32 on the CPU"
# scripts/attrib_psnr.py:102-113 at the flagship's vocabulary (m = 14
# objects, pm = 45 predicates).
_M, _PM = 14, 45
PROXY_GRAPHS = [
    {"objects": [f"o{1 + i % _M}" for i in range(3)],
     "relationships": [[0, f"p{1 + 0 % _PM}", 1], [2, f"p{1 + 1 % _PM}", 0]]},
    {"objects": [f"o{1 + (3 + i) % _M}" for i in range(4)],
     "relationships": [[0, f"p{1 + 2 % _PM}", 1], [1, f"p{1 + 3 % _PM}", 2],
                       [3, f"p{1 + 4 % _PM}", 0]]},
    {"objects": [f"o{1 + (7 + i) % _M}" for i in range(2)],
     "relationships": [[0, f"p{1 + 5 % _PM}", 1]]},
    {"objects": [f"o{1 + (9 + i) % _M}" for i in range(5)],
     "relationships": [[0, f"p{1 + 6 % _PM}", 4], [1, f"p{1 + 7 % _PM}", 2],
                       [2, f"p{1 + 8 % _PM}", 3]]},
]


class BenchFailure(Exception):
    """A part of the run failed a check: the run exits 1."""


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _median(xs):
    return float(np.median(xs))


def _read_baseline(key: str) -> float:
    """A CPU baseline of ``BASELINE_MEASURED.json`` at the repo's root."""
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
        return float(json.load(f)[key])


def _generator_config(config: str):
    return M.vg128_config() if config == "vg128" else M.tiny_config()


def flagship_config(bf16: bool = True, crn_mode: str = "split",
                    config: str = "vg128"):
    """(vocab, engine kwargs) of the flagship, bench.py:77-112: the
    generator's kwargs (``_measure.vg128_config``, or ``tiny_config``)
    with the mode, bf16 and 'split' being the production one."""
    vocab, kwargs = _generator_config(config)
    if bf16:
        kwargs["compute_dtype"] = torch.bfloat16
    kwargs["crn_mode"] = crn_mode
    return vocab, kwargs


def flagship_engine(device="cuda", bf16: bool = True,
                    crn_mode: str = "split", config: str = "vg128"):
    """An ``InferenceEngine`` in the chosen mode on bench.py's weights,
    the JAX package's init of ``PRNGKey(0)`` drawn on ``device``
    (``_measure.random_state``), with the engine's production set-up:
    channels_last, the geometry in true float32."""
    from sg2im_tpu_torch.inference import InferenceEngine

    vocab, base = _generator_config(config)
    _, kwargs = flagship_config(bf16, crn_mode, config)
    return InferenceEngine(vocab, kwargs,
                           M.random_state(vocab, base, device=device),
                           device=str(device))


def flagship_setup(batch: int = 32, device="cuda", engine=None):
    """(fwd, args): the flagship forward and its inputs on ``device``, the
    counterpart of bench.py:115-152 and of ``__graft_entry__.py:38``
    ``entry()``.

    ``engine`` defaults to :func:`flagship_engine` on ``device``.  args are
    (objs, triples, obj_mask, triple_mask, noise): ``bench_inputs``
    (bench.py:126-134) and bench.py:143-144's pinned noise,
    ``jax.random.normal(PRNGKey(2), (N, H, W, D))`` (``ops.prng``, the
    threefry kernel on the card), handed to the generator as its (N, D,
    H, W) channels_last view.  ``fwd(*args)`` is the generator's
    forward under ``torch.inference_mode`` with TF32 off -> images (N, 3,
    H, W)."""
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.ops.prng import prng_key
    from sg2im_tpu_torch.ops.prng_kernel import threefry_normal

    engine = engine or flagship_engine(device)
    model = engine.model
    H, W = model.image_size
    noise = threefry_normal(prng_key(2), (batch, model.layout_noise_dim, H,
                                          W), device=device,
                            memory_format=torch.channels_last)
    args = M.device_batch(M.bench_inputs(batch, engine.vocab), device) + (
        noise,)

    def fwd(objs, triples, obj_mask, triple_mask, noise):
        with torch.inference_mode(), full_fp32():
            return model(objs, triples, obj_mask, triple_mask, noise)[0]

    return fwd, args


def train_step_setup(batch: int = 32, device="cuda", config: str = "vg128",
                     **cfg):
    """(trainer, state, batch as numpy): the COCO-64 flagship GAN step of
    bench.py:155-185 (``profile_train.coco64``; ``roofline_train.
    tiny_coco`` at ``config='tiny'``), ``init_state(seed=0)``."""
    from sg2im_tpu_torch.tools.profile_train import coco64
    from sg2im_tpu_torch.tools.roofline_train import tiny_coco
    from sg2im_tpu_torch.train.trainer import Trainer

    vocab, tcfg, batch_np = (coco64 if config == "vg128" else tiny_coco)(
        batch, **cfg)
    trainer = Trainer(tcfg, vocab, device=str(device))
    return trainer, trainer.init_state(seed=0), batch_np


def _measure_train(batch: int, iters: int, repeats: int, device="cuda",
                   config: str = "vg128", **cfg):
    """(s per step, img/s, img/s over the CPU baseline's, img/s of each
    window) of the GAN step, bench.py:207-230: the batch staged on the
    device once, one warm-up step, then ``repeats`` windows of ``iters``
    steps on the host clock, each closed by reading ``total_loss``."""
    trainer, state, batch_np = train_step_setup(batch, device, config, **cfg)
    b = trainer.to_device(batch_np)
    state, m = trainer.step(state, b)
    float(m["total_loss"])
    dts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = trainer.step(state, b)
        loss = float(m["total_loss"])
        dts.append((time.perf_counter() - t0) / iters)
        if not np.isfinite(loss):
            raise BenchFailure(f"train step {cfg or 'f32'}: total_loss "
                               f"{loss}")
    del trainer, state, b
    _free(device)
    dt = _median(dts)
    baseline_ips = 32.0 / _read_baseline("torch_cpu_train_step_sec_coco64_b32")
    return dt, batch / dt, batch / dt / baseline_ips, [batch / d for d in dts]


def build_proxy(config: str = "vg128", device=None):
    """(vocab, generator kwargs, state dict, scene graphs): the flagship
    proxy of scripts/attrib_psnr.py:76-123 (``tiny_config`` at
    ``config='tiny'``).  Weights: bench.py's, the JAX package's init of
    ``PRNGKey(0)`` (bench.py:136-141) drawn on ``device`` (default the
    CPU); the box head's last Linear scaled by 0.01 with bias (0.15, 0.2,
    0.85, 0.8), so that the boxes behind its final ReLU have positive
    extent."""
    from sg2im_tpu_torch.models import Sg2ImGenerator
    from sg2im_tpu_torch.nn.init import init_state_dict
    from sg2im_tpu_torch.ops.prng import prng_key

    vocab, kwargs = _generator_config(config)
    model = Sg2ImGenerator(vocab, **kwargs)
    state = init_state_dict(model, "g", prng_key(0), device)
    last = [name for name, m in model.box_net.named_modules()
            if isinstance(m, torch.nn.Linear)][-1]
    state[f"box_net.{last}.weight"] *= 0.01
    state[f"box_net.{last}.bias"] = torch.tensor(
        [0.15, 0.2, 0.85, 0.8], device=state[f"box_net.{last}.bias"].device)
    return vocab, kwargs, state, PROXY_GRAPHS


def check_boxes(engine, graphs, boxes) -> None:
    """Raise unless every live object's box (x0, y0, x1, y1) has positive
    extent: a degenerate box NaNs the reference's grid
    (bench.py:244-246)."""
    from sg2im_tpu_torch.data import encode_scene_graphs

    live = encode_scene_graphs(graphs, engine.vocab,
                               align=engine.pad_align).obj_mask > 0
    b = boxes.float().cpu().numpy()
    ok = (b[..., 2] > b[..., 0]) & (b[..., 3] > b[..., 1])
    if not ok[live].all():
        raise BenchFailure(f"the proxy's boxes are degenerate for "
                           f"{int((~ok[live]).sum())} of {int(live.sum())} "
                           "live objects")


def _images(engine, graphs):
    """(float32 images (n, H, W, 3), boxes) with zero noise."""
    imgs, out = engine.generate(graphs, noise="zeros", deprocess=False)
    if not np.isfinite(imgs).all():
        raise BenchFailure("non-finite images")
    return imgs, out["boxes"]


def measure_psnr_vs_reference(device="cuda", bf16: bool = True,
                              crn_mode: str = "split",
                              config: str = "vg128"):
    """({field: PSNR}, images): bench.py:233-332 on the proxy of
    :func:`build_proxy`.  The reference is the port's f32 engine on the
    CPU with zero noise; each mode runs on ``device``: f32 (the ``_f32``
    fields), the production mode (unsuffixed) and the int8 tier at the
    engine's default band (``_turbo``; calibrated on the first half of
    the graphs with zero noise, then scored on all, as bench.py:312-321
    does).  Raw PSNR at max_val 1.0 and u8 PSNR through
    ``imagenet_deprocess_batch``.  With ``bf16`` off f32 is the
    production mode: its fields are the unsuffixed ones and there is no
    turbo field."""
    from sg2im_tpu_torch.data import imagenet_deprocess_batch
    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.utils.metrics import psnr

    vocab, kwargs, state, graphs = build_proxy(config, device)
    ref = InferenceEngine(vocab, kwargs, state, device="cpu")
    ref_imgs, boxes = _images(ref, graphs)
    check_boxes(ref, graphs, boxes)
    del ref
    ref_u8 = imagenet_deprocess_batch(ref_imgs)
    modes = [("psnr_db_vs_reference_f32", {})]
    if bf16:
        prod = dict(compute_dtype=torch.bfloat16, crn_mode=crn_mode)
        modes += [("psnr_db_vs_reference", prod),
                  ("psnr_db_vs_reference_turbo",
                   dict(prod, quantize="int8"))]
    results = {}
    for field, kw in modes:
        engine = InferenceEngine(vocab, kwargs, state, device=str(device),
                                 **kw)
        if kw.get("quantize"):
            engine.calibrate(graphs[: max(1, len(graphs) // 2)],
                             noise="zeros")
        got, _ = _images(engine, graphs)
        results[field] = psnr(got, ref_imgs, max_val=1.0)
        results[field.replace("psnr_db", "psnr_u8_db")] = psnr(
            imagenet_deprocess_batch(got), ref_u8, max_val=255.0)
        del engine
        _free(device)
    if not bf16:
        for field in ("psnr_db_vs_reference", "psnr_u8_db_vs_reference"):
            results[field] = results.pop(field + "_f32")
    return results, len(graphs)


def measure_trained_psnr(device="cuda") -> dict:
    """bench.py:335-370 on ``artifacts/trained_coco64.pt``: the port's CPU
    f32 engine renders ``artifacts/trained_scene_graphs.json`` with zero
    noise as the goldens (``img%06d.png``), then ``cli.verify_pretrained``
    on ``device`` scores against them at 40 dB.  ``psnr_u8_db_trained``
    is the CLI's; ``psnr_db_trained`` the raw PSNR of the device engine's
    float images against the CPU's; ``trained_gate_pass`` the CLI's exit
    code 0."""
    from PIL import Image

    from sg2im_tpu_torch.cli import verify_pretrained
    from sg2im_tpu_torch.data import imagenet_deprocess_batch
    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.utils.metrics import psnr

    pt = os.path.join(REPO, "artifacts", "trained_coco64.pt")
    sg = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")
    with open(sg) as f:
        graphs = json.load(f)
    want, _ = _images(InferenceEngine.from_torch_checkpoint(pt, device="cpu"),
                      graphs)
    engine = InferenceEngine.from_torch_checkpoint(pt, device=str(device))
    got, _ = _images(engine, graphs)
    del engine
    _free(device)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as td:
        golden = os.path.join(td, "golden")
        os.makedirs(golden)
        for i, img in enumerate(imagenet_deprocess_batch(want)):
            Image.fromarray(img).save(os.path.join(golden, "img%06d.png" % i))
        with contextlib.redirect_stdout(buf):
            rc = verify_pretrained.main([
                "--checkpoint", pt, "--scene_graphs_json", sg,
                "--output_dir", os.path.join(td, "out"), "--golden_dir",
                golden, "--device", str(device), "--min_psnr", "40"])
    _free(device)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc not in (0, 2) or not lines:
        raise BenchFailure(f"verify_pretrained exited {rc}: "
                           f"{buf.getvalue()[-2000:]}")
    return {"psnr_u8_db_trained": json.loads(lines[-1])["psnr"][
                "golden_u8:ALL"],
            "psnr_db_trained": psnr(got, want, max_val=1.0),
            "trained_gate_pass": rc == 0}


def _serve_windows(engine, gb, iters: int, repeats: int, device):
    """img/s of ``repeats`` windows of ``iters`` ``generate_batch`` calls
    with seeded noise (seeds 2, 3, ...), after the seed-0 and seed-1 calls
    of bench.py:475-476 (an uncalibrated int8 engine calibrates on the
    first)."""
    engine.generate_batch(gb, seed=0)
    engine.generate_batch(gb, seed=1)
    seeds = itertools.count(2)
    out = {}

    def call():
        out["imgs"] = engine.generate_batch(gb, seed=next(seeds))["imgs"]

    runs = [gb.objs.shape[0] / ms * 1e3
            for ms in M.windows_ms(call, device, repeats, iters)]
    if not torch.isfinite(out["imgs"]).all():
        raise BenchFailure("non-finite served images")
    return runs


def main_train(args, device) -> dict:
    """bench.py:373-383: the COCO-64 GAN step as the primary metric."""
    dt, ips, vs, runs = _measure_train(args.batch, args.iters, args.repeats,
                                       device, args.config)
    return {"metric": "coco64_gan_train_step", "value": ips,
            "unit": "images/sec", "vs_baseline": vs, "value_runs": runs}


def main_infer(args, device) -> dict:
    """bench.py:386-524 (its ``main()``): the forward's img/s, then the
    extras in bench.py's order."""
    from sg2im_tpu_torch.inference import InferenceEngine

    engine = flagship_engine(device, args.bf16, args.crn_mode, args.config)
    fwd, fargs = flagship_setup(args.batch, device, engine)
    fwd(*fargs)
    fwd(*fargs)
    runs = [args.batch / ms * 1e3 for ms in M.windows_ms(
        lambda: fwd(*fargs), device, args.repeats, args.iters)]
    if not torch.isfinite(fwd(*fargs)).all():
        raise BenchFailure("non-finite images from the forward")
    ips = _median(runs)
    baseline = _read_baseline("torch_cpu_images_per_sec_128")
    line = {"metric": "vg128_inference_throughput", "value": ips,
            "unit": "images/sec", "vs_baseline": ips / baseline,
            "value_runs": runs}
    if not args.extras:
        return line
    fields, n = measure_psnr_vs_reference(device, args.bf16, args.crn_mode,
                                          args.config)
    line.update(fields)
    line["psnr_n_images"] = n
    line.update(measure_trained_psnr(device))
    for suffix, cfg in (("", {}), ("_fast", dict(bf16_compute=True,
                                                  crn_mode="split"))):
        dt, tips, tvs, truns = _measure_train(32, args.iters, args.repeats,
                                              device, args.config, **cfg)
        line[f"train_step_ms_b32{suffix}"] = dt * 1e3
        line[f"train_img_s_b32{suffix}"] = tips
        if not suffix:
            line["train_vs_baseline_b32"] = tvs
        line[f"train_img_s_b32{suffix}_runs"] = truns
    gb = M.bench_inputs(args.batch, engine.vocab)
    serve = _serve_windows(engine, gb, args.iters, args.repeats, device)
    line["serve_img_s_random"] = _median(serve)
    line["serve_img_s_random_runs"] = serve
    turbo = InferenceEngine(engine.vocab, engine.model_kwargs,
                            engine.model.state_dict(), device=str(device),
                            quantize="int8", noise_dtype=torch.bfloat16)
    del engine, fwd, fargs
    _free(device)
    runs = _serve_windows(turbo, gb, args.iters, args.repeats, device)
    line["turbo_img_s"] = _median(runs)
    line["turbo_img_s_runs"] = runs
    line["psnr_reference"] = PSNR_REFERENCE
    return line


def _finite_line(line: dict) -> dict:
    """PSNRs of bit-equal images (+inf) as None; any other non-finite
    number fails the run."""
    out = {}
    for k, v in line.items():
        if k.startswith("psnr") and isinstance(v, float) and v == np.inf:
            v = None
        vals = v if isinstance(v, list) else [v]
        for x in vals:
            if isinstance(x, float) and not np.isfinite(x):
                raise BenchFailure(f"{k} is {x}")
        out[k] = v
    return out


def build_parser():
    p = M.base_parser(__doc__)
    p.add_argument("--config", default="vg128", choices=("vg128", "tiny"),
                   help="tiny: small generators and train config for host "
                        "runs")
    p.add_argument("--batch", type=int, default=None,
                   help="images per forward (default 128) or per train "
                        "step under --mode train (default 32)")
    p.add_argument("--iters", type=int, default=10,
                   help="calls per timing window")
    p.add_argument("--repeats", type=int, default=3,
                   help="timing windows per metric (each reports the "
                        "median and its *_runs)")
    p.add_argument("--extras", type=int, default=1, choices=(0, 1),
                   help="0: only the primary metric")
    p.add_argument("--mode", default="infer", choices=("infer", "train"),
                   help="train: only the COCO-64 GAN step")
    p.add_argument("--bf16", type=int, default=1, choices=(0, 1),
                   help="bf16 CRN compute (the production mode)")
    p.add_argument("--crn_mode", default="split", choices=CRN_MODES,
                   help="the CRN's formulation ('split' in production)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.batch is None:
        args.batch = 32 if args.mode == "train" else 128
    args.repeats = max(1, args.repeats)
    opened = M.open_device(args)
    if opened is None:
        return 1
    device, card = opened
    print(card)
    try:
        line = (main_train if args.mode == "train" else main_infer)(
            args, device)
        line.update(card=card, config=args.config, batch=args.batch,
                    mode=args.mode)
        line = _finite_line(line)
    except BenchFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    text = json.dumps(line, allow_nan=False)
    M.write_report(args.out, "bench", line)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
