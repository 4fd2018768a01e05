"""The serving noise path on the card: an explicit noise tensor against the
engine's seeded draw, at vg128 b128 in the serving mode (bf16, 'split').

Port of ``scripts/profile_seeded_noise.py``.  On bench.py:126-134's
inputs and random weights from seed 0, ``InferenceEngine.generate_batch``
runs

* (a) eager: ``InferenceEngine.draw_noise`` as its own call, then the
  batch on that tensor (passed NHWC, as a caller passes explicit noise);
* (b) seeded: the engine's seeded path, whose ``seeded_noise`` draws the
  batch's noise (the JAX package's threefry normals) in one launch of the
  threefry kernel inside the call;
* (c) zeros: ``noise='zeros'``, the floor without a draw;

each timed on the host clock as the median of ``--windows`` windows of
``--iters`` calls (a new seed per call) with the windows in ``*_runs``.
Also: the draw's own device ms and kernel launches per call
(``torch.profiler``), its ms on CUDA events beside the seeded forward
(``draw_share_pct``), the threefry kernel's launches per draw, and whether
(a) and (b) give bit-identical images at one seed, which the port's seed
contract says they must.

    python -m sg2im_tpu_torch.tools.profile_seeded_noise [--iters 10]
        [--windows 3] [--out DIR]

Prints one JSON object and writes ``<out>/profile_seeded_noise.json``;
exit code 1 if (a) and (b) differ.
"""

from __future__ import annotations

import itertools
import json
import sys

import numpy as np
import torch

from sg2im_tpu_torch.tools import _measure as M


def main(argv=None) -> int:
    p = M.base_parser(__doc__)
    p.add_argument("--config", default="vg128", choices=("vg128", "tiny"),
                   help="tiny: a small generator for host runs")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--windows", type=int, default=3)
    args = p.parse_args(argv)
    opened = M.open_device(args)
    if opened is None:
        return 1
    device, card = opened
    print(card)
    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.ops.prng_kernel import threefry_normal

    vocab, kwargs = (M.vg128_config() if args.config == "vg128"
                     else M.tiny_config())
    engine = InferenceEngine(vocab, kwargs, M.random_state(vocab, kwargs),
                             device=str(device),
                             compute_dtype=torch.bfloat16, crn_mode="split")
    gb = M.bench_inputs(args.batch, vocab)
    N = args.batch
    seeds = itertools.count(2)

    def eager():
        noise = engine.draw_noise(N, next(seeds)).permute(0, 2, 3, 1)
        return engine.generate_batch(gb, noise=noise)["imgs"]

    def seeded():
        return engine.generate_batch(gb, seed=next(seeds))["imgs"]

    def zeros():
        return engine.generate_batch(gb, noise="zeros")["imgs"]

    res = {"card": card, "device": str(device), "config": args.config,
           "batch": N, "mode": "bf16/split"}
    for name, fn in (("eager", eager), ("seeded", seeded), ("zeros", zeros)):
        fn()
        fn()  # warm-up
        runs = M.windows_ms(fn, device, args.windows, args.iters)
        ms = float(np.median(runs))
        res[f"{name}_ms_b{N}"] = ms
        res[f"{name}_ms_b{N}_runs"] = runs
        res[f"{name}_img_s"] = N / ms * 1e3

    def draw():
        return engine.draw_noise(N, next(seeds))

    table = M.kernel_table(draw, device, iters=3)
    res["draw_device_ms"] = table and table["device_ms"]
    res["draw_launches"] = table and table["kernels"]
    res["draw_ms"] = M.time_ms(draw, device, args.iters)
    res["draw_share_pct"] = 100.0 * res["draw_ms"] / res[f"seeded_ms_b{N}"]
    before = threefry_normal.launches
    draw()
    res["draw_threefry_launches"] = threefry_normal.launches - before
    noise = engine.draw_noise(N, 5).permute(0, 2, 3, 1)
    a = engine.generate_batch(gb, noise=noise)["imgs"]
    b = engine.generate_batch(gb, seed=5)["imgs"]
    res["bit_identical"] = bool(torch.equal(a, b))
    res["finite"] = bool(torch.isfinite(a).all())
    res["seeded_vs_eager_pct"] = 100.0 * (
        res[f"eager_ms_b{N}"] / res[f"seeded_ms_b{N}"] - 1.0)
    print(json.dumps(res))
    M.write_report(args.out, "profile_seeded_noise", res)
    return 0 if res["bit_identical"] and res["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
