"""The turbo tier's frontier on the card: fidelity against throughput for
each band of int8 stages.

Port of ``scripts/profile_turbo_frontier.py``.  Rows: the bf16 / 'split'
serving mode unquantized (``production``), the JAX script's ``CONFIGS``
(the int8 tier at each band of ``quant_opts``: ``turbo_r4`` s3-s5 and the
head's 3x3, ``head_exempt``, ``s5_exempt`` the engine's default band,
``s3s4_only_head``) and its ``noise_downsample`` rows (``prod_nd2``,
``turbo_nd2``: the seeded draw at half resolution).  The JAX script's
``prod_dod`` row is gone: the port always deprocesses on the device; so
is its ``noise_impl`` option: the port draws threefry alone ('rbg' has no
single reference to match).

Per row, on random vg128 weights from seed 0:

* u8 PSNR (and raw PSNR in the preprocessed space) of the gate graphs
  (``scripts/attrib_psnr.py``'s four flagship graphs) with zero noise
  against the ground: the port's own float32 engine on the CPU, as
  ``chip_smoke.py`` grounds its turbo figures.  An int8 row calibrates on
  half of the graphs and scores all of them, production-shaped.  The
  ``noise_downsample`` rows take their base row's figure: zero noise does
  not see the draw;
* throughput at b128 on the seeded path (bench.py:126-134's inputs), the
  median of ``--windows`` windows of ``--iters`` calls, with the windows'
  img/s in ``img_s_runs``, and the change against ``production``.

    python -m sg2im_tpu_torch.tools.profile_turbo_frontier [--iters 10]
        [--windows 3] [--out DIR]

Prints one JSON object per row and writes
``<out>/profile_turbo_frontier.json``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from sg2im_tpu_torch.tools import _measure as M

CONFIGS = [
    ("turbo_r4", {"max_res": None}, "s3/s4/s5 + head 3x3"),
    ("head_exempt", {"head": False, "max_res": None},
     "s3/s4/s5, head unquantized"),
    ("s5_exempt", {"max_res": 64}, "s3/s4 only: the engine's default band"),
    ("s3s4_only_head", {"max_res": 64, "head": True},
     "as s5_exempt (the head needs the last stage quantized)"),
]
EXTRA_ROWS = [
    ("prod_nd2", "production", {"noise_downsample": 2},
     "production + half-resolution noise draw"),
    ("turbo_nd2", "s5_exempt", {"noise_downsample": 2},
     "the default turbo band + half-resolution noise draw"),
]


def gate_graphs(vocab) -> list[dict]:
    """``scripts/attrib_psnr.py``'s flagship gate graphs over ``vocab``."""
    m = min(len(vocab["object_idx_to_name"]) - 1, 14)
    pm = len(vocab["pred_idx_to_name"]) - 1
    return [
        {"objects": [f"o{1 + i % m}" for i in range(3)],
         "relationships": [[0, f"p{1 + 0 % pm}", 1],
                           [2, f"p{1 + 1 % pm}", 0]]},
        {"objects": [f"o{1 + (3 + i) % m}" for i in range(4)],
         "relationships": [[0, f"p{1 + 2 % pm}", 1], [1, f"p{1 + 3 % pm}", 2],
                           [3, f"p{1 + 4 % pm}", 0]]},
        {"objects": [f"o{1 + (7 + i) % m}" for i in range(2)],
         "relationships": [[0, f"p{1 + 5 % pm}", 1]]},
        {"objects": [f"o{1 + (9 + i) % m}" for i in range(5)],
         "relationships": [[0, f"p{1 + 6 % pm}", 4], [1, f"p{1 + 7 % pm}", 2],
                           [2, f"p{1 + 8 % pm}", 3]]},
    ]


def rows():
    """[(name, engine kwargs beyond the serving mode, base row or None)]."""
    out = [("production", {}, None)]
    # The int8 rows draw their noise in bfloat16, as the JAX script's do.
    out += [(name, {"quantize": "int8", "quant_opts": qo,
                    "noise_dtype": torch.bfloat16}, None)
            for name, qo, _ in CONFIGS]
    base = {name: kw for name, kw, _ in out}
    out += [(name, dict(base[b], **ov), b) for name, b, ov, _ in EXTRA_ROWS]
    return out


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
    from sg2im_tpu_torch.utils.metrics import psnr

    vocab, kwargs = (M.vg128_config() if args.config == "vg128"
                     else M.tiny_config())
    state = M.random_state(vocab, kwargs, device=device)
    sgs = gate_graphs(vocab)
    ground = InferenceEngine(vocab, kwargs, state, device="cpu")
    ref_u8, ref_out = ground.generate(sgs, noise="zeros")
    ref_raw = ref_out["imgs"].numpy()
    gb = M.bench_inputs(args.batch, vocab)
    serving = dict(compute_dtype=torch.bfloat16, crn_mode="split")
    results, fidelity = [], {}
    for name, kw, base in rows():
        row = {"config": name, "engine_kwargs": {
            k: str(v) if isinstance(v, torch.dtype) else v
            for k, v in kw.items() if k != "quantize"},
            "quantize": kw.get("quantize"), "card": card,
            "device": str(device)}
        if base is None:
            eng = InferenceEngine(vocab, kwargs, state, device=str(device),
                                  **serving, **kw)
            if eng.model_kwargs.get("crn_quant"):
                eng.calibrate(sgs[: max(1, len(sgs) // 2)], noise="zeros")
            u8, out = eng.generate(sgs, noise="zeros")
            raw = out["imgs"].float().cpu().numpy()
            fidelity[name] = (psnr(u8, ref_u8, 255.0), psnr(raw, ref_raw,
                                                            1.0))
            del eng
        row["psnr_u8_db"], row["psnr_raw_db"] = fidelity[base or name]
        row["fidelity_of"] = base or name
        eng = InferenceEngine(vocab, kwargs, state, device=str(device),
                              **serving, **kw)
        seed = iter(range(10 ** 9))

        def serve():
            return eng.generate_batch(gb, seed=next(seed))["imgs"]

        imgs = serve()  # calibrates an int8 engine on its first batch
        serve()
        ms = M.windows_ms(serve, device, args.windows, args.iters)
        row["img_s_runs"] = [args.batch / m * 1e3 for m in ms]
        row["img_s"] = float(np.median(row["img_s_runs"]))
        row["finite"] = bool(torch.isfinite(imgs).all())
        if eng.model_kwargs.get("crn_quant"):
            row["quant_band"] = eng.quant_band()
        del eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
        results.append(row)
    prod = results[0]["img_s"]
    for row in results:
        row["vs_production_pct"] = 100.0 * (row["img_s"] / prod - 1.0)
        print(json.dumps(row))
    M.write_report(args.out, "profile_turbo_frontier", results)
    return 0 if all(r["finite"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
