"""verify_pretrained CLI: the fidelity gate, as one command.

Counterpart of ``sg2im_tpu/cli/verify_pretrained.py``.  Given a
reference-layout ``.pt`` checkpoint and scene-graph JSONs, renders images
with zero layout noise on a CUDA card (or ``--device cpu``), writes them as
PNGs, and scores u8 PSNR against golden PNGs (``--golden_dir``: one
``img%06d.png`` per graph, concatenated across the JSONs in order), per
JSON and over all.  Exits 0 iff every comparison clears ``--min_psnr``
(default 40 dB), 2 if one falls short, and 1 on a missing checkpoint,
missing golden image or nothing to compare against.

The JAX CLI's ``--run_reference`` / ``--reference_repo`` (the upstream
model run in-process) are left out: they need the upstream ``sg2im``
checkout.

Example:
    python -m sg2im_tpu_torch.cli.verify_pretrained \\
        --checkpoint artifacts/trained_coco64.pt \\
        --scene_graphs_json artifacts/trained_scene_graphs.json \\
        --golden_dir goldens --output_dir /tmp/verify_out
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="Reference .pt checkpoint (full or stripped)")
    p.add_argument("--scene_graphs_json", nargs="+",
                   default=["scene_graphs/figure_5_vg.json",
                            "scene_graphs/figure_6_sheep.json",
                            "scene_graphs/figure_6_street.json"],
                   help="One or more scene-graph JSON files")
    p.add_argument("--output_dir", default="verify_outputs")
    p.add_argument("--golden_dir", default=None,
                   help="Directory of golden PNGs named img%%06d.png (one "
                        "per graph, concatenated across JSONs in order); "
                        "compared in uint8 space")
    p.add_argument("--min_psnr", type=float, default=40.0)
    p.add_argument("--conv_precision", default="default",
                   choices=["default", "high", "highest"],
                   help="accepted and ignored, so that the JAX CLI's "
                        "command lines stay valid: the engine runs every "
                        "forward with TF32 off (true float32)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a card rather "
                        "than running on the CPU")
    return p


def _load_graphs(paths):
    all_graphs, spans = [], []
    for path in paths:
        with open(path) as f:
            sgs = json.load(f)
        if isinstance(sgs, dict):
            sgs = [sgs]
        spans.append((path, len(all_graphs), len(sgs)))
        all_graphs.extend(sgs)
    return all_graphs, spans


def main(args=None):
    args = build_parser().parse_args(args)
    if not os.path.isfile(args.checkpoint):
        print(f'ERROR: Checkpoint file "{args.checkpoint}" not found')
        return 1
    os.makedirs(args.output_dir, exist_ok=True)

    from PIL import Image

    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.utils.metrics import psnr

    scene_graphs, spans = _load_graphs(args.scene_graphs_json)
    engine = InferenceEngine.from_torch_checkpoint(args.checkpoint,
                                                   device=args.device)
    got_u8, _ = engine.generate(scene_graphs, noise="zeros")
    for i in range(len(scene_graphs)):
        Image.fromarray(got_u8[i]).save(
            os.path.join(args.output_dir, "img%06d.png" % i))
    print(f"Wrote {len(scene_graphs)} images to {args.output_dir}")

    if not args.golden_dir:
        print("ERROR: nothing to compare against: pass --golden_dir")
        return 1
    golden = []
    for i in range(len(scene_graphs)):
        path = os.path.join(args.golden_dir, "img%06d.png" % i)
        if not os.path.isfile(path):
            print(f"ERROR: missing golden image {path}")
            return 1
        golden.append(np.asarray(Image.open(path).convert("RGB")))
    golden = np.stack(golden)
    results = {}
    for path, off, n in spans:
        results[f"golden_u8:{os.path.basename(path)}"] = psnr(
            got_u8[off:off + n], golden[off:off + n])
    results["golden_u8:ALL"] = psnr(got_u8, golden)

    ok = True
    for name, val in results.items():
        status = "OK " if val >= args.min_psnr else "LOW"
        ok &= val >= args.min_psnr
        print(f"  [{status}] {name}: {val:.2f} dB (min {args.min_psnr})")
    print(json.dumps({"psnr": {k: round(v, 2) for k, v in results.items()},
                      "pass": bool(ok)}))
    return 0 if ok else 2


if __name__ == "__main__":
    raise SystemExit(main())
