"""run_model CLI: JSON scene graphs -> PNG images, on a CUDA card by default.

Counterpart of ``sg2im_tpu/cli/run_model.py`` (upstream
``scripts/run_model.py``).  Takes reference-layout ``.pt`` checkpoints as
they are.

Example:
    python -m sg2im_tpu_torch.cli.run_model \
        --checkpoint artifacts/trained_coco64.pt \
        --scene_graphs_json artifacts/trained_scene_graphs.json \
        --output_dir outputs --noise zeros
    # the int8 turbo tier at scales saved by save_calibration:
    #   ... --bf16_compute 1 --crn_mode split --quantize int8 \
    #   --calibration_file calibration.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", default="sg2im-models/vg128.pt")
    parser.add_argument("--scene_graphs_json",
                        default="scene_graphs/figure_6_sheep.json")
    parser.add_argument("--output_dir", default="outputs")
    parser.add_argument("--draw_scene_graphs", type=int, default=0,
                        help="1: also render each scene graph to "
                             "sg%%06d.png with GraphViz's dot (warns and "
                             "skips where dot is missing)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; 'cuda' fails without "
                             "a GPU rather than running on the CPU")
    parser.add_argument("--noise", default="random",
                        choices=["random", "zeros"],
                        help="layout noise: seeded draws (--seed) or zeros")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layout_noise_npy", default=None,
                        help="optional .npy (N, H, W, D) layout noise")
    parser.add_argument("--bf16_compute", type=int, default=0,
                        help="1: bf16 CRN chain (the serving mode); 0: "
                             "float32 throughout")
    parser.add_argument("--crn_mode", default=None,
                        choices=["legacy", "split"],
                        help="CRN stage conv0 formulation; 'split' never "
                             "stores the stage's wide concat")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="turbo tier: the high-resolution CRN stage "
                             "convs run int8 at calibrated activation "
                             "scales (an accuracy trade; checkpoints are "
                             "unaffected)")
    parser.add_argument("--calibration_file", default=None,
                        help="int8 tier: load activation scales saved by "
                             "save_calibration (either package); without "
                             "it the engine calibrates on the request "
                             "batch itself")
    parser.add_argument("--dense_precision", default=None,
                        choices=["high", "highest"],
                        help="the JAX CLI's Dense precision; only 'highest' "
                             "is accepted (and changes nothing): the GCN "
                             "and heads always run in true float32")
    parser.add_argument("--noise_impl", default=None,
                        choices=["threefry", "rbg"],
                        help="PRNG for --noise random: 'threefry' (the "
                             "default, the JAX package's draws); 'rbg' is "
                             "refused (XLA's RngBitGenerator has no single "
                             "reference to match)")
    parser.add_argument("--deprocess_device", type=int, default=0,
                        help="accepted so that the JAX CLI's command lines "
                             "stay valid: the port always deprocesses on "
                             "the engine's device, bit-equal to the host "
                             "deprocess, and fetches uint8")
    return parser


def main(args=None):
    args = build_parser().parse_args(args)
    if not os.path.isfile(args.checkpoint):
        print(f'ERROR: Checkpoint file "{args.checkpoint}" not found')
        return 1
    if args.calibration_file and args.quantize != "int8":
        print("ERROR: --calibration_file requires --quantize int8")
        return 1
    if args.dense_precision not in (None, "highest"):
        print(f"ERROR: --dense_precision {args.dense_precision} is refused: "
              "the GCN and heads run in true float32 (TF32 off), which is "
              "'highest'")
        return 1
    if args.noise_impl == "rbg":
        from sg2im_tpu_torch.inference import RBG_REFUSED

        print(f"ERROR: --noise_impl rbg is refused: {RBG_REFUSED}")
        return 1
    os.makedirs(args.output_dir, exist_ok=True)

    import torch
    from PIL import Image

    from sg2im_tpu_torch.inference import InferenceEngine

    engine = InferenceEngine.from_torch_checkpoint(
        args.checkpoint, device=args.device,
        compute_dtype=torch.bfloat16 if args.bf16_compute else None,
        crn_mode=None if args.crn_mode == "legacy" else args.crn_mode,
        quantize=args.quantize, noise_impl=args.noise_impl)
    if args.calibration_file:
        engine.load_calibration(args.calibration_file)
    with open(args.scene_graphs_json) as f:
        scene_graphs = json.load(f)
    if isinstance(scene_graphs, dict):
        scene_graphs = [scene_graphs]

    noise = "zeros" if args.noise == "zeros" else None
    if args.layout_noise_npy:
        noise = np.load(args.layout_noise_npy)
    imgs, _ = engine.generate(scene_graphs, noise=noise, seed=args.seed)
    for i in range(len(scene_graphs)):
        path = os.path.join(args.output_dir, "img%06d.png" % i)
        Image.fromarray(imgs[i]).save(path)
    print(f"Wrote {len(scene_graphs)} images to {args.output_dir}")

    if args.draw_scene_graphs == 1:
        from sg2im_tpu_torch.utils.vis import draw_scene_graph, have_graphviz

        if not have_graphviz():
            print("WARNING: graphviz 'dot' not found; skipping scene graphs")
        else:
            for i, sg in enumerate(scene_graphs):
                sg_img = draw_scene_graph(sg["objects"], sg["relationships"])
                path = os.path.join(args.output_dir, "sg%06d.png" % i)
                Image.fromarray(sg_img).save(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
