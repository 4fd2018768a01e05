"""Per-stage CRN times on the card, in every conv0 mode of the port.

Port of ``scripts/profile_crn.py``.  At vg128 b128 in bf16, each CRN
stage (layout resolution 8 ... 128; feats 1, 1024, 512, 256, 128
channels at half the resolution; 1024 ... 64 out; eval BatchNorm,
LeakyReLU 0.2) is one ``RefinementModule`` with the weights of that
stage of the generator that the JAX package's init gives ``PRNGKey(0)``
(``nn/init.py``), timed alone with CUDA events in each mode:

* legacy (upsample, concat, one conv), split (the layout and the
  upsampled feats convolved apart), phase (the feats branch as four phase
  kernels at the coarse resolution, interleaved by K3's depth_to_space),
  packed (the stage in the space-to-depth domain: K3's space_to_depth of
  the layout level, the stage's ``packed`` entry, depth_to_space of its
  output; timed at every stage, where the network packs those at 32 and
  above) and split_noise (split with the 32 noise channels apart);
* and the pieces of the factored conv0: the layout branch alone
  (``conv(layout, W[:, :L])``), the feats branch alone (split: the conv of
  the upsampled feats; phase: the four phase kernels at the coarse
  resolution) and the interleave (K3's depth_to_space of the phase
  output).

Before timing, every mode's output is held against legacy's on the same
input and weights in float32 with TF32 off (exact reformulations: within
f32 round-off: ``BAR`` relative to max |legacy|), which is what makes a
per-stage time an attribution.

    python -m sg2im_tpu_torch.tools.profile_crn [--iters 20] [--out DIR]

Prints one JSON object per stage and writes ``<out>/profile_crn.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from sg2im_tpu_torch.nn import crn
from sg2im_tpu_torch.ops.relayout import depth_to_space, space_to_depth
from sg2im_tpu_torch.tools import _measure as M
from sg2im_tpu_torch.utils.flags import int_tuple

MODES = ("legacy", "split", "phase", "packed", "split_noise")
BAR = 1e-4  # max |mode - legacy| / max |legacy| in float32
LAYOUT_DIM, NOISE_DIM = 160, 32   # GCN 128 + noise 32


def stage_shapes(H: int, dims) -> list[tuple]:
    """[(layout resolution, feats channels, out channels)] of the CRN of
    ``dims`` for an H-row image."""
    n = len(dims)
    return [(H >> (n - 1 - i), 1 if i == 0 else dims[i - 1], dims[i])
            for i in range(n)]


def stage_modules(L: int, cin: int, co: int, device, stage: int) -> dict:
    """{mode: RefinementModule} sharing one set of weights: those of the
    generator's CRN stage ``stage`` (0-based) under the JAX package's init
    of ``PRNGKey(0)``."""
    from sg2im_tpu_torch.nn import init
    from sg2im_tpu_torch.ops.prng import prng_key

    base = crn.RefinementModule(L, cin, co, "batch",
                                "leakyrelu-0.2").to(device)
    init.reset_parameters(base, "g", prng_key(0),
                          prefix=f"refinement_net.refinement_modules.{stage}.")
    mods = {}
    for mode in MODES:
        conv0_mode = {"packed": "legacy", "split_noise": "split"}.get(mode,
                                                                      mode)
        m = crn.RefinementModule(L, cin, co, "batch", "leakyrelu-0.2",
                                 conv0_mode=conv0_mode)
        m.load_state_dict(base.state_dict())
        mods[mode] = m.eval().to(device).to(memory_format=torch.channels_last)
    return mods


def stage_call(mode, mod, layout, feats, dtype):
    """One stage's forward in ``mode`` -> (N, co, res, res)."""
    if mode == "packed":
        out = mod.packed(space_to_depth(crn._channels_last(layout)), feats,
                         dtype)
        return depth_to_space(crn._channels_last(out))
    if mode == "split_noise":
        L = layout.shape[1] - NOISE_DIM
        return mod(layout[:, :L], feats, dtype,
                   noise=layout[:, L:].contiguous(
                       memory_format=torch.channels_last))
    return mod(layout, feats, dtype)


def conv0_pieces(mod, layout, feats, dtype) -> dict:
    """{piece: fn} of the factored conv0 of a split / phase stage."""
    conv0 = mod.net[0]
    L = conv0.layout_dim
    w = conv0.weight.to(dtype)
    co = w.shape[0]
    kb = crn._packed_kernel_aliased(conv0.weight[:, L:].float()).to(dtype)
    x, f = layout.to(dtype), feats.to(dtype)
    phase_out = crn._channels_last(crn._packed_conv_apply(f, kb, co))
    return {
        "layout_only": lambda: crn._conv3x3(x, w[:, :L]),
        "feats_only_split": lambda: crn._conv3x3(
            crn.upsample_nearest(f, 2), w[:, L:]),
        "feats_only_phase": lambda: crn._packed_conv_apply(f, kb, co),
        "interleave_d2s": lambda: depth_to_space(phase_out),
    }


def main(argv=None) -> int:
    p = M.base_parser(__doc__)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--image", type=int, default=128)
    p.add_argument("--dims", type=int_tuple, default=(1024, 512, 256, 128,
                                                      64))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    opened = M.open_device(args)
    if opened is None:
        return 1
    device, card = opened
    print(card)
    from sg2im_tpu_torch.inference import full_fp32

    gen = torch.Generator(device=device).manual_seed(1)
    rows, ok = [], True
    with torch.inference_mode(), full_fp32():
        for s, (res, cin, co) in enumerate(stage_shapes(args.image,
                                                        args.dims), 1):
            mods = stage_modules(LAYOUT_DIM, cin, co, device, s - 1)
            layout = torch.randn((args.batch, LAYOUT_DIM, res, res),
                                 generator=gen, device=device).contiguous(
                memory_format=torch.channels_last)
            feats = torch.randn((args.batch, cin, res // 2, res // 2),
                                generator=gen, device=device).contiguous(
                memory_format=torch.channels_last)
            want = stage_call("legacy", mods["legacy"], layout, feats,
                              torch.float32)
            scale = float(want.abs().max())
            errs = {m: float((stage_call(m, mods[m], layout, feats,
                                         torch.float32) - want).abs().max())
                    / scale for m in MODES}
            agree = all(e <= BAR for e in errs.values())
            ok &= agree
            lb, fb = layout.to(torch.bfloat16), feats.to(torch.bfloat16)
            ms = {m: M.time_ms(lambda m=m: stage_call(
                m, mods[m], lb, fb, torch.bfloat16), device, args.iters)
                for m in MODES}
            pieces = {k: M.time_ms(fn, device, args.iters) for k, fn in
                      conv0_pieces(mods["split"], lb, fb,
                                   torch.bfloat16).items()}
            row = {"stage": s, "res": res, "feats_ch": cin, "out_ch": co,
                   "batch": args.batch, "ms": ms, "conv0_pieces_ms": pieces,
                   "rel_err_vs_legacy_f32": errs, "modes_agree": agree,
                   "device": str(device), "card": card}
            print(json.dumps(row))
            rows.append(row)
            del mods
    totals = {m: sum(r["ms"][m] for r in rows) for m in MODES}
    M.write_report(args.out, "profile_crn", {
        "card": card, "device": str(device), "batch": args.batch,
        "dtype": "bf16", "stages": rows, "total_ms": totals,
        "modes_agree": ok, "bar": BAR})
    print(json.dumps({"total_ms": totals, "modes_agree": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
