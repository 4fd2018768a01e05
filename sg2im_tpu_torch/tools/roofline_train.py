"""Per-section roofline of the GAN train step on the card.

Port of ``scripts/roofline_train.py``.  At the COCO-64 flagship, b32
(``tools.profile_train.coco64``: bench.py:155-184's config and batch), in
the configurations ``baseline`` (f32, 'legacy') and ``fast`` (bf16 CRN,
'split'), each section of the step is timed with CUDA events on the
step's own pieces (``train/step.py``):

* ``g_forward``, ``g_forward_backward`` (G's losses, the discriminators'
  scoring of the fakes, and G's gradients), ``d_obj_step`` and
  ``d_img_step`` (each discriminator's losses on the fakes and the real
  images and its gradients): ``train_step.phase_fns``, on copies of the
  BatchNorm buffers, changing no state;
* ``crop_kernel``: ``ops.crop.crop_bbox_padded`` of the real images, the
  object discriminator's input;
* ``adam_updates``: the three ``SkippableAdam`` updates and their
  ``apply_updates`` on every parameter, with the parameters as stand-in
  gradients (the same bytes and operations);
* ``full_step``: ``train_step`` itself, on the same state each call.

Each row is ``utils.roofline.section_row``'s: ms, FLOPs by type (the
dispatcher's matmuls and convolutions, backward included, through
``FlopCounterMode``'s formulas, plus K1's closed form per forward launch;
K1's backward is plain PyTorch on the card, its recompute of the forward
and the vector-Jacobian product, and counts as such), the bytes it must
move at least (parameters, gradients, Adam moments and the batch in, its
outputs out, each once), the shares of the data sheet's peaks and of the
run's measured ones, and the speed of light (sol_ms, pct_sol,
headroom_x), each operation held to its type's peak: in ``fast`` the CRN
and the discriminators' bf16 work to the bf16 tensor cores', everything
in f32 to f32's.  Each row also
carries ``torch.profiler``'s view of 3 calls: device ms, kernels, and the
idle share of the section's span (the step is host-bound: PERF.md §5).

    python -m sg2im_tpu_torch.tools.roofline_train [--configs baseline,fast]
        [--iters 10] [--out DIR]

Prints one JSON object per configuration and writes
``<out>/roofline_train.json``.  It neither reads nor writes the JAX
package's ``PERF.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from sg2im_tpu_torch.tools import _measure as M
from sg2im_tpu_torch.tools.profile_train import coco64
from sg2im_tpu_torch.utils.flags import int_tuple, str_tuple
from sg2im_tpu_torch.utils.roofline import peaks, section_row, tensor_bytes

CONFIGS = {"baseline": {},
           "fast": dict(bf16_compute=True, crn_mode="split")}


def tiny_coco(batch: int = 4, **kw):
    """A small COCO-shaped config and batch for host runs: 16 x 16 images,
    GCN 16, CRN 16 -> 8, the first ``batch`` rows of the b32 draw (of a
    larger draw past 32)."""
    import dataclasses

    vocab, cfg, full = coco64(max(batch, 32), **kw)
    cfg = dataclasses.replace(
        cfg, batch_size=batch, image_size=(16, 16), embedding_dim=16,
        gconv_dim=16, gconv_hidden_dim=32, gconv_num_layers=2,
        refinement_network_dims=(16, 8), mask_size=4, layout_noise_dim=4,
        crop_size=8, d_obj_arch="C3-8-2", d_img_arch="C3-8-2")
    rows = slice(0, batch)
    batch = {k: v[rows] for k, v in full.items()}
    batch["imgs"] = batch["imgs"][:, ::4, ::4]
    batch["masks"] = batch["masks"][:, :, ::4, ::4]
    return vocab, cfg, batch


def sections(trainer, state, b, noise):
    """[(name, fn, operand bytes)] of the step (module docstring)."""
    from sg2im_tpu_torch.ops.crop import crop_bbox_padded
    from sg2im_tpu_torch.train.step import apply_updates

    fns = trainer.train_step.phase_fns
    imgs_fake = fns["g_forward"](state, b, noise)[0]
    mods = trainer.modules()
    params = {name: {k: getattr(state, name)[k]
                     for k, _ in mods[name].named_parameters()}
              for name in mods if mods[name] is not None}
    pbytes = {name: tensor_bytes(p) for name, p in params.items()}
    good = torch.ones((), dtype=torch.bool, device=b["imgs"].device)

    def adam():
        out = []
        for name, p in params.items():
            upd, opt = trainer.optimizers[name].update(
                p, getattr(state, name + "_opt"), good)
            out.append((apply_updates(p, upd), opt))
        return out

    crop = trainer.config.crop_size
    rows = [
        ("g_forward", lambda: fns["g_forward"](state, b, noise),
         tensor_bytes(state.g, b, noise)),
        ("g_forward_backward",
         lambda: fns["g_forward_backward"](state, b, noise),
         tensor_bytes(state.g, state.d_obj, state.d_img, b, noise)
         + pbytes["g"])]
    for name in ("d_obj", "d_img"):
        if name + "_step" in fns:
            rows.append((name + "_step", lambda n=name: fns[n + "_step"](
                state, b, imgs_fake), tensor_bytes(
                getattr(state, name), b, imgs_fake) + pbytes[name]))
    rows += [
        ("crop_kernel", lambda: crop_bbox_padded(b["imgs"], b["boxes"],
                                                 crop),
         tensor_bytes(b["imgs"], b["boxes"])),
        ("adam_updates", adam, tensor_bytes(
            params, [getattr(state, n + "_opt") for n in params])
         + sum(pbytes.values())),
        ("full_step", lambda: trainer.train_step(state, b, noise=noise),
         tensor_bytes(state, b, noise))]
    return rows


def measure_config(name, extra, device, args, measured):
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.train.trainer import Trainer

    vocab, cfg, batch_np = (coco64 if args.config == "coco64"
                            else tiny_coco)(**extra)
    tr = Trainer(cfg, vocab, device=str(device))
    b = tr.to_device(batch_np)
    state = tr.init_state(seed=0)
    H, W = cfg.image_size
    noise = torch.randn((b["imgs"].shape[0], cfg.layout_noise_dim, H, W),
                        generator=torch.Generator(device=device).manual_seed(
                            0), device=device)
    k1_shape = (b["imgs"].shape[0], b["objs"].shape[1],
                b["masks"].shape[-1], H, W, cfg.gconv_dim)
    rows = []
    with full_fp32():
        for sec, fn, in_bytes in sections(tr, state, b, noise):
            out = fn()  # also the warm-up
            flops, kernels = M.count_flops(fn, k1_shape)
            ms = M.time_ms(fn, device, args.iters)
            row = section_row(sec, ms, flops, in_bytes + tensor_bytes(out),
                              peaks(measured))
            row["hand_kernel_flops"] = kernels
            prof = M.kernel_table(fn, device, iters=3)
            row.update(idle=prof and prof["idle"],
                       device_ms=prof and prof["device_ms"],
                       kernels=prof and prof["kernels"])
            rows.append(row)
    return {"config": name, "train_config": args.config,
            "batch": cfg.batch_size, "sections": rows}


def main(argv=None) -> int:
    p = M.base_parser(__doc__)
    p.add_argument("--configs", type=str_tuple, default=tuple(CONFIGS))
    p.add_argument("--config", default="coco64", choices=("coco64", "tiny"),
                   help="tiny: a small model for host runs")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--peak_size", type=int, default=8192)
    p.add_argument("--stream_shape", type=int_tuple,
                   default=(256, 1024, 1024))
    args = p.parse_args(argv)
    if any(c not in CONFIGS for c in args.configs):
        p.error(f"--configs: each of {sorted(CONFIGS)}")
    opened = M.open_device(args)
    if opened is None:
        return 1
    device, card = opened
    print(card)
    measured = M.measured_peaks(device, args.peak_size, args.stream_shape)
    results = []
    for name in args.configs:
        res = measure_config(name, CONFIGS[name], device, args, measured)
        res.update(card=card, device=str(device), peaks=measured)
        print(json.dumps(res))
        results.append(res)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    M.write_report(args.out, "roofline_train", results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
