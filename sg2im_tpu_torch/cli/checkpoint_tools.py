"""Checkpoint introspection and slimming (counterpart of
``sg2im_tpu/cli/checkpoint_tools.py``, upstream ``scripts/print_args.py``
and ``scripts/strip_checkpoint.py``), on reference-layout ``.pt`` files
and the port's native checkpoint directories.

    python -m sg2im_tpu_torch.cli.checkpoint_tools print_args CKPT
    python -m sg2im_tpu_torch.cli.checkpoint_tools strip IN.pt OUT.pt \\
        [--keep_discriminators 1]
    python -m sg2im_tpu_torch.cli.checkpoint_tools clean IN.pt OUT.pt
    python -m sg2im_tpu_torch.cli.checkpoint_tools export NATIVE_DIR OUT.pt

``export`` writes the generator of a checkpoint directory of the port's
Trainer or of the JAX package's (``ckpt.store``: ``state.pt`` or
``state.msgpack``, and ``meta.json``) as a
reference-layout ``.pt`` that upstream's ``Sg2ImModel``, the JAX package's
``convert_checkpoint`` and the port's ``run_model`` read.  Everything
runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_any(path):
    """A ``.pt`` as its dict (tensors and plain containers only), or a
    native directory's training config under ``args``."""
    if os.path.isdir(path):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return {"args": (meta.get("config") or {}), "_native": True}
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def print_args(path: str):
    """Print the training args stored in a checkpoint (upstream
    ``scripts/print_args.py``)."""
    args = _load_any(path).get("args") or {}
    for k in sorted(args):
        print(f"{k}: {args[k]}")
    return 0


def _require_pt(ckpt, subcommand: str):
    """strip and clean work on .pt dicts: a native directory has no
    model_state here, and they would write a weightless .pt."""
    if ckpt.get("_native"):
        print(f"ERROR: {subcommand} operates on .pt checkpoints; for a "
              f"native checkpoint directory use "
              f"'checkpoint_tools export DIR OUT.pt' first")
        return False
    return True


def strip(in_path: str, out_path: str, keep_discriminators: bool = True):
    """A .pt cut down to what inference needs (upstream
    ``strip_checkpoint.py:54-63``: args, model_state, model_kwargs, and the
    discriminators' pairs when kept)."""
    import torch

    ckpt = _load_any(in_path)
    if not _require_pt(ckpt, "strip"):
        return 1
    keep = ["args", "model_state", "model_kwargs"]
    if keep_discriminators:
        keep += ["d_img_state", "d_img_kwargs", "d_obj_state", "d_obj_kwargs"]
    out = {k: v for k, v in ckpt.items() if k in keep}
    torch.save(out, out_path)
    print(f"Wrote stripped checkpoint to {out_path} "
          f"(kept {sorted(out.keys())})")
    return 0


def clean(in_path: str, out_path: str):
    """A .pt without the deprecated model kwargs (upstream
    ``strip_old_args.py:31-35``)."""
    import torch

    from sg2im_tpu_torch.ckpt import DEPRECATED_MODEL_KWARGS

    ckpt = _load_any(in_path)
    if not _require_pt(ckpt, "clean"):
        return 1
    kw = dict(ckpt.get("model_kwargs") or {})
    removed = [k for k in DEPRECATED_MODEL_KWARGS if k in kw]
    for k in removed:
        del kw[k]
    ckpt["model_kwargs"] = kw
    torch.save(ckpt, out_path)
    print(f"Wrote {out_path} (removed deprecated kwargs: {removed})")
    return 0


def export(native_dir: str, out_path: str):
    """The generator of a native checkpoint directory (either format of
    ``ckpt.store``) as a reference-layout .pt, with its training config as
    ``args``."""
    from sg2im_tpu_torch.ckpt import export_reference_checkpoint
    from sg2im_tpu_torch.ckpt.store import load_checkpoint
    from sg2im_tpu_torch.train.config import TrainConfig

    try:
        state, meta = load_checkpoint(native_dir)
    except ValueError as e:  # no state file of either Trainer
        print(f"ERROR: not a checkpoint directory: {e}")
        return 1
    cfg_dict = meta.get("config") or {}
    config = TrainConfig.from_dict(cfg_dict)
    export_reference_checkpoint(out_path, state.g,
                                config.generator_kwargs(), meta.get("vocab"),
                                args=cfg_dict)
    print(f"Exported generator to {out_path}")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pa = sub.add_parser("print_args")
    pa.add_argument("checkpoint")
    ps = sub.add_parser("strip")
    ps.add_argument("input_checkpoint")
    ps.add_argument("output_checkpoint")
    ps.add_argument("--keep_discriminators", type=int, default=1)
    pc = sub.add_parser("clean")
    pc.add_argument("input_checkpoint")
    pc.add_argument("output_checkpoint")
    pe = sub.add_parser("export")
    pe.add_argument("native_dir")
    pe.add_argument("output_checkpoint")
    args = p.parse_args(argv)
    if args.cmd == "print_args":
        return print_args(args.checkpoint)
    if args.cmd == "clean":
        return clean(args.input_checkpoint, args.output_checkpoint)
    if args.cmd == "export":
        return export(args.native_dir, args.output_checkpoint)
    return strip(args.input_checkpoint, args.output_checkpoint,
                 bool(args.keep_discriminators))


if __name__ == "__main__":
    raise SystemExit(main())
