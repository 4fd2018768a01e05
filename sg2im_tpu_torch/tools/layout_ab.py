"""K1, the layout compose from boxes, of this checkout against K1 of
another checkout, in turns on one card.

    python -m sg2im_tpu_torch.tools.layout_ab --other ROOT [--out DIR]

Each checkout's K1 is called through its own
``ops.layout_kernel.layout_compose``, the wrapper every caller uses, whose
signature does not change with the kernel's entry or plan: so a checkout
(the parent's ``git archive``, say) is timed as it ships, its kernel built
by its own ``ops/_build.py`` into its own build directory.  Each checkout
runs in a process of its own, with its root alone on the path (this file
run as a script with ``--worker``): the other, this checkout, then the
same in reverse.

At the serving path's batch-128 shape (``_measure.LAYOUT_TIMED``) on
``_measure.layout_inputs``' seed-7 inputs, for f32 and bf16 output: each
checkout's first process writes its outputs, which this process holds to
the plain version (f32 within ``KERNEL_BAR`` abs, bf16 within one
rounding), and every process times both with CUDA events over ``ITERS``
calls.  Each row keeps the lower of its two turns and prints both, with
its share of the bound (``utils/roofline.layout_bounds`` at the output's
element size) and its GB/s beside a ``fill_`` of the output's bytes.
Exits 1 without a card or when a checkout's K1 disagrees.  Writes
``<out>/layout_ab.json``.
"""

# The package is imported inside the functions: the worker's comes from the
# checkout it times, which need not have this file.
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
OUT_TYPES = (("f32", torch.float32, 4), ("bf16", torch.bfloat16, 2))
ITERS = 50  # calls a turn


def worker(argv) -> int:
    """One checkout's K1 (the package on this process's path) on the saved
    inputs: each output type written where asked, then timed; prints
    ``{"module": <the wrapper's file>, "f32": ms, "bf16": ms}``."""
    from sg2im_tpu_torch.ops import layout_kernel as lk
    from sg2im_tpu_torch.tools._measure import time_ms

    p = argparse.ArgumentParser()
    p.add_argument("inputs")
    p.add_argument("--device", required=True)
    p.add_argument("--iters", type=int, required=True)
    p.add_argument("--save")
    args = p.parse_args(argv)
    saved = torch.load(args.inputs)
    boxes, masks, vecs = (saved[k].to(args.device)
                          for k in ("boxes", "masks", "vecs"))
    H, W = saved["H"], saved["W"]
    result = {"module": lk.__file__}
    for tag, dtype, _ in OUT_TYPES:
        def run(dtype=dtype):
            return lk.layout_compose(boxes, masks, vecs, H, W,
                                     out_dtype=dtype)
        if args.save:
            torch.save(run().cpu(), Path(args.save) / f"{tag}.pt")
        result[tag] = time_ms(run, args.device, iters=args.iters)
    print(json.dumps(result))
    return 0


def run_worker(root: Path, inputs: Path, device, iters: int, save) -> dict:
    """{tag: ms} of the checkout at ``root``, timed in a process of its
    own; its outputs written into ``save`` when given."""
    from sg2im_tpu_torch.tools._measure import run_worker as run

    argv = [inputs, "--device", device, "--iters", iters]
    return run(Path(__file__).resolve(), root,
               argv + (["--save", save] if save is not None else []))


def check_saved(save: Path, want, device) -> dict:
    """{tag: max abs error} of a worker's outputs against the plain
    version; raises past the bars."""
    from sg2im_tpu_torch.tools._measure import (
        KERNEL_BAR,
        within_one_rounding,
    )

    errs = {}
    for tag, dtype, _ in OUT_TYPES:
        out = torch.load(save / f"{tag}.pt").to(device)
        if out.dtype != dtype or out.shape != want.shape:
            raise AssertionError(f"{tag} output {out.dtype} "
                                 f"{tuple(out.shape)}")
        errs[tag] = (out.float() - want).abs().max().item()
        ok = (errs[tag] <= KERNEL_BAR if tag == "f32"
              else within_one_rounding(out, want))
        if not ok:
            raise AssertionError(f"{tag} output disagrees with the plain "
                                 f"version: {errs[tag]:.3e}")
    return errs


def compare(others: list[str], device, shape, iters: int) -> dict:
    """The A/B at ``shape`` (N, O, M, H, W, D) on ``device``: per checkout
    and output type its turns, its max abs error and its bound."""
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.ops import _build
    from sg2im_tpu_torch.ops import layout_kernel as lk
    from sg2im_tpu_torch.tools import _measure as M
    from sg2im_tpu_torch.utils.roofline import (
        F32_FLOPS,
        layout_bounds,
        roofline_ms,
    )

    N, O, Mside, H, W, D = shape
    names = [f"other:{o}" for o in others] + ["this"]
    roots = [Path(o).resolve() for o in others] + [REPO]
    boxes, masks, vecs = M.layout_inputs(N, O, Mside, H, W, D, seed=7,
                                         device=device)
    with full_fp32():
        want = lk.layout_compose_ref(boxes, masks, vecs, H, W)
    turns = {(name, tag): [] for name in names for tag, _, _ in OUT_TYPES}
    errs = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        inputs = Path(work) / "inputs.pt"
        torch.save({"boxes": boxes.cpu(), "masks": masks.cpu(),
                    "vecs": vecs.cpu(), "H": H, "W": W}, inputs)
        order = list(range(len(roots)))
        for i in order + order[::-1]:
            save = None if names[i] in errs else Path(work)
            ms = run_worker(roots[i], inputs, device, iters, save)
            if save is not None:
                try:
                    errs[names[i]] = check_saved(save, want, device)
                except AssertionError as e:
                    raise AssertionError(f"{names[i]}: {e}") from None
            for tag, _, _ in OUT_TYPES:
                turns[names[i], tag].append(ms[tag])
    del want
    rows = []
    for tag, dtype, elem in OUT_TYPES:
        bound, by = roofline_ms(*layout_bounds(N, O, Mside, H, W, D, False,
                                               out_elem=elem), F32_FLOPS)
        out_gb = N * H * W * D * elem / 1e9
        dst = torch.empty((N, H, W, D), dtype=dtype, device=device)
        fill = M.time_ms(lambda: dst.fill_(1.0), device, iters=iters)
        del dst
        for name in names:
            ms = min(turns[name, tag])
            rows.append({"checkout": name, "out": tag, "ms": ms,
                         "turns": turns[name, tag], "bound_ms": bound,
                         "bound_by": by, "pct_of_bound": 100 * bound / ms,
                         "out_gb": out_gb, "gb_s": out_gb / ms * 1e3,
                         "fill_ms": fill, "max_abs_err": errs[name][tag]})
    return {"shape": list(shape), "iters": iters,
            "plan": lk.boxes_plan(O, H, W, Mside, D)._asdict(), "rows": rows}


def main(argv=None) -> int:
    from sg2im_tpu_torch.tools import _measure as M

    p = M.base_parser(__doc__)
    p.add_argument("--other", required=True,
                   help="the root of another checkout")
    args = p.parse_args(argv)
    opened = M.open_device(args)
    if opened is None:
        return 1
    device, card = opened
    if device.type != "cuda":
        print("FAIL: layout_ab times kernels; it needs --device cuda",
              file=sys.stderr)
        return 1
    try:
        report = compare([args.other], device, M.LAYOUT_TIMED, ITERS)
    except AssertionError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    report["card"] = card
    N, O, Mside, H, W, D = M.LAYOUT_TIMED
    for row in report["rows"]:
        print(f"[layout_ab] {row['out']} out at N{N} O{O} M{Mside} {H}x{W} "
              f"D{D}, {row['checkout']}: {row['ms']:.4f} ms (turns "
              f"{', '.join(f'{v:.4f}' for v in row['turns'])}), "
              f"{row['pct_of_bound']:.1f}% of its {row['bound_ms']:.4f} ms "
              f"{row['bound_by']} bound, {row['gb_s']:.0f} GB/s against a "
              f"fill_ of {row['out_gb']:.3f} GB {row['fill_ms']:.4f} ms, "
              f"max_abs_err {row['max_abs_err']:.3e}; on {card}")
    M.write_report(args.out, "layout_ab", report)
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"]
             else main())
