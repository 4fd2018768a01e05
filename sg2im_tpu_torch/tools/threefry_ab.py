"""T1, the threefry normal kernel, of this checkout against T1 of another
checkout, in turns on one card.

    python -m sg2im_tpu_torch.tools.threefry_ab --other ROOT [--out DIR]

Each checkout's T1 is called through its own
``ops.prng_kernel.threefry_normal``, the wrapper every caller uses, whose
signature does not change with the kernel's entry or plan: so a checkout
(the parent's ``git archive``, say) is timed as it ships, its kernel built
by its own ``ops/_build.py`` into its own build directory.  Each checkout
runs in a process of its own, with its root alone on the path (this file
run as a script with ``--worker``): the other, this checkout, then the
same in reverse.

At the four timed draws (``SHAPES``: vg128 b128 channels_last in f32 and
bf16, the COCO-64 train step's NCHW draw, vg128 b128 at f 2) from
``prng_key(2)``: each checkout's first process writes its outputs, which
this process holds to the plain version (``ops.prng``, within
``THREEFRY_BAR``), and every process times each draw with CUDA events
over ``ITERS`` calls (what a caller gets: a small draw's time is then the
host's issue of its launch) and by torch.profiler (the kernel alone).
Each row keeps the lower of its two turns and prints both, with its share
of the bound (``utils/roofline.threefry_bounds`` at the card's max SM
clock).  Exits 1 without a card or when a checkout's T1
disagrees.  Writes ``<out>/threefry_ab.json``.
"""

# The package is imported inside the functions: the worker's comes from the
# checkout it times, which need not have this file.
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
# tag: ((N, C, H, W), f, dtype name, channels_last)
SHAPES = {
    "b128 channels_last f32": ((128, 32, 128, 128), 1, "float32", True),
    "b128 channels_last bf16": ((128, 32, 128, 128), 1, "bfloat16", True),
    "train step NCHW f32": ((32, 32, 64, 64), 1, "float32", False),
    "b128 f2 channels_last f32": ((128, 32, 128, 128), 2, "float32", True),
}
SEED = 2
ITERS = 50  # calls a turn
THREEFRY_BAR = 1e-6  # normals against the plain version (chip_smoke.py)


def _fmt(channels_last: bool):
    return torch.channels_last if channels_last else torch.contiguous_format


def worker(argv) -> int:
    """One checkout's T1 (the package on this process's path) at every
    shape: each output written where asked, then timed; prints
    ``{"module": <the wrapper's file>, tag: ms, tag + " device": ms,
    ...}``: CUDA events over back-to-back calls (the caller's time, the
    host's issue included), and the kernel's own device time by
    torch.profiler (None on the CPU)."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk
    from sg2im_tpu_torch.tools._measure import kernel_table, time_ms

    p = argparse.ArgumentParser()
    p.add_argument("--device", required=True)
    p.add_argument("--iters", type=int, required=True)
    p.add_argument("--shapes", required=True, help="SHAPES as JSON")
    p.add_argument("--save")
    args = p.parse_args(argv)
    key = prng.prng_key(SEED)
    result = {"module": pk.__file__}
    shapes = json.loads(args.shapes)
    for i, (tag, (shape, f, dtype, cl)) in enumerate(shapes.items()):
        def run(shape=shape, f=f, dtype=getattr(torch, dtype), cl=cl):
            return pk.threefry_normal(key, shape, f=f, dtype=dtype,
                                      device=args.device,
                                      memory_format=_fmt(cl))
        if args.save:
            torch.save(run().cpu(), Path(args.save) / f"{i}.pt")
        result[tag] = time_ms(run, args.device, iters=args.iters)
        table = kernel_table(run, args.device, iters=5)
        result[tag + " device"] = table and sum(
            r["ms"] for r in table["top"] if "threefry" in r["name"])
    print(json.dumps(result))
    return 0


def run_worker(root: Path, device, iters: int, shapes: dict, save) -> dict:
    """{tag: ms} of the checkout at ``root``, timed in a process of its
    own; its outputs written into ``save`` when given."""
    from sg2im_tpu_torch.tools._measure import run_worker as run

    argv = ["--device", device, "--iters", iters, "--shapes",
            json.dumps(shapes)]
    return run(Path(__file__).resolve(), root,
               argv + (["--save", save] if save is not None else []))


def check_saved(save: Path, device, shapes: dict) -> dict:
    """{tag: max abs error} of a worker's outputs against the plain
    version; raises past THREEFRY_BAR."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    key = prng.prng_key(SEED)
    errs = {}
    for i, (tag, (shape, f, dtype, cl)) in enumerate(shapes.items()):
        dtype = getattr(torch, dtype)
        out = torch.load(save / f"{i}.pt").to(device)
        want = pk._plain(lambda k, s, d: prng.normal(k, s, dtype, device=d),
                         key, shape, f, _fmt(cl), torch.device(device))
        if (out.dtype != dtype or out.shape != want.shape
                or not out.is_contiguous(memory_format=_fmt(cl))):
            raise AssertionError(f"{tag}: output {out.dtype} "
                                 f"{tuple(out.shape)}")
        errs[tag] = (out.float() - want.float()).abs().max().item()
        del out, want
        if not errs[tag] <= THREEFRY_BAR:
            raise AssertionError(f"{tag}: output disagrees with the plain "
                                 f"version: {errs[tag]:.3e}")
    return errs


def bounds(device, shapes: dict) -> dict:
    """{tag: (bound ms, bound by)} at the card's max SM clock."""
    from sg2im_tpu_torch.utils.roofline import (
        THREEFRY_OPS,
        threefry_bounds,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    clock_hz = float(smi.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for tag, (shape, f, dtype, _) in shapes.items():
        n = 1
        for s in shape:
            n *= s
        elem, kind = (2, "bf16") if dtype == "bfloat16" else (4, "f32")
        out[tag] = threefry_bounds(n // (f * f), n * elem,
                                   THREEFRY_OPS[kind], sms, clock_hz)
    return out


def compare(others: list[str], device, iters: int,
            shapes: dict = SHAPES) -> dict:
    """The A/B of ``shapes`` on ``device``: per checkout and shape its
    turns, its max abs error and, on the card, its bound."""
    from sg2im_tpu_torch.ops import _build

    names = [f"other:{o}" for o in others] + ["this"]
    roots = [Path(o).resolve() for o in others] + [REPO]
    turns = {(name, tag): [] for name in names for tag in shapes}
    device_ms = {(name, tag): [] for name in names for tag in shapes}
    errs = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        order = list(range(len(roots)))
        for i in order + order[::-1]:
            save = None if names[i] in errs else Path(work)
            ms = run_worker(roots[i], device, iters, shapes, save)
            if save is not None:
                try:
                    errs[names[i]] = check_saved(save, device, shapes)
                except AssertionError as e:
                    raise AssertionError(f"{names[i]}: {e}") from None
            for tag in shapes:
                turns[names[i], tag].append(ms[tag])
                device_ms[names[i], tag].append(ms[tag + " device"])
    on_card = torch.device(device).type == "cuda"
    bnds = bounds(device, shapes) if on_card else {}
    rows = []
    for tag in shapes:
        bound, by = bnds.get(tag, (None, None))
        for name in names:
            ms = min(turns[name, tag])
            dev = [d for d in device_ms[name, tag] if d is not None]
            rows.append({"checkout": name, "draw": tag, "ms": ms,
                         "turns": turns[name, tag],
                         "device_ms": min(dev) if dev else None,
                         "device_turns": device_ms[name, tag],
                         "bound_ms": bound,
                         "bound_by": by,
                         "pct_of_bound": bound and 100 * bound / ms,
                         "max_abs_err": errs[name][tag]})
    return {"shapes": {tag: list(v) for tag, v in shapes.items()},
            "iters": iters, "rows": rows}


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
        print("FAIL: threefry_ab times kernels; it needs --device cuda",
              file=sys.stderr)
        return 1
    try:
        report = compare([args.other], device, ITERS)
    except AssertionError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    report["card"] = card
    for row in report["rows"]:
        dev = row["device_ms"]
        print(f"[threefry_ab] {row['draw']}, {row['checkout']}: "
              f"{row['ms']:.4f} ms a call on events (turns "
              f"{', '.join(f'{v:.4f}' for v in row['turns'])}), "
              f"{row['pct_of_bound']:.1f}% of its {row['bound_ms']:.4f} ms "
              f"{row['bound_by']} bound; the kernel "
              + (f"{dev:.4f} ms on the device (profiler turns "
                 f"{', '.join(f'{v:.4f}' for v in row['device_turns'])}),"
                 f" {100 * row['bound_ms'] / dev:.1f}% of the bound"
                 if dev else "not seen by the profiler")
              + f"; max_abs_err {row['max_abs_err']:.3e}; on {card}")
    M.write_report(args.out, "threefry_ab", report)
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"]
             else main())
