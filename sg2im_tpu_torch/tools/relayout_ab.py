"""K3, the space-to-depth / depth-to-space relayout, of this checkout
against K3 of another checkout, in turns on one card.

    python -m sg2im_tpu_torch.tools.relayout_ab --other ROOT [--out DIR]

Each checkout's K3 is called through its own ``ops.relayout``
``space_to_depth`` / ``depth_to_space``, the wrappers every caller uses,
whose signatures do not change with the kernel's entries or plan: so a
checkout (the parent's ``git archive``, say) is timed as it ships, its
kernel built by its own ``ops/_build.py`` into its own build directory.
Each checkout runs in a process of its own, with its root alone on the
path (this file run as a script with ``--worker``): the other, this
checkout, then the same in reverse.

At the packed path's six and the phase path's five batch-128 shapes
(``SHAPES``, those of ``chip_smoke.RELAYOUT_PATH`` and
``RELAYOUT_PHASE_PATH``) on inputs drawn on the device from one seed a
shape: each process hashes each output's bytes, which must equal the hash
of this checkout's plain version (``space_to_depth_ref`` /
``depth_to_space_ref``) on the same inputs, and times each shape with
CUDA events over ``ITERS`` calls (what a caller gets: a small shape's
time is then the host's enqueue of its launch) and by torch.profiler (the
kernel alone).  Each row keeps the lower of its two turns and prints both,
with its share of the bytes bound (``utils/roofline.relayout_bounds``);
the packed path's s2d and d2s sums and the phase path's d2s sum follow.
Exits 1 without a card or when a checkout's K3 disagrees.  Writes
``<out>/relayout_ab.json``.
"""

# The package is imported inside the functions: the worker's comes from the
# checkout it times, which need not have this file.
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
# tag: (entry, NCHW input shape, dtype name); the sums' groups by prefix.
SHAPES = {
    "s2d level s3 N128 C160 32x32 bf16": ("s2d", (128, 160, 32, 32),
                                          "bfloat16"),
    "s2d level s4 N128 C160 64x64 bf16": ("s2d", (128, 160, 64, 64),
                                          "bfloat16"),
    "s2d level s5 N128 C160 128x128 bf16": ("s2d", (128, 160, 128, 128),
                                            "bfloat16"),
    "d2s s3 out N128 C1024 16x16 bf16": ("d2s", (128, 1024, 16, 16),
                                         "bfloat16"),
    "d2s s4 out N128 C512 32x32 bf16": ("d2s", (128, 512, 32, 32),
                                        "bfloat16"),
    "d2s head N128 C12 64x64 f32": ("d2s", (128, 12, 64, 64), "float32"),
    **{f"phase d2s N128 C{c} {r}x{r} bf16": ("d2s", (128, c, r, r),
                                             "bfloat16")
       for c, r in ((4096, 4), (2048, 8), (1024, 16), (512, 32), (256, 64))},
}
SUMS = {"packed s2d": "s2d ", "packed d2s": "d2s ",
        "phase d2s": "phase d2s "}
ITERS = 50  # calls a turn


def make_input(shape, dtype: str, seed: int, device) -> torch.Tensor:
    """The channels_last NCHW input of one shape, drawn on ``device``."""
    N, C, H, W = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((N, H, W, C), generator=gen, device=device)
    return x.to(getattr(torch, dtype)).permute(0, 3, 1, 2)


def digest(t: torch.Tensor) -> str:
    """sha256 of the tensor's NHWC bytes."""
    raw = t.permute(0, 2, 3, 1).contiguous().view(torch.uint8).cpu()
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def worker(argv) -> int:
    """One checkout's K3 (the package on this process's path) at every
    shape: each output hashed, then timed; prints ``{"module": <the
    wrapper's file>, tag: ms, tag + " device": ms, tag + " sha256": hex,
    ...}``: CUDA events over back-to-back calls, and the kernel's own
    device time by torch.profiler (None on the CPU)."""
    from sg2im_tpu_torch.ops import relayout as rl
    from sg2im_tpu_torch.tools._measure import kernel_table, time_ms

    p = argparse.ArgumentParser()
    p.add_argument("--device", required=True)
    p.add_argument("--iters", type=int, required=True)
    p.add_argument("--shapes", required=True, help="SHAPES as JSON")
    args = p.parse_args(argv)
    result = {"module": rl.__file__}
    shapes = json.loads(args.shapes)
    for i, (tag, (entry, shape, dtype)) in enumerate(shapes.items()):
        x = make_input(shape, dtype, i, args.device)
        fn = rl.space_to_depth if entry == "s2d" else rl.depth_to_space
        result[tag + " sha256"] = digest(fn(x))
        result[tag] = time_ms(lambda: fn(x), args.device, iters=args.iters)
        table = kernel_table(lambda: fn(x), args.device, iters=5)
        result[tag + " device"] = table and sum(
            r["ms"] for r in table["top"] if "relayout" in r["name"])
        del x
    print(json.dumps(result))
    return 0


def run_worker(root: Path, device, iters: int, shapes: dict) -> dict:
    """{tag: ms, ...} of the checkout at ``root``, timed in a process of
    its own."""
    from sg2im_tpu_torch.tools._measure import run_worker as run

    return run(Path(__file__).resolve(), root,
               ["--device", device, "--iters", iters, "--shapes",
                json.dumps(shapes)])


def plain_digests(device, shapes: dict) -> dict:
    """{tag: sha256} of this checkout's plain version on each shape's
    input."""
    from sg2im_tpu_torch.ops import relayout as rl

    out = {}
    for i, (tag, (entry, shape, dtype)) in enumerate(shapes.items()):
        x = make_input(shape, dtype, i, device)
        ref = (rl.space_to_depth_ref if entry == "s2d"
               else rl.depth_to_space_ref)
        out[tag] = digest(ref(x))
        del x
    return out


def compare(others: list[str], device, iters: int,
            shapes: dict = SHAPES) -> dict:
    """The A/B of ``shapes`` on ``device``: per checkout and shape its
    turns, its device times and, on the card, its bound; then the sums."""
    from sg2im_tpu_torch.utils.roofline import relayout_bounds

    names = [f"other:{o}" for o in others] + ["this"]
    roots = [Path(o).resolve() for o in others] + [REPO]
    turns = {(name, tag): [] for name in names for tag in shapes}
    device_ms = {(name, tag): [] for name in names for tag in shapes}
    want = plain_digests(device, shapes)
    order = list(range(len(roots)))
    for i in order + order[::-1]:
        name = names[i]
        ms = run_worker(roots[i], device, iters, shapes)
        for tag in shapes:
            if ms[tag + " sha256"] != want[tag]:
                raise AssertionError(f"{name}: {tag}: the output disagrees "
                                     f"with the plain version")
            turns[name, tag].append(ms[tag])
            device_ms[name, tag].append(ms[tag + " device"])
    on_card = torch.device(device).type == "cuda"
    rows = []
    for tag, (entry, shape, dtype) in shapes.items():
        bound = (relayout_bounds([(entry, shape, dtype)])[entry][0]
                 if on_card else None)
        for name in names:
            ms = min(turns[name, tag])
            dev = [d for d in device_ms[name, tag] if d is not None]
            rows.append({"checkout": name, "shape": tag, "ms": ms,
                         "turns": turns[name, tag],
                         "device_ms": min(dev) if dev else None,
                         "device_turns": device_ms[name, tag],
                         "bound_ms": bound, "bound_by": "bytes",
                         "pct_of_bound": bound and 100 * bound / ms})
    sums = []
    for group, prefix in SUMS.items():
        for name in names:
            mine = [r for r in rows
                    if r["checkout"] == name and r["shape"].startswith(prefix)]
            if not mine:
                continue
            n_turns = len(mine[0]["turns"])
            sums.append({"checkout": name, "sum": group,
                         "ms": sum(r["ms"] for r in mine),
                         "turns": [sum(r["turns"][k] for r in mine)
                                   for k in range(n_turns)],
                         "bound_ms": (sum(r["bound_ms"] for r in mine)
                                      if on_card else None)})
    return {"shapes": {tag: list(v) for tag, v in shapes.items()},
            "iters": iters, "rows": rows, "sums": sums}


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
        print("FAIL: relayout_ab times kernels; it needs --device cuda",
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
        print(f"[relayout_ab] {row['shape']}, {row['checkout']}: "
              f"{row['ms']:.4f} ms a call on events (turns "
              f"{', '.join(f'{v:.4f}' for v in row['turns'])}), "
              f"{row['pct_of_bound']:.1f}% of its {row['bound_ms']:.4f} ms "
              f"bytes bound; the kernel "
              + (f"{dev:.4f} ms on the device (profiler turns "
                 f"{', '.join(f'{v:.4f}' for v in row['device_turns'])})"
                 if dev else "not seen by the profiler")
              + f"; on {card}")
    for s in report["sums"]:
        print(f"[relayout_ab] sum {s['sum']}, {s['checkout']}: "
              f"{s['ms']:.4f} ms (turns "
              f"{', '.join(f'{v:.4f}' for v in s['turns'])}) against "
              f"{s['bound_ms']:.4f} ms of bound; on {card}")
    M.write_report(args.out, "relayout_ab", report)
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"]
             else main())
