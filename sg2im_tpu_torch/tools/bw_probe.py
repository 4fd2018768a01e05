"""Device-memory stream rates of the card: the measured counterpart of the
data sheet's 3.35 TB/s.

Port of ``scripts/bw_probe.py``.  Each variant is one elementwise or
reduction kernel over arrays of ``--shape`` (256 x 1024 x 1024 by
default: 1 GiB in f32, 0.5 GiB in bf16), in f32 and in bf16:

* scale+add ``x + 1e-7 x`` (``torch.add`` with alpha, both operands x:
  one vectorized kernel), relu, triad ``x + 1.0001 y`` (``torch.add``
  with alpha), reduce-sum, and a plain ``copy_`` into a buffer allocated
  beforehand;
* and the CRN-sized bf16 scale ``x * 1.0000001`` over ``--crn_shape``
  (128 x 128 x 128 x 160, the widest pre-CRN tensor of vg128 at b128).

Each is timed with CUDA events over ``--iters`` calls after warm-up; its
rate counts the bytes the kernel must move, each input read once and the
output written once (scale+add, relu, copy_ and scale 2x the array, triad
3x, reduce-sum 1x).  ``roofline_ms`` keeps the data sheet's rate as the
bound, so every earlier share of a bound stays comparable; this tool
reports what the card reaches beside it.

    python -m sg2im_tpu_torch.tools.bw_probe [--iters 20] [--out DIR]

Prints one JSON object per variant, writes ``<out>/bw_probe.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from sg2im_tpu_torch.tools import _measure as M
from sg2im_tpu_torch.utils.flags import int_tuple
from sg2im_tpu_torch.utils.roofline import HBM_BYTES


def variants(shape, crn_shape, device):
    """[(name, dtype name, fn, bytes moved)] on arrays made from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        y = torch.randn(shape, generator=gen, device=device).to(dtype)
        dst = torch.empty_like(x)
        nb = x.numel() * x.element_size()
        out += [
            ("scale+add", tag, lambda x=x: torch.add(x, x, alpha=1e-7),
             2 * nb),
            ("relu", tag, lambda x=x: torch.relu(x), 2 * nb),
            ("triad", tag, lambda x=x, y=y: torch.add(x, y, alpha=1.0001),
             3 * nb),
            ("reduce-sum", tag, lambda x=x: x.sum(), nb),
            ("copy_", tag, lambda x=x, d=dst: d.copy_(x), 2 * nb),
        ]
    z = torch.randn(crn_shape, generator=gen, device=device).to(
        torch.bfloat16)
    out.append(("crn-sized scale", "bf16", lambda z=z: z * 1.0000001,
                2 * z.numel() * z.element_size()))
    return out


def main(argv=None) -> int:
    p = M.base_parser(__doc__)
    p.add_argument("--shape", type=int_tuple, default=(256, 1024, 1024))
    p.add_argument("--crn_shape", type=int_tuple, default=(128, 128, 128,
                                                          160))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    opened = M.open_device(args)
    if opened is None:
        return 1
    device, card = opened
    print(card)
    rows = []
    with torch.inference_mode():
        for name, dtype, fn, nbytes in variants(args.shape, args.crn_shape,
                                                device):
            ms = M.time_ms(fn, device, args.iters)
            gb_s = nbytes / ms / 1e6
            row = {"variant": name, "dtype": dtype, "bytes": nbytes,
                   "ms": ms, "gb_s": gb_s,
                   "pct_sheet": 100 * gb_s * 1e9 / HBM_BYTES,
                   "device": str(device), "card": card}
            print(json.dumps(row))
            rows.append(row)
    best = max(rows, key=lambda r: r["gb_s"])
    M.write_report(args.out, "bw_probe", {
        "card": card, "device": str(device), "shape": list(args.shape),
        "crn_shape": list(args.crn_shape), "sheet_gb_s": HBM_BYTES / 1e9,
        "best": {"variant": best["variant"], "dtype": best["dtype"],
                 "gb_s": best["gb_s"]},
        "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
