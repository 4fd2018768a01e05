"""The numbers that decide ``correct``, each compared with its limit from
``limits/<workload>.json``: what the timed path produced against the plain
reference on the same inputs."""

from __future__ import annotations

import math
import statistics
import sys

import numpy as np
import torch

# Leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone (a bias before a train-mode
# BatchNorm, a head outside the loss): they are left out of the gradient
# and update numbers, by this rule on the reference, never by name.
LEAF_FLOOR = 1e-3


def u8_mse(a, b) -> float:
    """Mean squared difference of two uint8 image arrays, in levels^2."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean())


def real_max_abs(a: torch.Tensor, b: torch.Tensor, mask) -> float:
    """Largest |a - b| over the rows ``mask`` (N, O) marks; a and b are
    (N, O, ...) with O at least the mask's."""
    O = mask.shape[1]
    a, b = a[:, :O].float().cpu(), b[:, :O].float().cpu()
    m = torch.as_tensor(mask).bool().cpu()
    if not m.any():
        return 0.0
    return float((a[m] - b[m]).abs().max())


def kept_leaves(ref_norms: dict) -> list[str]:
    """The leaves that count: reference gradient norm at least
    ``LEAF_FLOOR`` times the median leaf's."""
    med = statistics.median(ref_norms.values())
    return [k for k, v in ref_norms.items() if v >= LEAF_FLOOR * med]


def worst_leaf_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    """max over ``keep`` of |prog norm - ref norm| / max(ref norm, the
    median kept leaf's ref norm)."""
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {'value', 'limit'}}): every number finite and at
    most its limit; a number without a limit is a fault of the files."""
    shown, ok = {}, True
    for name, value in numbers.items():
        limit = limits["checks"][name]["limit"]
        shown[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    missing = set(limits["checks"]) - set(numbers)
    if missing:
        ok = False
        for name in sorted(missing):
            shown[name] = {"value": None,
                           "limit": limits["checks"][name]["limit"]}
    return ok, shown


def print_checks(shown: dict) -> None:
    for name, v in shown.items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)


@torch.no_grad()
def norms(tensors: dict) -> dict:
    """{name: float norm}, one host read for all."""
    names = list(tensors)
    vals = torch.stack([tensors[k].float().norm() for k in names]).tolist()
    return dict(zip(names, vals))
