"""K3's plan (``ops/relayout.relayout_plan``) on the CPU, where the kernel
itself cannot run.

A numpy emulation of the kernel's walk (``csrc/relayout.cu``) over byte
offsets: every block of the plan's grid, its span of output units
wherever in a segment it starts, and each unit's source through the plan's
multiply-high divisions.  On every ``chip_smoke`` relayout case (the
packed path, the phase path, the ragged and unaligned ones) each output
byte is stored exactly once, from the input byte the phase-major contract
names (the plain version's, checked on small shapes): whole at small
shapes and at batch 2, and at batch 128 in the first, middle and last
blocks.  No path shape plans the units route (off 16-byte alignment).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from sg2im_tpu_torch.ops import relayout as rl

ELSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def divide(q, mul: int, shift: int):
    """The kernel's q // d from ``magic_divisor``'s (mul, shift)."""
    return (((q * mul) >> 32) + q) >> shift


def geometry(entry, shape):
    """(N, R, Rw, C) of a case's NCHW input."""
    N, C, H, W = shape
    if entry == "s2d":
        return N, H // 2, W // 2, C
    return N, H, W, C // 4


def contract_source(y, entry, Rw, L):
    """The input byte the phase-major contract names for output byte
    ``y`` (int64 array): segments of S = 2 Rw L bytes hold the same bytes
    on both sides, fine order (a, j), packed order (j, a), runs of L."""
    S = 2 * Rw * L
    seg, r = np.divmod(y, S)
    q, w = np.divmod(r, L)
    if entry == "s2d":  # output packed: q = 2j + a
        src_q = (q & 1) * Rw + (q >> 1)
    else:  # output fine: q = a Rw + j
        a, j = np.divmod(q, Rw)
        src_q = 2 * j + a
    return seg * S + src_q * L + w


def check_walk(plan, entry, N, R, Rw, C, elsize, misalign, whole: bool):
    """Block b moves output units [b span, (b + 1) span) of ``plan.unit``
    bytes, each from the unit its segment and run name (the plan's
    multiply-high divisions), starting wherever in a segment the block
    does."""
    L = 2 * C * elsize
    S, segs = 2 * Rw * L, N * R
    unit = plan.unit
    assert unit == next(u for u in (16, 8, 4, 2, 1)
                        if L % u == 0 and misalign % u == 0)
    assert (plan.segs, plan.Rw, plan.run, plan.seg) == (segs, Rw, L, S)
    assert plan.span == rl.THREADS * rl.UNROLL
    Lu, Su = L // unit, S // unit
    total = segs * Su
    assert (plan.grid - 1) * plan.span < total <= plan.grid * plan.span
    assert 2 * Su + plan.span < 2 ** 31
    blocks = (range(plan.grid) if whole else
              sorted({0, 1, 2, plan.grid // 2, plan.grid - 2, plan.grid - 1}))
    count = np.zeros(total * unit if whole else 0, np.uint8)
    for b in blocks:
        base = b * plan.span
        span = min(plan.span, total - base)
        seg0, off = divmod(base, Su)
        o = off + np.arange(span, dtype=np.int64)
        seg = divide(o, plan.seg_mul, plan.seg_shift)
        r = o - seg * Su
        row = Rw * Lu
        if entry == "s2d":
            q = divide(r, plan.run_mul, plan.run_shift)
            src = seg * Su + (q & 1) * row + (q >> 1) * Lu + (r - q * Lu)
        else:
            a = (r >= row).astype(np.int64)
            rem = r - a * row
            j = divide(rem, plan.run_mul, plan.run_shift)
            src = seg * Su + (2 * j + a) * Lu + (rem - j * Lu)
        got = ((seg0 * Su + src) * unit)[:, None] + np.arange(unit)
        y = ((base + np.arange(span, dtype=np.int64)) * unit)[:, None] \
            + np.arange(unit)
        np.testing.assert_array_equal(got, contract_source(y, entry, Rw, L))
        if whole:
            np.add.at(count, y.reshape(-1), 1)
    if whole:
        assert (count == 1).all()


PATHS = {**chip_smoke.RELAYOUT_PATH, **chip_smoke.RELAYOUT_PHASE_PATH}
CASES = {**PATHS, **chip_smoke.RELAYOUT_RAGGED}


def plan_of(entry, shape, dtype, offset):
    N, R, Rw, C = geometry(entry, shape)
    elsize = ELSIZE[dtype]
    ptr = 256 + offset * elsize  # an allocation's start, moved by offset
    return rl.relayout_plan(N, R, Rw, C, elsize, ptr, 512)


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_stores_every_byte_once_from_its_contract_byte(name):
    entry, shape, dtype, offset = CASES[name]
    N, R, Rw, C = geometry(entry, shape)
    elsize = ELSIZE[dtype]
    plan = plan_of(entry, shape, dtype, offset)
    misalign = (offset * elsize) % 16
    unaligned = bool(misalign or (4 * Rw * C * elsize) % 16)
    assert plan.route == (rl.ROUTE_UNITS if unaligned else rl.ROUTE_DIRECT)
    if name in PATHS:
        assert plan.route == rl.ROUTE_DIRECT, f"{name} plans the units route"
        # 16-byte units but at the head's 24-byte runs.
        assert plan.unit == (8 if C * elsize == 12 else 16)
    check_walk(plan, entry, N, R, Rw, C, elsize, misalign, whole=N < 128)


# Cut to batch 2, the path shapes are emulated whole, every byte counted.
@pytest.mark.parametrize("name", sorted(PATHS))
def test_walk_at_batch_2_stores_every_byte(name):
    entry, shape, dtype, _ = PATHS[name]
    shape = (2,) + shape[1:]
    N, R, Rw, C = geometry(entry, shape)
    plan = plan_of(entry, shape, dtype, 0)
    check_walk(plan, entry, N, R, Rw, C, ELSIZE[dtype], 0, whole=True)


# Edges of the walk: blocks across segments and a last block part full,
# a single block smaller than its span, a segment over a block's span, 8-,
# 4-, 2- and 1-byte units.
EDGES = {
    "across segments": ("s2d", (3, 40, 6, 10), 2, 0),
    "one block": ("d2s", (1, 16, 2, 2), 4, 0),
    "8-byte units": ("d2s", (2, 12, 6, 10), 4, 0),
    "4-byte units": ("s2d", (3, 6, 10, 8), 1, 0),
    "2-byte units off alignment": ("s2d", (2, 8, 6, 4), 2, 1),
    "1-byte units": ("d2s", (2, 20, 4, 6), 1, 0),
    "segments over a span": ("d2s", (2, 2048, 4, 6), 2, 0),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_walk_at_the_plan_edges(name):
    entry, shape, elsize, offset = EDGES[name]
    N, R, Rw, C = geometry(entry, shape)
    plan = rl.relayout_plan(N, R, Rw, C, elsize, 256 + offset * elsize, 0)
    check_walk(plan, entry, N, R, Rw, C, elsize, (offset * elsize) % 16,
               whole=True)


def test_plan_routes_and_limits():
    # The head: 8-byte units; s2d s5: 16-byte ones; blocks of one trip.
    p = rl.relayout_plan(128, 64, 64, 3, 4)
    assert (p.route, p.unit, p.seg, p.span) == (rl.ROUTE_DIRECT, 8, 3072,
                                                1024)
    assert p.grid == 128 * 64 * 3072 // 8 // 1024
    p = rl.relayout_plan(128, 64, 64, 160, 2)
    assert (p.route, p.unit, p.grid) == (rl.ROUTE_DIRECT, 16,
                                         671088640 // 16 // 1024)
    # Off alignment, or a segment that is no multiple of 16 bytes: units.
    assert rl.relayout_plan(2, 4, 4, 16, 2, 2, 0).route == rl.ROUTE_UNITS
    assert rl.relayout_plan(2, 4, 4, 16, 2, 0, 8).unit == 8
    assert rl.relayout_plan(2, 4, 4, 16, 2, 0, 8).route == rl.ROUTE_UNITS
    assert rl.relayout_plan(2, 4, 4, 16, 2, 32, 48) == rl.relayout_plan(
        2, 4, 4, 16, 2)
    p = rl.relayout_plan(2, 7, 3, 3, 2)  # L 12, S 72
    assert (p.route, p.unit) == (rl.ROUTE_UNITS, 4)
    # The struct the entries read holds the plan field for field.
    plan, struct, addr = rl._plan_struct(128, 64, 64, 3, 4, 0)
    assert tuple(getattr(struct, f) for f in rl.RelayoutPlan._fields) == \
        tuple(plan)
    assert addr == ctypes.addressof(struct)
    with pytest.raises(ValueError, match="grid"):
        rl.relayout_plan(1, 1, 2 ** 29 - 100, 1, 1)  # S near 2^31, 2-byte units


def test_contract_is_the_plain_versions():
    """contract_source, which the emulation holds every store to, is the
    plain version's map of bytes, in both directions."""
    for entry, shape, elsize in (("s2d", (2, 3, 4, 6), 4),
                                 ("d2s", (2, 12, 3, 5), 2),
                                 ("s2d", (1, 5, 2, 8), 1)):
        N, C, H, W = shape
        ids = torch.arange(N * C * H * W, dtype=torch.int64)
        x = ids.reshape(N, H, W, C).permute(0, 3, 1, 2)
        fn = (rl.space_to_depth_ref if entry == "s2d"
              else rl.depth_to_space_ref)
        out = fn(x).permute(0, 2, 3, 1).reshape(-1).numpy()
        _, _, Rw, c = geometry(entry, shape)
        L = 2 * c * elsize
        y = np.arange(out.size * elsize, dtype=np.int64)
        src = contract_source(y, entry, Rw, L)
        want = out[y // elsize] * elsize + y % elsize
        np.testing.assert_array_equal(src, want)


# Small shapes for the A/B on the CPU: tag: (entry, NCHW, dtype).  The
# tags' prefixes make the three sums.
AB_SHAPES = {"s2d small bf16": ("s2d", (2, 5, 6, 8), "bfloat16"),
             "d2s small f32": ("d2s", (2, 12, 4, 4), "float32"),
             "phase d2s small bf16": ("d2s", (1, 64, 2, 2), "bfloat16")}


def test_relayout_ab_shapes_are_the_smokes():
    from sg2im_tpu_torch.tools import relayout_ab

    assert relayout_ab.SHAPES == {
        name: (entry, shape, dtype)
        for name, (entry, shape, dtype, _) in PATHS.items()}


def test_relayout_ab_times_this_checkout_in_processes_of_its_own(tmp_path):
    """tools/relayout_ab runs each checkout's wrappers in a process of its
    own (two turns), holds their outputs' bytes to the
    plain version's, and sums the shapes by path; on the CPU the wrapper
    is the plain version itself.  Its command line needs a card."""
    from sg2im_tpu_torch.tools import relayout_ab

    report = relayout_ab.compare([], "cpu", 1, AB_SHAPES)
    rows = {(r["checkout"], r["shape"]): r for r in report["rows"]}
    assert set(rows) == {("this", tag) for tag in AB_SHAPES}
    for row in rows.values():
        assert row["bound_ms"] is None and row["device_ms"] is None
        assert len(row["turns"]) == 2 and row["ms"] == min(row["turns"])
    sums = {(s["checkout"], s["sum"]): s for s in report["sums"]}
    assert set(sums) == {("this", g) for g in relayout_ab.SUMS}
    assert sums["this", "packed s2d"]["ms"] == rows[
        "this", "s2d small bf16"]["ms"]
    assert relayout_ab.main(["--other", str(tmp_path), "--device", "cpu",
                             "--out", str(tmp_path)]) == 1


def test_relayout_ab_refuses_a_checkout_whose_k3_disagrees(tmp_path):
    """A checkout whose relayout moves a byte wrong fails the A/B before
    any time of it is kept."""
    from sg2im_tpu_torch.tools import relayout_ab

    pkg = tmp_path / "sg2im_tpu_torch"
    for sub in ("", "ops", "tools"):
        (pkg / sub).mkdir(exist_ok=True)
        (pkg / sub / "__init__.py").write_text("")
    (pkg / "ops" / "relayout.py").write_text(
        "import torch\n"
        "def space_to_depth(x):\n"
        "    N, C, H, W = x.shape\n"
        "    return torch.nn.functional.pixel_unshuffle(x, 2).contiguous(\n"
        "        memory_format=torch.channels_last)\n"
        "def depth_to_space(x):\n"
        "    return torch.nn.functional.pixel_shuffle(x, 2).contiguous(\n"
        "        memory_format=torch.channels_last)\n")
    (pkg / "tools" / "_measure.py").write_text(
        "def time_ms(fn, device, iters):\n"
        "    fn()\n"
        "    return 1.0\n"
        "def kernel_table(fn, device, iters):\n"
        "    return None\n")
    with pytest.raises(AssertionError, match="other:.*s2d small.*disagrees"):
        relayout_ab.compare([str(tmp_path)], "cpu", 1, AB_SHAPES)
