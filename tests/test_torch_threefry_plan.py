"""The threefry normal kernel's plan (``ops/prng_kernel.normal_plan``) on
the CPU, where the kernel itself cannot run.

A numpy emulation of the kernel's walk (``csrc/threefry.cu``): every thread
of the plan's grid, its index split by the plan's multiply-high in place of
a division, its run of V values with their counters (the hi word one a
thread unless the plan asks for the carry instance) and the output elements
it stores, f x f copies included.  On every ``chip_smoke.THREEFRY_CASES``
and ``THREEFRY_PATH_CASES`` shape, the timed shapes and the ragged V edges,
each output element is stored exactly once and with its JAX flat counter
(offset included, 2^32 crossings included); on small shapes the walk fed
through ``prng.threefry2x32`` equals ``threefry_bits``' CPU path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from sg2im_tpu_torch.ops import prng
from sg2im_tpu_torch.ops import prng_kernel as pk

M32 = 0xFFFFFFFF
CHUNK = 1 << 18  # threads emulated at once
# The plan depends on the output type only through V (int32 bits walk as
# float32 does).
DTYPES = {"V4": torch.float32, "V8": torch.bfloat16}


def divide(q, mul: int, shift: int):
    """The kernel's q // d from ``magic_divisor``'s (mul, shift), on int64
    arrays."""
    return (((q * mul) >> 32) + q) >> shift


def _grid_threads(plan):
    """(q, by, bz) of every thread of the grid, q the thread's index along
    x, in chunks."""
    gx, gy, gz = plan.grid
    q = np.arange(gx * plan.block, dtype=np.int64)
    for bz in range(gz):
        for by in range(gy):
            for lo in range(0, q.size, CHUNK):
                yield q[lo:lo + CHUNK], by, bz


def walk(plan, shape, f, offset):
    """The kernel's stores, chunk by chunk: (output element as its index in
    the output's order of bytes (int64), its counter (uint64))."""
    N, C, H, W = shape
    Hd, Wd = H // f, W // f
    V, J = plan.V, plan.J
    total = N * C * Hd * Wd
    i = np.arange(V, dtype=np.int64)
    for q, by, bz in _grid_threads(plan):
        if plan.walk == pk.WALK_FLAT:
            first = q * V
            q = q[first < total]
            first = q * V
            rel = first
            step = 1
            valid = np.minimum(V, total - first)
            dst = first
            copies = np.zeros(1, np.int64)
            spread = i
        elif plan.walk == pk.WALK_PIXEL:
            q = q[q < Wd * J]
            xd = divide(q, plan.j_mul, plan.j_shift)
            c = (q - xd * J) * V
            row = bz * Hd + by
            rel = row * Wd * C + xd * C + c
            step = 1
            valid = np.minimum(V, C - c)
            dst = row * f * f * Wd * C + xd * f * C + c
            dy, dx = np.divmod(np.arange(f * f), f)
            copies = dy * f * Wd * C + dx * C
            spread = i
        else:
            q = q[q < Hd * J]
            yd = divide(q, plan.j_mul, plan.j_shift)
            x = (q - yd * J) * V
            rel = bz * Hd * Wd * C + (yd * Wd + x) * C + by
            step = C
            valid = np.minimum(V, Wd - x)
            dst = (bz * C + by) * f * f * Hd * Wd + yd * f * f * Wd + x * f
            dy, dx = np.divmod(np.arange(f * f), f)
            copies = dy * f * Wd + dx
            spread = i * f
        counter0 = np.uint64(offset) + rel.astype(np.uint64)
        lo0 = counter0 & np.uint64(M32)
        hi0 = counter0 >> np.uint64(32)
        lo = (lo0[:, None] + (i * step).astype(np.uint64)) & np.uint64(M32)
        hi = hi0[:, None] + ((lo < lo0[:, None]) & plan.carry).astype(
            np.uint64)
        keep = i < valid[:, None]
        counters = ((hi << np.uint64(32)) | lo)[keep]
        base = (dst[:, None] + spread)[keep]
        out = base[:, None] + copies
        yield out.reshape(-1), np.repeat(counters, copies.size)


def jax_counters(phys, shape, f, offset, channels_last, image):
    """The JAX flat counter of each output element given by its index in
    the output's bytes; ``image`` is :func:`image_counters`'."""
    N, C, H, W = shape
    n, within = np.divmod(phys, C * H * W)
    rel = n * (C * (H // f) * (W // f)) + image[within]
    return np.uint64(offset) + rel.astype(np.uint64)


def image_counters(shape, f, channels_last):
    """The flat index in the draw of each element of the output's first
    image, in the output's order of bytes."""
    _, C, H, W = shape
    y = (np.arange(H) // f)[:, None, None]
    x = (np.arange(W) // f)[None, :, None]
    c = np.arange(C)[None, None, :]
    rel = (y * (W // f) + x) * C + c  # (H, W, C)
    return (rel if channels_last else rel.transpose(2, 0, 1)).reshape(-1)


def check_walk(shape, f, offset, channels_last, dtype):
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    plan = pk.normal_plan(shape, f, fmt, dtype, offset)
    assert plan.V == 16 // dtype.itemsize
    total_out = int(np.prod(shape))
    count = np.zeros(total_out, np.uint8)
    image = image_counters(shape, f, channels_last)
    for phys, counters in walk(plan, shape, f, offset):
        if phys.size == 0:
            continue
        lo, hi = int(phys.min()), int(phys.max()) + 1
        count[lo:hi] += np.bincount(phys - lo, minlength=hi - lo).astype(
            np.uint8)
        want = jax_counters(phys, shape, f, offset, channels_last, image)
        np.testing.assert_array_equal(counters, want)
    assert (count == 1).all(), (
        f"{int((count == 0).sum())} elements never stored, "
        f"{int((count > 1).sum())} stored more than once")
    return plan


# name: ((N, C, H, W), f, offset, channels_last, output types).  The card
# draws every THREEFRY_CASES case in both types, the paths' and the timed
# shapes in theirs.
CASES = {name: (shape, f, offset, cl, ("V4", "V8"))
         for name, (_, shape, f, offset, cl)
         in chip_smoke.THREEFRY_CASES.items()}
CASES.update({name: (shape, 1, 0, cl,
                     ("V8", "V4") if dtype == "bfloat16" else ("V4",))
              for name, (_, shape, dtype, cl)
              in chip_smoke.THREEFRY_PATH_CASES.items()})
CASES.update({f"timed {name}": (shape, f, 0, cl, ("V4",))
              for name, (shape, f, cl)
              in chip_smoke.THREEFRY_TIMED_MORE.items()})
# The timed b128 draw (f32 and bf16) is the path's b128 shape.
assert (chip_smoke.THREEFRY_TIMED, 1, 0, True, ("V8", "V4")) in CASES.values()
# Ragged V edges: C and W / f around multiples of 4 and 8, one pixel, one
# column, and an offset near 2^64.
CASES.update({name: case + (("V4", "V8"),) for name, case in {
    "C1 W1": ((2, 1, 3, 1), 1, 0, False),
    "C1 W1 channels_last": ((2, 1, 3, 1), 1, 0, True),
    "C3 f4 channels_last": ((1, 3, 8, 12), 4, 7, True),
    "C9 f4 W 12": ((2, 9, 8, 12), 4, 2 ** 32 - 5, False),
    "C11 W 9 f1": ((3, 11, 5, 9), 1, 3, False),
    "C16 f2 W 2": ((2, 16, 6, 2), 2, 0, True),
    "offset near 2^64": ((1, 3, 4, 5), 1, 2 ** 64 - 60, False),
    "offset near 2^64 channels_last": ((1, 3, 4, 5), 1, 2 ** 64 - 60, True),
}.items()})


@pytest.mark.parametrize("name,vals", [
    (name, vals) for name in sorted(CASES) for vals in CASES[name][4]])
def test_walk_stores_every_element_once_with_its_counter(name, vals):
    shape, f, offset, cl, _ = CASES[name]
    plan = check_walk(shape, f, offset, cl, DTYPES[vals])
    N, C, H, W = shape
    total = N * C * (H // f) * (W // f)
    assert plan.carry == ((offset >> 32) != ((offset + total - 1) >> 32))


def _bits_through_walk(key, shape, f, offset, channels_last):
    """The emulated walk's stores of threefry2x32 bits of their counters,
    as the (N, C, H, W) int32 tensor in the asked memory format."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    plan = pk.normal_plan(shape, f, fmt, torch.int32, offset)
    N, C, H, W = shape
    flat = np.zeros(N * C * H * W, np.int64)
    k0, k1 = prng.key_words(key)
    for phys, counters in walk(plan, shape, f, offset):
        hi = torch.from_numpy((counters >> np.uint64(32)).astype(np.int64))
        lo = torch.from_numpy((counters & np.uint64(M32)).astype(np.int64))
        y0, y1 = prng.threefry2x32(torch.tensor(k0), torch.tensor(k1), hi,
                                   lo)
        flat[phys] = (y0 ^ y1).numpy()
    bits = torch.from_numpy(flat.astype(np.uint32).view(np.int32))
    if channels_last:
        return bits.reshape(N, H, W, C).permute(0, 3, 1, 2)
    return bits.reshape(N, C, H, W)


SMALL = [name for name, (shape, *_) in CASES.items()
         if np.prod(shape) <= 20000]


@pytest.mark.parametrize("name", SMALL)
def test_walk_through_the_hash_is_threefry_bits(name):
    shape, f, offset, cl, _ = CASES[name]
    fmt = torch.channels_last if cl else torch.contiguous_format
    key = prng.prng_key(17)
    got = _bits_through_walk(key, shape, f, offset, cl)
    want = pk.threefry_bits(key, shape, f=f, offset=offset,
                            memory_format=fmt)
    assert torch.equal(got, want)


def test_a_wrong_carry_flag_shows():
    """The emulation holds the carry flag: without the carry instance, a
    run that crosses 2^32 hashes the wrong hi word."""
    shape, f, offset, cl, _ = CASES["offset 2^32-3 N2 C5 9x7 channels_last"]
    plan = pk.normal_plan(shape, f, torch.channels_last, torch.float32,
                          offset)._replace(carry=False)
    mismatched = 0
    for phys, counters in walk(plan, shape, f, offset):
        want = jax_counters(phys, shape, f, offset, cl,
                            image_counters(shape, f, cl))
        mismatched += int((counters != want).sum())
    assert mismatched > 0


def test_magic_divisor_divides():
    rng = np.random.RandomState(0)
    q = np.concatenate([np.arange(5000), rng.randint(0, 2 ** 31, 20000),
                        [2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30]]).astype(np.int64)
    for d in [*range(1, 70), 128, 255, 256, 1000, 4095, 65535, 2 ** 30 + 1,
              2 ** 31 - 1]:
        mul, shift = pk.magic_divisor(d)
        assert 0 <= mul <= M32
        np.testing.assert_array_equal(divide(q, mul, shift), q // d)
    with pytest.raises(ValueError):
        pk.magic_divisor(0)


def test_plan_walks_and_limits():
    cl, nchw = torch.channels_last, torch.contiguous_format
    p = pk.normal_plan((128, 32, 128, 128), 1, cl, torch.float32)
    assert (p.walk, p.V, p.vec, p.carry, p.block) == (pk.WALK_FLAT, 4, True,
                                                      False, 256)
    assert p.grid == (128 * 128 * 128 * 32 // 4 // 256, 1, 1)
    for shape, f, fmt in (((128, 32, 128, 128), 1, cl),
                          ((2, 33, 14, 10), 2, cl), ((3, 5, 37, 29), 1, nchw)):
        assert (pk.normal_plan(shape, f, fmt, torch.int32)
                == pk.normal_plan(shape, f, fmt, torch.float32))
    p = pk.normal_plan((128, 32, 128, 128), 1, cl, torch.bfloat16)
    assert (p.walk, p.V) == (pk.WALK_FLAT, 8)
    p = pk.normal_plan((128, 32, 128, 128), 2, cl, torch.float32)
    assert (p.walk, p.J, p.vec, p.grid) == (pk.WALK_PIXEL, 8, True,
                                            (2, 64, 128))
    p = pk.normal_plan((2, 33, 14, 10), 2, cl, torch.float32)
    assert (p.J, p.vec) == (9, False)
    p = pk.normal_plan((32, 32, 64, 64), 1, nchw, torch.float32)
    assert (p.walk, p.J, p.vec, p.grid) == (pk.WALK_ROW, 16, True,
                                            (4, 32, 32))
    p = pk.normal_plan((3, 5, 37, 29), 1, nchw, torch.float32)
    assert (p.J, p.vec) == (8, False)
    p = pk.normal_plan((2, 6, 24, 40), 2, nchw, torch.bfloat16)
    assert (p.J, p.vec) == (3, True)  # W 40: 8 values a run, the last 4
    assert pk.normal_plan((1, 1, 4, 4), 1, nchw, torch.float32,
                          2 ** 32 - 8).carry
    assert not pk.normal_plan((1, 1, 4, 4), 1, nchw, torch.float32,
                              2 ** 32 - 16).carry
    with pytest.raises(ValueError, match="grid"):
        pk.normal_plan((65536, 1, 2, 2), 1, nchw, torch.float32)
    with pytest.raises(ValueError, match="grid"):
        pk.normal_plan((1, 70000, 2, 2), 1, nchw, torch.float32)
    with pytest.raises(ValueError, match="grid"):
        pk.normal_plan((1, 32, 8192, 8192), 1, cl, torch.float32)
    with pytest.raises(ValueError, match="64-bit"):
        pk.normal_plan((1, 1, 4, 4), 1, nchw, torch.float32, 2 ** 64 - 8)
    with pytest.raises(TypeError):
        pk.normal_plan((1, 1, 4, 4), 1, nchw, torch.float16)
    with pytest.raises(ValueError, match="memory_format"):
        pk.normal_plan((1, 1, 4, 4), 1, torch.preserve_format, torch.float32)


# Small draws for the A/B on the CPU: tag: ((N, C, H, W), f, dtype,
# channels_last).
AB_SHAPES = {"cl f32": ((2, 5, 6, 8), 1, "float32", True),
             "cl bf16": ((2, 9, 4, 4), 1, "bfloat16", True),
             "nchw f2": ((1, 3, 8, 12), 2, "float32", False)}


def test_threefry_ab_times_this_checkout_in_processes_of_its_own(tmp_path):
    """tools/threefry_ab runs each checkout's wrapper in a process of its
    own (two turns) and holds its outputs to the plain version; on the CPU
    the wrapper is the plain version itself.  Its command line needs a
    card."""
    from sg2im_tpu_torch.tools import threefry_ab

    report = threefry_ab.compare([], "cpu", 1, AB_SHAPES)
    rows = {(r["checkout"], r["draw"]): r for r in report["rows"]}
    assert set(rows) == {("this", tag) for tag in AB_SHAPES}
    for row in rows.values():
        assert row["max_abs_err"] == 0.0 and row["bound_ms"] is None
        assert row["device_ms"] is None
        assert len(row["turns"]) == 2 and row["ms"] == min(row["turns"])
    assert threefry_ab.main(["--other", str(tmp_path), "--device", "cpu",
                             "--out", str(tmp_path)]) == 1


def test_threefry_ab_refuses_a_checkout_whose_t1_disagrees(tmp_path):
    """A checkout whose draw is off past THREEFRY_BAR fails the A/B before
    any time of it is kept."""
    from sg2im_tpu_torch.tools import threefry_ab

    pkg = tmp_path / "sg2im_tpu_torch"
    for sub in ("", "ops", "tools"):
        (pkg / sub).mkdir(exist_ok=True)
        (pkg / sub / "__init__.py").write_text("")
    (pkg / "ops" / "prng.py").write_text(
        "def prng_key(seed):\n"
        "    return seed\n")
    (pkg / "ops" / "prng_kernel.py").write_text(
        "import torch\n"
        "from sg2im_tpu_torch.ops import prng\n"
        "def threefry_normal(key, shape, f=1, dtype=torch.float32,\n"
        "                    offset=0, device=None,\n"
        "                    memory_format=torch.contiguous_format):\n"
        "    return torch.zeros(shape, dtype=dtype).contiguous(\n"
        "        memory_format=memory_format)\n")
    (pkg / "tools" / "_measure.py").write_text(
        "def time_ms(fn, device, iters):\n"
        "    fn()\n"
        "    return 1.0\n"
        "def kernel_table(fn, device, iters):\n"
        "    return None\n")
    with pytest.raises(AssertionError, match="other:.*cl f32.*disagrees"):
        threefry_ab.compare([str(tmp_path)], "cpu", 1, AB_SHAPES)
