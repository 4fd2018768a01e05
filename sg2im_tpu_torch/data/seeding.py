"""Order-independent per-sample RNG derivation for dataset workers
(counterpart of ``sg2im_tpu/data/seeding.py``).

The reference draws dataset randomness (COCO heuristic-triple synthesis,
``sg2im/data/coco.py:297-356``; VG object sampling, ``sg2im/data/vg.py:
85-104``) from torch's per-worker global RNG, so results depend on the
DataLoader worker layout.  Here every ``__getitem__`` derives its own
``random.Random`` from ``(seed, epoch, index)`` — identical output for any
``num_workers`` and any visit order, while still re-rolling fresh graphs
each epoch (loaders bump the epoch via ``set_epoch``).
"""

from __future__ import annotations

import random

# Odd 64-bit multipliers (splitmix64 constants) keep nearby
# (seed, epoch, index) triples from colliding.
_MIX_A = 0x9E3779B97F4A7C15
_MIX_B = 0xBF58476D1CE4E5B9
_MASK = (1 << 64) - 1


def per_sample_rng(seed: int | None, epoch: int, index: int):
    """A ``random.Random`` unique to (seed, epoch, index).

    ``seed=None`` preserves the legacy order-dependent behavior (the
    process-global ``random`` module) for parity tests that drive the
    global seed the way the reference does.
    """
    if seed is None:
        return random
    # int() guards against numpy integer operands (fixed-width overflow).
    mixed = (int(seed) * _MIX_A + int(epoch) * _MIX_B + int(index) + 1) & _MASK
    return random.Random(mixed)
