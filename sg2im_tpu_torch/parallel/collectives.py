"""Sums across the ranks of a data-parallel group, for a step that must
compute what the one-process step computes on the global batch.

The JAX package shards its step with GSPMD, which computes every batch
statistic and every loss mean over the global batch.  The port runs one
process per rank, so each reduction over the batch becomes a local sum
and one ``all_reduce`` (SUM) across the ranks:

- train-mode BatchNorm: the global count and sum, then the global sum of
  squared deviations from the global mean (``nn.layers.BatchNorm``);
- loss means: each rank's local sum over the global count
  (``losses.masked_mean``); the gradients of those partial losses, summed
  across the ranks, are the gradients of the global loss.

The group is set for a block of code with :func:`global_batch` and read by
the layers and losses running on the same thread; outside such a block
(the default) every function here is the identity and the code paths are
the one-process ones.  Only ``all_reduce`` and ``broadcast`` are used,
the collectives that Gloo also runs on CUDA tensors.  ``all_reduce.calls``
counts the collectives issued (forward and backward) in this process.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_local = threading.local()


def group():
    """The process group of the data-parallel block running on this thread,
    or None."""
    return getattr(_local, "group", None)


def world() -> int:
    """The number of ranks of :func:`group` (1 without one)."""
    g = group()
    return 1 if g is None else dist.get_world_size(g)


@contextlib.contextmanager
def global_batch(pg):
    """Within the block, BatchNorm statistics and loss means on this thread
    are over the global batch of the ranks of ``pg`` (None: no change)."""
    prev = group()
    _local.group = pg
    try:
        yield
    finally:
        _local.group = prev


def all_reduce(t: torch.Tensor, pg) -> torch.Tensor:
    """In-place SUM of ``t`` across the ranks of ``pg``; counted."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=pg)
    all_reduce.calls += 1
    return t


all_reduce.calls = 0


def broadcast(t: torch.Tensor, pg, src: int = 0) -> torch.Tensor:
    """In-place broadcast of ``t`` from rank ``src`` of ``pg``; counted
    with the all-reduces."""
    dist.broadcast(t, src=src, group=pg)
    all_reduce.calls += 1
    return t


class _GlobalSum(torch.autograd.Function):
    """y = sum over the ranks of x.  Every rank's loss depends on y, and the
    objective is the sum of the ranks' losses, so dL/dx on a rank is the
    sum over the ranks of dL_r/dy: the backward is an all-reduce too."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return all_reduce(x.detach().clone(memory_format=torch.contiguous_format),
                          pg)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format),
                          ctx.pg), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` across the ranks of :func:`group`; the
    identity without one."""
    pg = group()
    return x if pg is None else _GlobalSum.apply(x, pg)


def sum_flat(tensors: list, pg) -> list:
    """Every tensor of ``tensors`` summed across the ranks of ``pg`` by one
    all-reduce of their concatenation (float32); new tensors in the
    original shapes and types."""
    if pg is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce(flat, pg)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out
