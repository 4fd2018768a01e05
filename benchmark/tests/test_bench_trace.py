"""The traced slice's reduction on made-up profiler events: the slice runs
between the last two spin launches, the busy time is the union of the
device intervals inside it, and each idle gap is named by the host event
that ran over it."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def event(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_the_slice_runs_between_the_markers_and_counts_overlaps_once():
    events = [event("spin_kernel", 0, 2), event("spin_kernel", 5, 6),
              event("early", 1, 50),
              event("spin_kernel", 100, 101),
              event("gemm", 110, 330), event("relu", 200, 400),
              event("copy", 600, 700),
              event("spin_kernel", 1100, 1101),
              event("late", 1200, 1300),
              event("benchmark.generate", 100, 1100),
              event("benchmark.generate", 100, 1100, CPU),
              event("cudaDeviceSynchronize", 700, 1100, CPU),
              event("aten::cat", 420, 590, CPU)]
    s = trace.reduce(events)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((400 - 110 + 700 - 600) * 1e-6)
    assert [n for n, _ in s.device_ops] == ["gemm", "relu", "copy"]
    assert sorted(n for n, _ in s.kernels) == ["copy", "gemm", "relu"]
    assert s.gaps[0] == ("cudaDeviceSynchronize", pytest.approx(400e-6))
    assert s.gaps[1] == ("aten::cat", pytest.approx(200e-6))
    assert s.gaps[2] == ("benchmark.generate", pytest.approx(10e-6))


def test_a_slice_without_its_markers_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce([event("spin_kernel", 0, 1), event("gemm", 2, 3)])
