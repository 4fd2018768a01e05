"""The device a run uses: a CUDA card in every run of the benchmark; the
CPU only where the harness's own tests drive a run at a tiny size."""

from __future__ import annotations

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def info(device, chips: int) -> dict:
    """The result line's ``device``: the card's name, the cards used and
    the peak of the memory allocated on the card."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
