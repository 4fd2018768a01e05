"""Image metrics of the fidelity gate (counterpart of
``sg2im_tpu/utils/metrics.py::psnr``)."""

from __future__ import annotations

import numpy as np


def psnr(a, b, max_val: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two images or batches (dB)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val * max_val / mse))
