"""Framework-free helpers: flag types, metrics, timing and the card's
roofline (``utils.roofline``); the names of ``sg2im_tpu/utils/``."""

from sg2im_tpu_torch.utils.flags import (
    bool_flag,
    float_tuple,
    int_tuple,
    str_tuple,
)
from sg2im_tpu_torch.utils.metrics import (
    grad_global_norm,
    intersection,
    jaccard,
    psnr,
)
from sg2im_tpu_torch.utils.timing import (
    LossManager,
    get_device_memory,
    profile_trace,
    timeit,
)

__all__ = [
    "LossManager",
    "bool_flag",
    "float_tuple",
    "get_device_memory",
    "grad_global_norm",
    "int_tuple",
    "intersection",
    "jaccard",
    "profile_trace",
    "psnr",
    "str_tuple",
    "timeit",
]
