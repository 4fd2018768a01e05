"""argparse flag types (counterpart of ``sg2im_tpu/utils/flags.py``,
upstream ``sg2im/utils.py``)."""

from __future__ import annotations

import argparse


def int_tuple(s: str):
    return tuple(int(i) for i in s.split(","))


def float_tuple(s: str):
    return tuple(float(i) for i in s.split(","))


def str_tuple(s: str):
    return tuple(s.split(","))


def bool_flag(s: str):
    if s in ("1", "true", "True"):
        return True
    if s in ("0", "false", "False"):
        return False
    raise argparse.ArgumentTypeError(
        f'Invalid value "{s}" for bool flag (should be 0/1 or True/False)')
