"""Build and load the port's CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Each source under ``sg2im_tpu_torch/csrc`` becomes its own library, built at
first use into ``build/sg2im_tpu_torch/`` at the root of the checkout under
a name keyed by a hash of the source and flags, so a changed source is
rebuilt and an unchanged one is reused.  The sources build in parallel, one
nvcc process each.  There is no fallback: if ``nvcc`` is missing or a build
fails, :func:`load_library` raises and says why.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sg2im_tpu_torch"
# No --use_fast_math: the tent weights' non-finite test is part of the
# layout contract and fast math may fold it away.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_U32 = ctypes.c_uint
_U64 = ctypes.c_ulonglong
_F32 = ctypes.c_float
# source -> {C entry point: argtypes} (every entry returns cudaError_t as int).
SOURCES = {
    "layout_compose.cu": {
        "sg2im_layout_compose_boxes":
            [_PTR, _PTR, _PTR, _PTR] + [_INT] * 10 + [_PTR],
        "sg2im_layout_compose_weights":
            [_PTR, _PTR, _PTR, _PTR, _PTR] + [_INT] * 12 + [_PTR],
    },
    "conv3x3.cu": {
        "sg2im_conv3x3_bf16": [_PTR] * 5 + [_INT] * 10 + [_PTR],
        "sg2im_conv3x3_s8": [_PTR] * 4 + [_INT] * 8 + [_PTR],
    },
    # x, out, the plan (ops/relayout.PlanStruct), stream.
    "relayout.cu": {
        "sg2im_space_to_depth": [_PTR] * 4,
        "sg2im_depth_to_space": [_PTR] * 4,
    },
    # The addends (three pointers), the BatchNorm's four vectors, out, the
    # plan (ops/crn_epilogue.PlanStruct), stream.
    "crn_epilogue.cu": {
        "sg2im_crn_epilogue": [_PTR] * 10,
    },
    # x, the BatchNorm's four vectors, the folded weights, the conv's
    # bias, the 1x1 conv's weight and bias, out, the plan
    # (ops/mask_head.PlanStruct), stream.
    "mask_head.cu": {
        "sg2im_mask_head_step": [_PTR] * 12,
    },
    # resample.cu: the pyramid's x, a host array of its levels' pointers,
    # the plan (ops/resample.PoolPlanStruct), stream; the upsample's x,
    # out, the plan (UpPlanStruct), stream.
    "resample.cu": {
        "sg2im_pool_pyramid": [_PTR] * 4,
        "sg2im_upsample2": [_PTR] * 4,
    },
    "threefry.cu": {
        "sg2im_threefry_normal": [_PTR, _PTR, _U32, _U32, _U64] + [_INT] * 10
        + [_U32, _INT, _INT] + [_U32] * 3 + [_F32, _PTR],
        "sg2im_threefry_uniform": [_PTR, _PTR, _U32, _U32, _U64, _U64]
        + [_F32] * 3 + [_PTR],
        "sg2im_threefry_split": [_PTR, _PTR, _U32, _U32, _INT, _PTR],
        "sg2im_threefry_empty": [_PTR],
    },
}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the CUDA kernels of sg2im_tpu_torch cannot be "
        "built, and CUDA tensors have no other path")


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    h.update(source.encode())
    h.update((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, tuple[Path, float, str]]:
    """Compile every source whose keyed library does not exist yet, all
    nvcc processes started together.

    Returns {source: (library path, build seconds (0.0 when reused),
    compiler log)}.
    """
    done, running = {}, {}
    for source in SOURCES:
        out = library_path(source)
        if out.is_file():
            done[source] = (out, 0.0, "")
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build under a temporary name and rename: concurrent processes
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[source] = (proc, cmd, tmp, out, time.perf_counter())
    failed = []
    for source, (proc, cmd, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed (exit {proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        done[source] = (out, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.cache
def load_library() -> types.SimpleNamespace:
    """Build if needed, load every library, and declare the C entry points;
    returns them as attributes of one namespace."""
    entries = {}
    for source, (path, _, _) in build().items():
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SOURCES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            entries[name] = fn
    return types.SimpleNamespace(**entries)
