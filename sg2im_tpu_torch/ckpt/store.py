"""Native checkpoints of the port's train state: save and resume
(counterpart of ``sg2im_tpu/ckpt/store.py``, upstream's monolithic
``torch.save`` of ``scripts/train.py:473-500,611-661``).

Layout: ``<path>/state.pt`` holds every tensor of the
:class:`~sg2im_tpu_torch.train.state.TrainState` (three models, three
optimizers, the step and the layout-noise generator state) under flat
names; ``<path>/meta.json`` the config, the vocab and the caller's
``extra``; ``<path>/history.npz`` optional numpy arrays too large for the
JSON.  The state file is written to a temporary name and renamed, so a
reader never sees a partial one.

``save_checkpoint(..., wait=False)`` copies the state to host memory
before it returns (the caller may go on stepping at once) and writes the
files on a writer thread; a later save, any load and :func:`wait_pending`
join that write first and re-raise its error.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import threading

import numpy as np
import torch

from sg2im_tpu_torch.train.state import from_tensors, tensors

_pending = None  # the _Writer of an async save, until joined
_atexit_registered = False


def _meta_default(o):
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


class _Writer:
    """A writer thread that keeps its exception for :func:`wait_pending`."""

    def __init__(self, fn):
        self.error: BaseException | None = None

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised on join
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()


def wait_pending():
    """Block until an async write has finished; re-raise its error."""
    global _pending
    if _pending is None:
        return
    pending, _pending = _pending, None
    pending.join()
    if pending.error is not None:
        raise pending.error


def _wait_pending_at_exit():  # pragma: no cover — interpreter shutdown
    try:
        wait_pending()
    except Exception as e:  # noqa: BLE001 — report, do not mask the exit
        print(f"WARNING: async checkpoint write failed at exit: {e!r}")


def _write(path, host, config, vocab, extra, arrays):
    final = os.path.join(path, "state.pt")
    tmp = f"{final}.tmp{os.getpid()}"
    torch.save(host, tmp)
    os.replace(tmp, final)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"config": config, "vocab": vocab, "extra": extra}, f,
                  default=_meta_default)
    if arrays is not None:
        np.savez(os.path.join(path, "history.npz"),
                 **{k: np.asarray(v) for k, v in arrays.items()})


def save_checkpoint(path: str, state, config=None, vocab=None, extra=None,
                    arrays=None, wait: bool = True):
    """Write ``state`` under the directory ``path``.  ``arrays``: an
    optional flat dict of numpy arrays (histories), written beside."""
    global _pending, _atexit_registered
    wait_pending()  # one write at a time, in order
    os.makedirs(path, exist_ok=True)
    host = {k: v.detach().to("cpu", copy=True)
            for k, v in tensors(state).items()}
    if wait:
        _write(path, host, config, vocab, extra, arrays)
        return
    if not _atexit_registered:
        # Join the writer on any interpreter exit: a daemon thread would
        # otherwise die mid-write.
        atexit.register(_wait_pending_at_exit)
        _atexit_registered = True
    _pending = _Writer(lambda: _write(path, host, config, vocab, extra,
                                      arrays))


def load_checkpoint(path: str, device="cpu"):
    """-> (state on ``device``, meta); meta holds ``config``, ``vocab``,
    ``extra`` and, when saved, ``arrays``.  The layout-noise generator
    state stays a CPU tensor, as ``torch.Generator.get_state`` gives it."""
    wait_pending()
    flat = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=True)
    state = from_tensors({k: v if k == "noise_rng" else v.to(device)
                          for k, v in flat.items()})
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    hist = os.path.join(path, "history.npz")
    if os.path.exists(hist):
        with np.load(hist) as z:
            meta["arrays"] = {k: z[k] for k in z.files}
    return state, meta
