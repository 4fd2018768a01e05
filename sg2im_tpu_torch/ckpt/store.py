"""Checkpoints of the port's train state: save and resume, in the port's
own format or in the JAX store's (counterpart of ``sg2im_tpu/ckpt/store.py``,
upstream's monolithic ``torch.save`` of ``scripts/train.py:473-500,611-661``).

One directory holds one checkpoint in one of two formats, the ``backend``:

- ``'torch'``: ``state.pt`` holds every tensor of the
  :class:`~sg2im_tpu_torch.train.state.TrainState` (three models, three
  optimizers, the step and the threefry key) under flat names;
  ``history.npz`` the caller's flat arrays.  A ``state.pt`` written before
  the port drew the JAX package's noise holds a ``torch.Generator`` state
  (``noise_rng``) in place of the key, which cannot become one: it loads
  with the key a fresh run of its config holds at step 0, and the load's
  meta says so (``meta['rng_restarted']``).
- ``'msgpack'``: the JAX store's default format, which the JAX package's
  ``load_checkpoint`` restores and its training CLI resumes.
  ``state.msgpack`` holds the JAX package's ``TrainState`` in flax's
  msgpack format (``ckpt.msgpack``; the tree of
  ``ckpt.jax_tree_from_train_state``); ``history.msgpack`` the arrays as
  the JAX CLI nests them, ``{kind: [{key: array}]}``.  The key crosses
  unchanged both ways, so either package continues the other's noise.

Both put ``meta.json`` (the config, the vocab and the caller's ``extra``)
beside.  :func:`load_checkpoint` reads either; :func:`save_checkpoint`
keeps the format a directory already holds unless told otherwise, so a JAX
run resumed here stays resumable by the JAX package.  The JAX store's
opt-in Orbax format (``state_orbax/``) is refused with a message.

The state file is written to a temporary name and renamed, so a reader
never sees a partial one; then the other formats' state and history are
removed, so a later load cannot pick up a stale one.
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
import shutil
import threading

import numpy as np
import torch

from sg2im_tpu_torch.ckpt import (
    jax_tree_from_train_state,
    train_state_from_jax,
)
from sg2im_tpu_torch.ckpt.msgpack import msgpack_restore, msgpack_serialize
from sg2im_tpu_torch.ops.prng import prng_key, split
from sg2im_tpu_torch.train.state import from_tensors, tensors

STATE_FILES = {"torch": "state.pt", "msgpack": "state.msgpack"}
HISTORY_FILES = {"torch": "history.npz", "msgpack": "history.msgpack"}
ORBAX_DIR = "state_orbax"  # the JAX store's opt-in format, not read here

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


def _held(path) -> str | None:
    """The backend of the state file in ``path``, or None: the newer one
    where a save stopped between its rename and its removal of the
    other."""
    held = [b for b, name in STATE_FILES.items()
            if os.path.exists(os.path.join(path, name))]
    if not held:
        return None
    return max(held, key=lambda b: os.path.getmtime(
        os.path.join(path, STATE_FILES[b])))


def _checkpoint_backend(path) -> str:
    """'torch' or 'msgpack', the format of the checkpoint directory
    ``path``; ValueError naming what ``path`` holds where it holds
    neither state file."""
    backend = _held(path)
    if backend is not None:
        return backend
    if os.path.isdir(os.path.join(path, ORBAX_DIR)):
        raise ValueError(
            f"{path} holds an Orbax checkpoint ({ORBAX_DIR}/), which the "
            "port does not read: save it with the JAX store's default "
            "msgpack backend (sg2im_tpu.ckpt.store.save_checkpoint(..., "
            "backend='msgpack'), SG2IM_TPU_CKPT unset) to get state.msgpack")
    if not os.path.isdir(path):
        raise ValueError(f"{path}: no checkpoint directory there")
    found = sorted(os.listdir(path))
    raise ValueError(
        f"{path}: no state.pt or state.msgpack; it holds "
        + (", ".join(found[:8]) + (" ..." if len(found) > 8 else "")
           if found else "nothing"))


def _flat_history(tree: dict) -> dict:
    """The JAX CLI's nested arrays ``{kind: [{key: array}]}`` -> the port's
    flat names ``<kind>/<i>/<key>`` (``cli.train.flatten_samples``); an
    array at the top keeps its name."""
    out = {}
    for kind, v in tree.items():
        if isinstance(v, list):
            out.update({f"{kind}/{i}/{key}": a for i, rec in enumerate(v)
                        for key, a in rec.items()})
        else:
            out[kind] = v
    return out


def _nested_history(flat: dict) -> dict:
    """Inverse of :func:`_flat_history`."""
    out: dict = {}
    for name, a in flat.items():
        parts = name.split("/", 2)
        if len(parts) == 3 and parts[1].isdigit():
            evals = out.setdefault(parts[0], [])
            i = int(parts[1])
            evals.extend({} for _ in range(i + 1 - len(evals)))
            evals[i][parts[2]] = np.asarray(a)
        else:
            out[name] = np.asarray(a)
    return out


def _write(path, backend, host, config, vocab, extra, arrays):
    final = os.path.join(path, STATE_FILES[backend])
    tmp = f"{final}.tmp{os.getpid()}"
    if backend == "torch":
        torch.save(host, tmp)
    else:
        data = msgpack_serialize(jax_tree_from_train_state(
            from_tensors(host)))
        with open(tmp, "wb") as f:
            f.write(data)
    os.replace(tmp, final)
    for other in STATE_FILES:
        if other != backend:
            for name in (STATE_FILES[other], HISTORY_FILES[other]):
                if os.path.exists(os.path.join(path, name)):
                    os.remove(os.path.join(path, name))
    if os.path.isdir(os.path.join(path, ORBAX_DIR)):
        shutil.rmtree(os.path.join(path, ORBAX_DIR))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"config": config, "vocab": vocab, "extra": extra}, f,
                  default=_meta_default)
    if arrays is None:
        return
    hist = os.path.join(path, HISTORY_FILES[backend])
    if backend == "torch":
        np.savez(hist, **{k: np.asarray(v) for k, v in arrays.items()})
    else:
        with open(hist, "wb") as f:
            f.write(msgpack_serialize(_nested_history(arrays)))


def save_checkpoint(path: str, state, config=None, vocab=None, extra=None,
                    arrays=None, wait: bool = True,
                    backend: str | None = None):
    """Write ``state`` under the directory ``path``.  ``arrays``: an
    optional flat dict of numpy arrays (histories), written beside.
    ``backend``: 'torch' or 'msgpack' (see the module docstring); None
    keeps the format ``path`` holds, 'torch' in a new directory."""
    global _pending, _atexit_registered
    wait_pending()  # one write at a time, in order
    os.makedirs(path, exist_ok=True)
    backend = backend or _held(path) or "torch"
    if backend not in STATE_FILES:
        raise ValueError(f"backend {backend!r}: the port writes "
                         f"{sorted(STATE_FILES)}")
    host = {k: v.detach().to("cpu", copy=True)
            for k, v in tensors(state).items()}
    if wait:
        _write(path, backend, host, config, vocab, extra, arrays)
        return
    if not _atexit_registered:
        # Join the writer on any interpreter exit: a daemon thread would
        # otherwise die mid-write.
        atexit.register(_wait_pending_at_exit)
        _atexit_registered = True
    _pending = _Writer(lambda: _write(path, backend, host, config, vocab,
                                      extra, arrays))


def load_checkpoint(path: str, device="cpu"):
    """-> (state on ``device``, meta) from either format; meta holds
    ``config``, ``vocab``, ``extra`` and, when saved, ``arrays`` (flat
    names in both formats).  A ``state.pt`` without a key (see the module
    docstring) gets the key of a fresh run of its config,
    ``split(PRNGKey(seed), 5)[0]``, and ``meta['rng_restarted'] = True``."""
    wait_pending()
    backend = _checkpoint_backend(path)
    state_path = os.path.join(path, STATE_FILES[backend])
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if backend == "torch":
        flat = torch.load(state_path, map_location="cpu", weights_only=True)
        if "rng" not in flat:
            flat.pop("noise_rng", None)
            seed = int((meta.get("config") or {}).get("seed", 0))
            flat["rng"] = split(prng_key(seed), 5)[0]
            meta["rng_restarted"] = True
        state = from_tensors({k: v.to(device) for k, v in flat.items()})
    else:
        with open(state_path, "rb") as f:
            state = train_state_from_jax(msgpack_restore(f.read()), device)
    hist = os.path.join(path, HISTORY_FILES[backend])
    if os.path.exists(hist) and backend == "torch":
        with np.load(hist) as z:
            meta["arrays"] = {k: z[k] for k in z.files}
    elif os.path.exists(hist):
        with open(hist, "rb") as f:
            meta["arrays"] = _flat_history(msgpack_restore(f.read()))
    return state, meta
