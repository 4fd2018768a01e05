"""Host-side batch loader: parallel sample decoding -> padded batches, and
their prefetch to the card (counterpart of ``sg2im_tpu/data/loader.py``).

Replaces the reference's torch ``DataLoader(collate_fn=coco_collate_fn)``
(``scripts/train.py:288-306``; 4 worker processes): samples are decoded by a
thread pool (PIL, libjpeg and numpy release the interpreter lock for the
heavy parts) and collated into **static-shape padded** batch dicts of
numpy arrays, NHWC images as the JAX package's loader gives them (tests
hold the two loaders' batches equal), with a bounded queue so the step
does not wait on the host.  :func:`prefetch_to_device` stages each batch
in pinned host memory and copies it to the card on a side stream while the
step before it runs; images leave it NCHW.

The ragged collate + ``obj_to_img`` layout of the reference
(``sg2im/data/coco.py:376-419``) is replaced by per-image padding
(SURVEY.md §2.4).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


_TRUNC_WARNED = False


def collate_padded(samples, O_max: int, T_max: int, drop_excess: bool = True):
    """Collate per-sample dicts into one padded batch dict.

    Graphs exceeding (O_max, T_max) are truncated (objects keep the
    ``__image__`` node last; triples referencing dropped objects vanish) —
    with reference-default caps (COCO <=9 objects, VG <=11) and sane pads
    this never triggers.
    """
    N = len(samples)
    H, W, _ = samples[0]["image"].shape
    has_masks = samples[0].get("masks") is not None
    M = samples[0]["masks"].shape[-1] if has_masks else 0

    out = {
        "imgs": np.zeros((N, H, W, 3), np.float32),
        "objs": np.zeros((N, O_max), np.int32),
        "boxes": np.zeros((N, O_max, 4), np.float32),
        "triples": np.zeros((N, T_max, 3), np.int32),
        "obj_mask": np.zeros((N, O_max), np.float32),
        "triple_mask": np.zeros((N, T_max), np.float32),
    }
    if has_masks:
        out["masks"] = np.zeros((N, O_max, M, M), np.float32)

    for n, s in enumerate(samples):
        objs = np.asarray(s["objs"])
        triples = np.asarray(s["triples"]).reshape(-1, 3)
        O = len(objs)
        if O > O_max:
            if not drop_excess:
                raise ValueError(f"graph with {O} objects > O_max={O_max}")
            global _TRUNC_WARNED
            if not _TRUNC_WARNED:
                _TRUNC_WARNED = True
                warnings.warn(
                    f"collate_padded: graph with {O} objects truncated to "
                    f"O_max={O_max} (their relationships drop too); raise "
                    f"pad_objects_to to keep all objects", stacklevel=2)
            # keep first O_max-1 + the __image__ node (last)
            keep = list(range(O_max - 1)) + [O - 1]
            remap = {k: i for i, k in enumerate(keep)}
            objs = objs[keep]
            triples = np.asarray(
                [[remap[s_], p, remap[o_]] for s_, p, o_ in triples
                 if s_ in remap and o_ in remap], np.int64).reshape(-1, 3)
            s = dict(s, boxes=np.asarray(s["boxes"])[keep],
                     masks=(np.asarray(s["masks"])[keep]
                            if has_masks else None))
            O = O_max
        if len(triples) > T_max:
            if not _TRUNC_WARNED:
                _TRUNC_WARNED = True
                warnings.warn(
                    f"collate_padded: graph with {len(triples)} triples "
                    f"truncated to T_max={T_max}; raise pad_triples_to to "
                    f"keep all relationships", stacklevel=2)
        T = min(len(triples), T_max)
        out["imgs"][n] = s["image"]
        out["objs"][n, :O] = objs
        out["obj_mask"][n, :O] = 1.0
        out["boxes"][n, :O] = np.asarray(s["boxes"])[:O]
        out["triples"][n, :T] = triples[:T]
        out["triple_mask"][n, :T] = 1.0
        if has_masks:
            out["masks"][n, :O] = np.asarray(s["masks"])[:O]
    return out


class PaddedLoader:
    """Iterable over padded batch dicts with threaded decode + prefetch."""

    def __init__(self, dataset, batch_size: int, O_max: int, T_max: int,
                 shuffle: bool = True, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0, drop_last: bool = True,
                 shard: tuple[int, int] | None = None,
                 batch_decode: bool = True):
        """``shard=(host_index, host_count)`` gives each host a disjoint
        1/host_count slice of every epoch's permutation — the multi-host
        data-parallel contract (all hosts share the shuffle seed).

        ``batch_decode``: when the dataset exposes ``decode_images_batch``
        (COCO/VG), decode each batch's images in ONE GIL-free C++
        thread-pool call (``native/imagedec.cpp``) instead of per-sample
        inside the Python worker threads — same bytes, less GIL traffic.
        Automatically inapplicable (and skipped) when a decoded-sample
        cache is active or the native decoder is unavailable."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.O_max = O_max
        self.T_max = T_max
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        # Queue(maxsize<=0) is UNBOUNDED per the stdlib contract — the
        # producer would decode the whole epoch ahead (gigabytes resident).
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.batch_decode = batch_decode
        self._epoch = 0
        self._skip = 0
        # Seconds the consumer has blocked on the queue, over all epochs.
        self.wait_seconds = 0.0

    def start_at(self, step: int):
        """Make the next iteration begin where an uninterrupted run of
        ``step`` batches from a fresh loader would be: the same epoch (so
        the same shuffle and per-sample draws) and the batch after the
        ``step``-th.  The batches skipped are not decoded.  A resumed
        training run calls this so that it sees the same data as a run
        that was never stopped."""
        per_epoch = len(self)
        if per_epoch == 0:
            return
        self._epoch, self._skip = divmod(int(step), per_epoch)

    def _shard_slice(self, idx):
        if self.shard is None:
            return idx
        k, count = self.shard
        per = len(idx) // count
        return idx[k * per:(k + 1) * per]

    def __len__(self):
        n = len(self.dataset)
        if self.shard is not None:
            n = n // self.shard[1]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self, epoch: int):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            # The epoch is the caller's bound value, not self._epoch: the
            # producer thread runs this after __iter__ returns, by which
            # time another iterator may have bumped the shared counter.
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        idx = self._shard_slice(idx)
        n = len(idx)
        end = (n - n % self.batch_size) if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield idx[i:i + self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        epoch = self._epoch
        skip, self._skip = self._skip, 0
        # Advance the dataset's order-independent RNG stream so seeded
        # sampling re-rolls per epoch yet stays reproducible for any
        # num_workers (sg2im_tpu_torch.data.seeding).  The epoch is BOUND to
        # this iterator (getitem_at_epoch), never written into shared
        # dataset state: a mid-epoch eval sweep spawning a second iterator
        # must not perturb the live train iterator's in-flight samples.
        if hasattr(self.dataset, "getitem_at_epoch"):
            def fetch(i, _e=epoch, image=None):
                if image is not None:
                    return self.dataset.getitem_at_epoch(i, _e, image=image)
                return self.dataset.getitem_at_epoch(i, _e)
        else:
            set_epoch = getattr(self.dataset, "set_epoch", None)
            if set_epoch is not None:
                set_epoch(epoch)
            fetch = self.dataset.__getitem__
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # Bounded put that aborts when the consumer abandoned iteration
            # (a plain q.put would block forever and leak the thread pool).
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        decode_batch = (getattr(self.dataset, "decode_images_batch", None)
                        if (self.batch_decode
                            and hasattr(self.dataset, "getitem_at_epoch"))
                        else None)

        def producer():
            nonlocal decode_batch
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for j, batch_idx in enumerate(
                            self._index_batches(epoch)):
                        if stop.is_set():
                            return
                        if j < skip:
                            continue
                        images = None
                        if decode_batch is not None:
                            images = decode_batch(
                                batch_idx, n_threads=self.num_workers)
                            if images is None:  # inapplicable: stop asking
                                decode_batch = None
                        if images is None:
                            samples = list(pool.map(fetch, batch_idx))
                        else:
                            samples = list(pool.map(fetch, batch_idx,
                                                    [epoch] * len(batch_idx),
                                                    images))
                        if not put_or_stop(collate_padded(
                                samples, self.O_max, self.T_max)):
                            return
                put_or_stop(None)
            except BaseException as exc:  # surface in the consumer
                put_or_stop(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


_INT_KEYS = ("objs", "triples")


class _PinnedSlot:
    """Pinned host buffers for one batch in flight, reused for a later
    batch only after the copy out of them has finished."""

    def __init__(self):
        self.buffers: dict[str, torch.Tensor] = {}
        self.copied: torch.cuda.Event | None = None

    def stage(self, batch: dict, stream, device) -> tuple[dict, object]:
        """Copy ``batch`` into the buffers (imgs NHWC -> NCHW, objs and
        triples to int64, the rest to float32: what the train step takes),
        then issue its copy to ``device`` on ``stream``."""
        if self.copied is not None:
            self.copied.synchronize()
        host = {}
        for k, v in batch.items():
            if v is None:
                continue
            src = torch.from_numpy(np.asarray(v))
            if k == "imgs":
                src = src.permute(0, 3, 1, 2)
            dtype = torch.int64 if k in _INT_KEYS else torch.float32
            buf = self.buffers.get(k)
            if buf is None or buf.shape != src.shape:
                buf = torch.empty(src.shape, dtype=dtype, pin_memory=True)
                self.buffers[k] = buf
            buf.copy_(src)
            host[k] = buf
        with torch.cuda.stream(stream):
            out = {k: b.to(device, non_blocking=True)
                   for k, b in host.items()}
            self.copied = torch.cuda.Event()
            self.copied.record(stream)
        return {k: out.get(k) for k in batch}, self.copied


def _on_compute_stream(staged, device) -> dict:
    """The compute stream waits for the batch's copy; its tensors are then
    in use on that stream (so their memory is not reused before it is done
    with them)."""
    batch, copied = staged
    compute = torch.cuda.current_stream(device)
    compute.wait_event(copied)
    for v in batch.values():
        if v is not None:
            v.record_stream(compute)
    return batch


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Wrap an iterator of host batches (numpy, as :class:`PaddedLoader`
    gives them) so that each batch's copy to the card overlaps the steps
    before it.

    On a CUDA ``device``, up to ``size`` batches are in flight: each is
    staged into a ring of pinned host buffers (``size + 1`` of them; a
    buffer is written again only after its copy has finished) and copied
    with ``non_blocking`` on a side stream; the compute stream waits on the
    copy's event before the batch is yielded.  Yielded batches hold CUDA
    tensors: imgs (N, 3, H, W) float32, objs and triples int64, the rest
    float32 (``Trainer.to_device`` then copies nothing).  On the CPU the
    batches pass through unchanged.
    """
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    stream = torch.cuda.Stream(device)
    slots = [_PinnedSlot() for _ in range(size + 1)]
    pending = collections.deque()
    for i, batch in enumerate(iterator):
        pending.append(slots[i % len(slots)].stage(batch, stream, device))
        if len(pending) >= size:
            yield _on_compute_stream(pending.popleft(), device)
    while pending:
        yield _on_compute_stream(pending.popleft(), device)
