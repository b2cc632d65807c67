"""Host-side input pipeline (counterpart of `posecnn_tpu/data/pipeline.py:25-160`).

`RatioSampler` interleaves the real and synthetic streams at integer
ratios; `ShuffledIndexer` gives each epoch's frames in a seeded shuffled
order, sharded across processes (a data-parallel rank's `process_index`
of `process_count`, as JAX's hosts split them). Both are the original's,
draw for draw.

`Prefetcher`: worker threads produce minibatches into a bounded queue
while the device runs the step; each worker has its own producer (own
generator and rng). It records how long each batch took to produce and
how often the consumer found the queue empty, which says whether the
host feed sets the pace of training. A worker's exception is raised to
the consumer.

`compact_feed`: the uint8 image and label that `engine/train.decompress_feed`
undoes on the device, with depth dropped. `make_sharded_device_put`: a
data-parallel rank's share of a global batch on its device.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class RatioSampler:
    """Interleave multiple index streams with integer ratios
    (ref: GtSynthesizeLayer._get_next_minibatch ratio logic,
    layer.py:76-113: e.g. 1 synthetic batch per real batch)."""

    def __init__(self, streams: Sequence[str], ratios: Sequence[int]):
        assert len(streams) == len(ratios) and len(streams) > 0
        self.schedule = []
        for s, r in zip(streams, ratios):
            self.schedule.extend([s] * max(int(r), 0))
        if not self.schedule:
            self.schedule = [streams[0]]
        self._i = 0

    def next_stream(self) -> str:
        s = self.schedule[self._i % len(self.schedule)]
        self._i += 1
        return s


class ShuffledIndexer:
    """Epoch-shuffled index stream (ref: imdb roidb shuffling in
    layer.py:60-74), sharded across hosts."""

    def __init__(self, num_items: int, seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        self.num_items = num_items
        self.rng = np.random.RandomState(seed + process_index)
        self.process_index = process_index
        self.process_count = process_count
        self._perm = np.empty(0, np.int64)
        self._cur = 0

    def next_batch(self, batch_size: int) -> np.ndarray:
        out = []
        while len(out) < batch_size:
            if self._cur >= len(self._perm):
                perm = self.rng.permutation(self.num_items)
                # per-host shard of the shuffled epoch
                self._perm = perm[self.process_index :: self.process_count]
                self._cur = 0
            out.append(self._perm[self._cur])
            self._cur += 1
        return np.asarray(out)


class Prefetcher:
    """Threaded minibatch prefetcher with a bounded queue."""

    def __init__(self, make_batch_factory: Callable[[int], Callable[[], dict]],
                 queue_size: int = 8, num_workers: int = 2,
                 device_put: Optional[Callable[[dict], dict]] = None):
        """`make_batch_factory(worker_id)` gives each worker its own
        producer (numpy RandomStates are not thread-safe)."""
        self.device_put = device_put
        self.q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None  # the first worker failure
        self.produce_seconds: list[float] = []  # host time of each batch produced
        self.gets = 0  # batches handed out
        self.dry = 0  # of which the queue was empty when asked
        self.workers = [
            threading.Thread(target=self._worker, args=(make_batch_factory(i),), daemon=True)
            for i in range(num_workers)
        ]
        for w in self.workers:
            w.start()

    def _worker(self, make_batch):
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                batch = make_batch()
                self.produce_seconds.append(time.perf_counter() - t0)
                while not self._stop.is_set():
                    try:
                        self.q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as err:  # handed to the consumer by __next__
            if self.error is None:
                self.error = err
            self._stop.set()

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        self.gets += 1
        self.dry += self.q.empty()
        while True:
            if self.error is not None:
                raise RuntimeError("a prefetch worker failed") from self.error
            try:
                batch = self.q.get(timeout=0.5)
                break
            except queue.Empty:
                if not any(w.is_alive() for w in self.workers):
                    raise RuntimeError("the prefetch workers have stopped") from self.error
        if self.device_put is not None:
            batch = self.device_put(batch)
        return batch

    def close(self, timeout: float = 30.0):
        """Stop the workers and wait for them (each finishes the batch it
        is producing)."""
        self._stop.set()
        for w in self.workers:
            w.join(timeout)


def compact_feed(batch: dict, pixel_means) -> dict:
    """uint8 image (the mean re-added, so [0, 255]) and uint8 label
    (fewer than 256 classes), and depth left out; the step converts back
    on the device. Value-preserving to ±0.5/255 of intensity."""
    out = {}
    pm = np.asarray(pixel_means, np.float32)
    for k, v in batch.items():
        if k == "depth":
            continue
        if k == "data":
            out[k] = np.clip(v + pm, 0.0, 255.0).astype(np.uint8)
        elif k == "label":
            out[k] = v.astype(np.uint8)
        else:
            out[k] = v
    return out


def to_device(batch: dict, device) -> dict:
    """A host batch of numpy arrays as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def make_sharded_device_put(mesh=None, replicated_keys=("gt_poses", "gt_valid"), *,
                            device="cuda") -> Callable[[dict], dict]:
    """The device_put hook of a data-parallel rank (`posecnn_tpu/data/
    pipeline.py:162-185`): `to_device` without a mesh; with one, this
    rank's share of a GLOBAL host batch of B images: rows [d·B/N,
    (d+1)·B/N) of every key with a leading batch axis, for data rank d of
    N. The GT rows (`replicated_keys`, replicated in JAX) are not handed
    over whole: the port's Hough clamps their image index (column 0) to
    the local batch, so the rank keeps the rows whose image falls in its
    range, in their order, renumbered from 0, and pads back to the global
    G rows with `gt_valid` False, so shapes stay those of the global
    batch. Every feed of the repository emits GT rows image by image,
    which keeps the ranks' rows in the global order."""
    if mesh is None:
        return lambda batch: to_device(batch, device)
    gt_key, valid_key = replicated_keys

    def put(batch: dict) -> dict:
        b, n = batch["data"].shape[0], mesh.data_size
        if b % n:
            raise ValueError(f"global batch {b} not divisible by the data axis {n}")
        lo, hi = mesh.data_index * b // n, (mesh.data_index + 1) * b // n
        out = {k: v[lo:hi] if v.shape[:1] == (b,) else v for k, v in batch.items()
               if k not in replicated_keys}
        gt = np.asarray(batch[gt_key], np.float32)
        valid = np.asarray(batch.get(valid_key, np.ones(gt.shape[0], bool)))
        mine = (gt[:, 0] >= lo) & (gt[:, 0] < hi)
        local = np.zeros_like(gt)
        local[: mine.sum()] = gt[mine]
        local[: mine.sum(), 0] -= lo
        local_valid = np.zeros_like(valid)
        local_valid[: mine.sum()] = valid[mine]
        out[gt_key], out[valid_key] = local, local_valid
        return to_device(out, device)

    return put
