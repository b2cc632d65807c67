"""Host-side input pipeline (counterpart of `posecnn_tpu/data/pipeline.py:25-160`).

`RatioSampler` interleaves the real and synthetic streams at integer
ratios; `ShuffledIndexer` gives each epoch's frames in a seeded shuffled
order, sharded across processes (process 0 of 1 until data parallel).
Both are the original's, draw for draw.

`Prefetcher`: worker threads produce minibatches into a bounded queue
while the device runs the step; each worker has its own producer (own
generator and rng). It records how long each batch took to produce and
how often the consumer found the queue empty, which says whether the
host feed sets the pace of training. A worker's exception is raised to
the consumer.

`compact_feed`: the uint8 image and label that `engine/train.decompress_feed`
undoes on the device, with depth dropped.
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
