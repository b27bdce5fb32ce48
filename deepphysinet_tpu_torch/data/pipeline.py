"""Host input pipeline: threaded prefetch and batch collation.

Counterpart of ``deepphysinet_tpu/data/pipeline.py``, which replaces the reference's torch
DataLoader with worker processes (interface_physics.py:419-424): items are assembled by a thread
pool (the work is numpy and file I/O, which release the interpreter lock), collated to numpy
batches with a leading batch axis, and handed to the training loop in the order of a seeded
shuffle, so that both packages draw the same windows in the same order.  The trainer moves each
batch to the device (``train/train_step.py::batch_to_device``) while the workers assemble the next.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


class PrefetchLoader:
    """Yields dict batches with a leading batch axis, prefetched in background."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 2,
        prefetch: int = 2,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        """``shard_id``/``num_shards``: DistributedSampler semantics (reference
        interface_physics.py:936).  Every process shuffles the GLOBAL index space with the same
        seed, then process p iterates the strided slice ``order[p::num_shards]``, so the union of
        all processes' k-th local batches is the k-th global batch a single process would draw."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        self.shard_id = shard_id
        self.num_shards = num_shards

    def __len__(self) -> int:
        # with sharding, every process sees exactly n // num_shards items (the order is truncated
        # to a multiple of num_shards before striding): equal lengths keep the processes in step
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            if isinstance(vals[0], str):
                out[key] = vals  # filenames pass through as a list
            elif len(vals) == 1:
                # batch-1 fast path: prepend the axis as a view, no copy
                out[key] = np.asarray(vals[0])[None]
            else:
                out[key] = np.stack(vals, axis=0)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.num_shards > 1:
            order = order[: len(order) // self.num_shards * self.num_shards]
            order = order[self.shard_id :: self.num_shards]
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0), self.batch_size)
        ]
        if not batches:
            return
        # num_workers threads assemble batches concurrently; results are re-ordered so that
        # iteration follows the shuffled schedule deterministically
        task_q: "queue.Queue" = queue.Queue()
        for seq, idxs in enumerate(batches):
            task_q.put((seq, idxs))
        done: Dict[int, object] = {}
        done_cv = threading.Condition(threading.Lock())
        stop = threading.Event()
        n_batches = len(batches)

        def worker():
            while not stop.is_set():
                try:
                    seq, idxs = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    items = [self.dataset[int(i)] for i in idxs]
                    result: object = self._collate(items)
                except Exception as e:  # surface worker errors to the consumer
                    result = e
                with done_cv:
                    done[seq] = result
                    done_cv.notify_all()
                # bounded prefetch: wait until the consumer catches up
                while not stop.is_set():
                    with done_cv:
                        if len(done) <= self.prefetch + self.num_workers:
                            break
                        done_cv.wait(timeout=0.1)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, n_batches))]
        for t in threads:
            t.start()
        try:
            for seq in range(n_batches):
                with done_cv:
                    while seq not in done:
                        done_cv.wait(timeout=0.5)
                        if seq not in done and not any(t.is_alive() for t in threads):
                            raise RuntimeError("prefetch workers died without output")
                    item = done.pop(seq)
                    done_cv.notify_all()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
