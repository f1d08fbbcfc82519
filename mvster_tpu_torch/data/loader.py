"""Host-side input pipeline (the port's copy of mvster_tpu.data.loader).

A sharded, thread-prefetched iterator over numpy batch dicts, in place of
torch's DataLoader + DistributedSampler: shuffling is seeded by (seed,
epoch), every shard sees the same number of samples, and samples may be
decoded in worker processes.  The train step moves each batch to the device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def _stack_tree(samples):
    """Stack a list of sample dicts (nested dict of arrays) along axis 0."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack_tree([s[k] for s in samples]) for k in first}
    if isinstance(first, str):
        return [s for s in samples]
    return np.stack([np.asarray(s) for s in samples])


class MVSLoader:
    """Iterable over batched samples with optional shuffling and prefetch.

    Args:
      dataset: object with __len__/__getitem__ returning sample dicts.
      batch_size: per-process batch size.
      shuffle: reshuffle indices each epoch (epoch-seeded, deterministic).
      drop_last: drop the trailing partial batch (training keeps one
        batch shape).
      num_shards / shard_index: dataset-level sharding for data-parallel
        processes (the DistributedSampler replacement).
      prefetch: number of batches prepared ahead by the worker thread.
      seed: base shuffling seed.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 num_shards=1, shard_index=0, prefetch=2, seed=0,
                 num_workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.seed = seed
        self.num_workers = num_workers  # >0: decode samples in worker processes
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        # Datasets derive per-sample augmentation RNG from (seed, epoch, idx)
        # (data/common.sample_rng), so the epoch must reach them before the
        # dataset is pickled into pool workers.
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        # pad so every shard sees the same number of samples (sampler contract)
        if self.num_shards > 1:
            per_shard = -(-n // self.num_shards)
            padded = np.concatenate([order, order[: per_shard * self.num_shards - n]])
            order = padded[self.shard_index :: self.num_shards]
        return order

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        idx = self._indices()
        limit = (
            len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
        )
        if self.num_workers > 0:
            # Process-pool decode (PIL/cv2 release little GIL; training hosts
            # have many cores).  The dataset object is pickled to the workers
            # once per epoch; augmentation RNG is derived per sample from
            # (seed, epoch, idx) inside __getitem__, so worker decode is
            # bit-identical to in-process decode and never repeats across
            # epochs or workers.
            import concurrent.futures as cf

            with cf.ProcessPoolExecutor(self.num_workers) as pool:
                for start in range(0, limit, self.batch_size):
                    chunk = idx[start : start + self.batch_size]
                    samples = list(
                        pool.map(self.dataset.__getitem__, [int(i) for i in chunk])
                    )
                    yield _stack_tree(samples)
            return
        for start in range(0, limit, self.batch_size):
            chunk = idx[start : start + self.batch_size]
            yield _stack_tree([self.dataset[int(i)] for i in chunk])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as exc:  # surfaced on the consumer side
                error.append(exc)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if error:
            raise error[0]
