"""Host-side batching data loader, the counterpart of
``deft_tpu/data/loader.py``.

``DataLoader(dataset, batch_size, ..., seed)`` draws the epoch's order from
its own ``np.random.RandomState(seed)`` (``:108-118``), cuts it into batches
(the last short one dropped under ``drop_last``) and stacks each batch's
samples into numpy arrays (``collate``).

* ``num_workers <= 1``: the samples are built in this process, one after
  the other, so the batch sequence is a function of the seeds alone (the
  JAX loader clamps 0 to 1 and does the same);
* ``num_workers > 1``: a pool of worker processes started from a
  ``forkserver`` that has imported only this module, each building whole
  batches, at most ``2 * num_workers`` batches ahead of the consumer; the
  dataset reaches each worker once, by pickle (its frame cache stays
  behind), and each worker seeds ``np.random``, ``random`` and the
  dataset's colour-augmentation generator from its process id, as the JAX
  loader does.  ``close()`` stops the pool.

Under data-parallel training (``rank``, ``world``; ``deft_tpu_torch.
distributed``) every rank draws the same epoch order from the same seed and
keeps rows ``rank::world`` of each global batch of ``batch_size``, so the
ranks' batches together are the one-process batch at every step.  A global
batch that ``world`` does not divide raises a ``ValueError``, as the JAX
mesh's ``shard_batch`` does.  In process (``num_workers <= 1``) every rank
builds the whole global batch and keeps its rows, so each sample's random
draws are the one-process run's; the workers (``num_workers > 1``, seeded
per process anyway) build only the rank's rows.

Nothing here imports cv2 (the card's machine has none).
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterator, List

import numpy as np

_WORKER_DATASET = None


def _worker_init(dataset):
    import random

    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    # decorrelate augmentation streams across workers
    seed = (os.getpid() * 2654435761) % (2 ** 31)
    np.random.seed(seed)
    random.seed(seed)
    if hasattr(dataset, "_data_rng"):
        dataset._data_rng = np.random.RandomState(seed ^ 0x5EED)


def _worker_load(idxs):
    return collate([_WORKER_DATASET[i] for i in idxs])


def rank_rows(batch: List, rank: int, world: int) -> List:
    """Rank ``rank``'s rows of a global batch: ``batch[rank::world]``."""
    if len(batch) % world:
        raise ValueError(f"a global batch of {len(batch)} does not split "
                         f"over {world} ranks")
    return batch[rank::world]


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 0, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"--batch_size {batch_size} does not split "
                             f"over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self._pool = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i: i + self.batch_size].tolist()
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _process_pool(self):
        """The worker pool, started on first use and kept across epochs."""
        if self._pool is None:
            import multiprocessing as mp

            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload([__name__])
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset,))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        if self.num_workers <= 1:
            for idxs in batches:
                yield collate(rank_rows([self.dataset[i] for i in idxs],
                                        self.rank, self.world))
            return
        pool = self._process_pool()
        todo = (rank_rows(idxs, self.rank, self.world) for idxs in batches)
        pending = deque(pool.apply_async(_worker_load, (idxs,))
                        for _, idxs in zip(range(2 * self.num_workers), todo))
        while pending:
            batch = pending.popleft().get()
            idxs = next(todo, None)
            if idxs is not None:
                pending.append(pool.apply_async(_worker_load, (idxs,)))
            yield batch
