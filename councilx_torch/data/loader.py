"""Host batch loader: threaded decode into a bounded prefetch queue.

Counterpart of ``councilx/data/loader.py`` (reference utils.py::
{get_all_data_loaders, get_data_loader_folder}), numpy only, and batch for
batch the same: the same deterministic index stream (``np.random.
RandomState(seed)`` permutations), the same resume fast-forward
(``start_batch``), the same sharding of each global batch, the same native
C++ decode (``data/native``) with the PIL thread pool where it cannot be
built. Batches are stacked uint8 numpy arrays (B, new_size, new_size, 3);
the random crops and flips run on the device (``data/ondevice.py``).
"""

from __future__ import annotations

import os
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from councilx_torch.config import Config
from councilx_torch.data.dataset import (ImageFilelistDataset,
                                         ImageFolderDataset,
                                         SyntheticImageDataset)


class DataLoader:
    """Infinite (train) or single-epoch (eval) iterator of uint8 batches.

    ``start_batch > 0`` resumes: the index stream is deterministic, so a
    resumed run skips the batches the checkpointed run consumed (index
    arithmetic only; a whole epoch costs one permutation draw, no decode)
    and goes on exactly where it stopped. ``shard_count > 1``: every shard
    draws the same shuffled stream and takes its own ``batch_size`` rows of
    each global batch of ``batch_size * shard_count``.

    ``native`` is True where batches decode with the C++ loader, False
    where the PIL thread pool decodes them."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 infinite: bool = True, seed: int = 0, prefetch: int = 4,
                 shard_index: int = 0, shard_count: int = 1,
                 start_batch: int = 0):
        if not (0 <= shard_index < shard_count):
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"shard_count {shard_count}")
        if shard_count > 1 and not drop_last:
            raise ValueError("sharded loading requires drop_last=True "
                             "(a ragged final global batch would leave some "
                             "shards short)")
        if len(dataset) < batch_size * shard_count and drop_last:
            raise ValueError(
                f"dataset of {len(dataset)} images smaller than the global "
                f"batch {batch_size} x {shard_count} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.infinite = infinite
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.start_batch = int(start_batch)
        # the C++ decode: for a plain image folder at new_size with no
        # other crop; PIL otherwise, or where it cannot be built
        self._native = None
        if (isinstance(dataset, ImageFolderDataset)
                and dataset.crop in (None, dataset.new_size)
                and not dataset.return_paths):
            from councilx_torch.data.native import (NativeImageLoader,
                                                    load_native)
            if load_native() is not None:
                self._native = NativeImageLoader(
                    dataset.paths, dataset.new_size, threads=self.num_workers)

    @property
    def native(self) -> bool:
        return self._native is not None

    def __len__(self) -> int:
        gbs = self.batch_size * self.shard_count
        n = len(self.dataset) // gbs
        if not self.drop_last and len(self.dataset) % gbs:
            n += 1
        return n

    def _index_stream(self, start: Optional[int] = None
                      ) -> Iterator[np.ndarray]:
        rng = np.random.RandomState(self.seed)
        gbs = self.batch_size * self.shard_count
        off = self.shard_index * self.batch_size
        skip = self.start_batch if start is None else int(start)
        while True:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                idx = rng.permutation(idx)
            lim = (len(idx) // gbs * gbs if self.drop_last else len(idx))
            per_epoch = -(-lim // gbs) if lim else 0
            if skip >= per_epoch and self.infinite and per_epoch:
                skip -= per_epoch  # skip the whole epoch; keep rng in sync
                continue
            for s in range(0, lim, gbs):
                if skip:
                    skip -= 1
                    continue
                yield idx[s + off:s + off + self.batch_size]
            if not self.infinite:
                return

    def head_rows(self, n: int) -> np.ndarray:
        """The first ``n`` rows of the epoch-0 stream (whatever
        ``start_batch`` is), decoded here, with no producer thread: display
        batches and eval inputs, the same before and after a resume. At
        most one epoch of this shard's rows."""
        n = min(n, len(self) * self.batch_size or len(self.dataset))
        rows = []
        stream = self._index_stream(start=0)
        for _ in range(max(len(self), 1)):
            for i in next(stream).tolist():
                rows.append(self.dataset[i])
                if len(rows) == n:
                    return np.stack(rows)
        return np.stack(rows)

    def _load(self, pool: ThreadPoolExecutor,
              batch_idx: np.ndarray) -> np.ndarray:
        if self._native is not None:
            try:
                return self._native.load_batch(batch_idx)
            except IOError:
                pass            # a file the C++ decode refused: PIL
        return np.stack(list(pool.map(self.dataset.__getitem__,
                                      batch_idx.tolist())))

    def __iter__(self) -> Iterator[np.ndarray]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # never block forever on a full queue: a consumer that goes
            # away sets stop, and the producer must then exit
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # a failure reaches the consumer as an exception, never as a
            # dead producer and a consumer blocked on q.get()
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch_idx in self._index_stream():
                        if stop.is_set():
                            return
                        if not put_or_stop(self._load(pool, batch_idx)):
                            return
                put_or_stop(None)
            except Exception as e:      # noqa: BLE001 -- re-raised below
                put_or_stop(e)

        t = threading.Thread(target=produce, daemon=True,
                             name="councilx_torch-loader")
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def get_all_data_loaders(cfg: Config, synthetic: bool = False,
                         synthetic_size: int = 64,
                         batch_size: Optional[int] = None,
                         shard_index: int = 0, shard_count: int = 1,
                         start_batch: int = 0):
    """-> (train_a, train_b, test_a, test_b) loaders (reference utils.py::
    get_all_data_loaders).

    Sources: ``cfg.data.data_root`` with trainA/ trainB/ testA/ testB/, or
    the file lists of ``cfg.extras`` (``data_list_train_a`` ...), or with
    ``synthetic`` deterministic synthetic images. Each split shuffles with
    its own seed, crc32 of its name (independent of PYTHONHASHSEED), so A
    and B rows are never paired for good. ``batch_size``/``shard_index``/
    ``shard_count`` shard the train splits; the test splits are never
    sharded, keep a ragged last batch and ignore ``start_batch``."""
    d = cfg.data
    bs = batch_size or cfg.batch_size

    def make(split: str, train: bool):
        seed = zlib.crc32(split.encode()) % (2 ** 31)
        if synthetic:
            ds = SyntheticImageDataset(synthetic_size, d.new_size, seed=seed)
        else:
            list_key = {"trainA": "data_list_train_a",
                        "trainB": "data_list_train_b",
                        "testA": "data_list_test_a",
                        "testB": "data_list_test_b"}[split]
            flist = cfg.extras.get(list_key)
            if flist:
                ds = ImageFilelistDataset(d.data_root, flist,
                                          new_size=d.new_size)
            else:
                ds = ImageFolderDataset(os.path.join(d.data_root, split),
                                        new_size=d.new_size)
        return DataLoader(ds, bs, shuffle=train, num_workers=d.num_workers,
                          infinite=train, seed=seed, drop_last=train,
                          shard_index=shard_index if train else 0,
                          shard_count=shard_count if train else 1,
                          start_batch=start_batch if train else 0)

    return (make("trainA", True), make("trainB", True),
            make("testA", False), make("testB", False))
