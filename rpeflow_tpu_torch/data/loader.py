"""Prefetching batch loader.

Replaces torch DataLoader + DistributedSampler (reference train.py:81-102):
items are prepared on background threads and collated into fixed-shape,
channels-last numpy batches. Optional (shard_index, num_shards) slicing
covers the multi-process case where each process loads only its slice of the
global batch.

The port's copy of ``rpeflow_tpu/data/loader.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from .dataset import Dataset

# Registry of datasets for forked pool workers, keyed by a per-loader token.
# Populated by DataLoader before its pool forks; workers inherit the whole
# registry copy-on-write and look their dataset up by token, so (a) datasets
# never need to be picklable (DSEC holds HDF5 handles) and (b) two pooled
# loaders iterated concurrently/interleaved each resolve their own dataset
# instead of whichever was registered last. Fallback path only — see
# ``_spec_for``: datasets reconstructible from their cfgs use a SPAWN pool
# instead, which sidesteps the fork-after-threads hazard entirely (forking
# a parent whose runtime threads may hold allocator/HDF5 locks).
_WORKER_DATASETS: Dict[int, Dataset] = {}
_NEXT_TOKEN = 0
_TOKEN_LOCK = threading.Lock()

# Spawn-mode pool worker's private dataset (each worker process builds its
# own instance — own HDF5 handles, no shared state with the parent).
_WORKER_DATASET: Optional[Dataset] = None


def _worker_get(args):
    token, seed, idx = args
    if seed is not None:
        # per-(epoch, item) seed: augmentation draws become reproducible and
        # independent of worker scheduling (the reference's DataLoader worker
        # RNG was scheduling-dependent; datasets that seed the global RNG
        # themselves — aug disabled — overwrite this and stay bit-identical
        # with the single-producer path)
        np.random.seed(seed % (2 ** 31))
    return _WORKER_DATASETS[token][int(idx)]


def _spec_for(dataset):
    """Reconstruction spec for spawn-pool workers, or None if the dataset
    cannot be rebuilt from picklable state (falls back to the fork pool)."""
    from .dataset import ConcatDataset

    if isinstance(dataset, ConcatDataset):
        subs = [_spec_for(d) for d in dataset.datasets]
        return None if any(s is None for s in subs) else ("concat", subs)
    cfgs = getattr(dataset, "cfgs", None)
    if cfgs is None:
        return None
    return ("single", type(dataset).__module__, type(dataset).__qualname__,
            cfgs)


def _build_from_spec(spec) -> Dataset:
    if spec[0] == "concat":
        from .dataset import ConcatDataset

        return ConcatDataset([_build_from_spec(s) for s in spec[1]])
    _, mod, qual, cfgs = spec
    import importlib

    return getattr(importlib.import_module(mod), qual)(cfgs)


def _spawn_worker_init(spec):
    global _WORKER_DATASET
    _WORKER_DATASET = _build_from_spec(spec)


def _spawn_worker_get(args):
    seed, resample_seed, idx = args
    if _WORKER_DATASET.resample_seed != resample_seed:
        _WORKER_DATASET.set_resample_seed(resample_seed)
    if seed is not None:
        np.random.seed(seed % (2 ** 31))
    return _WORKER_DATASET[int(idx)]


def default_use_process_pool(dataset) -> bool:
    """Policy default when the config does not say: pool only for datasets
    whose per-item CPU work dominates — raw DSEC's disparity->point-cloud
    lifting + event slicing (SURVEY.md hard-part 4; the reference leans on
    torch DataLoader worker processes for exactly this, dsec.py).
    Preprocessed-HDF5 readers measured FASTER on the threaded producer
    (item pickling + pool overhead outweigh their light decode)."""
    from .dataset import ConcatDataset
    from .dsec import DSECTrain

    if isinstance(dataset, ConcatDataset):
        return any(default_use_process_pool(d) for d in dataset.datasets)
    return isinstance(dataset, DSECTrain)


def collate(items) -> Dict[str, np.ndarray]:
    out = {}
    for key in items[0]:
        vals = [np.asarray(item[key]) for item in items]
        out[key] = np.stack(vals, axis=0)
    return out


class DataLoader:
    """Map-style loader with shuffling, sharding and threaded prefetch.

    Batches are produced in-order by a single background thread (datasets
    seed the *global* numpy RNG per item, reference flyingthings3d.py:52-53,
    so a single producer also keeps that reproducible); ``num_workers`` is
    accepted for config compatibility and bounds nothing beyond the prefetch
    depth. On multi-core hosts a process pool could slot in here.
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 2,
        prefetch: int = 2,
        shard_index: int = 0,
        num_shards: int = 1,
        use_process_pool: Optional[bool] = None,
    ):
        assert batch_size % num_shards == 0
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // num_shards
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        if use_process_pool is None:
            use_process_pool = default_use_process_pool(dataset)
        self.use_process_pool = bool(use_process_pool) and self.num_workers > 1
        self.epoch = 0
        self._pool = None
        self._pool_is_spawn = False

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling per epoch (DistributedSampler.set_epoch analog)."""
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> Iterator[np.ndarray]:
        order = self._order()
        n_batches = len(self)
        for b in range(n_batches):
            global_idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            # contiguous per-shard slice of the global batch
            lo = self.shard_index * self.local_batch
            yield global_idx[lo:lo + self.local_batch]

    def __iter__(self):
        if self.use_process_pool:
            yield from self._iter_pool()
            return
        done_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batches = list(self._batches())
        stop = threading.Event()
        _END = object()

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    done_q.put(collate([self.dataset[int(i)] for i in idxs]))
                done_q.put(_END)
            except Exception as e:  # surface in the consuming thread
                done_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = done_q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def _ensure_pool(self):
        """Create (once) and reuse the worker pool across epochs.

        Preferred mode is a SPAWN pool whose workers rebuild the dataset
        from its config (``_spec_for``): no fork of the parent
        (whose runtime threads may hold allocator locks — the
        fork-after-threads DeprecationWarning the old per-epoch fork pool
        tripped), each worker owns its HDF5 handles, and the one-time
        interpreter+import startup cost is amortized over the loader's
        lifetime instead of paid per epoch. Datasets that cannot be rebuilt
        from picklable state fall back to the fork pool (copy-on-write
        inheritance), created once as early as possible.
        """
        if self._pool is not None:
            return self._pool
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        spec = _spec_for(self.dataset)
        if spec is not None:
            try:
                self._pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=mp.get_context("spawn"),
                    initializer=_spawn_worker_init, initargs=(spec,))
                self._pool_is_spawn = True
                return self._pool
            except Exception:
                self._pool = None  # unpicklable cfgs etc. — fall back
        global _NEXT_TOKEN
        with _TOKEN_LOCK:
            self._token = _NEXT_TOKEN
            _NEXT_TOKEN += 1
        _WORKER_DATASETS[self._token] = self.dataset
        self._pool = ProcessPoolExecutor(max_workers=self.num_workers,
                                         mp_context=mp.get_context("fork"))
        self._pool_is_spawn = False
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            if not self._pool_is_spawn:
                _WORKER_DATASETS.pop(getattr(self, "_token", None), None)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _iter_pool(self):
        """Process-pool item pipeline for CPU-heavy datasets (DSEC's per-item
        disparity->point-cloud lifting and event slicing; reference dsec.py
        relies on torch DataLoader worker processes for the same reason).

        Items are submitted with a bounded in-flight window and collated in
        order. Default-on for raw DSEC (``default_use_process_pool``),
        opt-in elsewhere: pickling items back costs ~seconds per epoch —
        measured SLOWER than the threaded producer for light
        preprocessed-HDF5 datasets, only worthwhile when per-item CPU work
        dominates.

        RNG note: pool workers reseed numpy per (epoch, item), so
        augmentation draws differ from the threaded path's sequential global
        RNG stream (both are valid augmentation distributions; eval datasets
        seed per-item themselves and are bit-identical on either path).
        """
        pool = self._ensure_pool()
        batches = list(self._batches())
        epoch_base = (self.seed * 1_000_003 + self.epoch * 97_003) & 0x7FFFFFFF
        resample = getattr(self.dataset, "resample_seed", 0)
        if self._pool_is_spawn:
            flat = [(epoch_base + int(i), resample, int(i))
                    for idxs in batches for i in idxs]
            get = _spawn_worker_get
        else:
            flat = [(self._token, epoch_base + int(i), int(i))
                    for idxs in batches for i in idxs]
            get = _worker_get
        window = max(self.prefetch, 2) * self.local_batch * 2
        futures: "queue.Queue" = queue.Queue()
        submitted = 0
        for args in flat[:window]:
            futures.put(pool.submit(get, args))
            submitted += 1
        items = []
        for idxs in batches:
            while len(items) < len(idxs):
                items.append(futures.get().result())
                if submitted < len(flat):
                    futures.put(pool.submit(get, flat[submitted]))
                    submitted += 1
            yield collate(items)
            items = []
