"""Data loader: per-process sharding, threaded decode and the copy to the
card one batch ahead (counterpart of ``procedurevrl_tpu/datasets/loader.py``;
reference ``lib/datasets/loader.py:75-160``, ``lib/datasets/utils.py:358-372``).

- Each process owns ``1 / world size`` of every global batch, sliced from
  an epoch-seeded global permutation (``RandomState(RNG_SEED +
  epoch)``), the sample-to-step assignment of ``DistributedSampler`` with
  ``drop_last``.  The global batch is the config's per-host batch times
  the hosts, and each rank takes its contiguous rows
  (``parallel/ddp.py:batch_plan``, JAX's rule); one process without a
  group holds the whole batch.
- A pool of ``DATA_LOADER.NUM_WORKERS`` threads decodes samples
  concurrently (the decode and the native preprocess release the GIL);
  batches are assembled in order and pass through a bounded queue, so
  decoding overlaps the card's work.  The producer and its workers touch
  numpy only, never CUDA.
- The last partial val or test batch is padded to the full batch and the
  number of valid rows is reported (``n_valid``).
- A consumer that leaves early stops the producer, whose queued samples
  are dropped (those being decoded finish).
- :func:`prefetch_to_device` pins each batch's arrays and copies them to
  the card on a stream of its own, ``size`` batches ahead; the step's
  stream waits on the copy before it reads a batch.

``MULTIGRID.SHORT_CYCLE`` raises: the multigrid schedule is not ported.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch

from procedurevrl_torch.datasets.build import build_dataset
from procedurevrl_torch.parallel import ddp
from procedurevrl_torch.parallel.collectives import get_rank, get_world_size

# host-to-device copies of prefetch_to_device since the last
# reset_copies(): batches, tensors, those that were pinned, bytes
COPIES = {"batches": 0, "tensors": 0, "pinned": 0, "bytes": 0}


def reset_copies() -> None:
    for key in COPIES:
        COPIES[key] = 0


def _collate(samples) -> Tuple[Dict[str, np.ndarray], np.ndarray, Dict]:
    """Stack (frames, label, index, meta) tuples into a batch dict: numeric
    meta becomes batch entries, the rest stays host meta."""
    frames = np.stack([s[0] for s in samples])
    labels0 = [s[1] for s in samples]
    idx = np.asarray([s[2] for s in samples], np.int64)
    batch = {"frames": frames, "index": idx}
    if isinstance(labels0[0], dict):
        batch["verb"] = np.asarray([lab["verb"] for lab in labels0], np.int64)
        batch["noun"] = np.asarray([lab["noun"] for lab in labels0], np.int64)
    else:
        batch["labels"] = np.asarray(labels0, np.int64)
    extra_meta = {}
    for k in samples[0][3]:
        vals = [s[3][k] for s in samples]
        arr = None
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            arr = np.stack([np.asarray(v) for v in vals])
        if arr is not None and np.issubdtype(arr.dtype, np.number):
            batch[k] = arr
        else:
            extra_meta[k] = vals
    return batch, idx, extra_meta


class Loader:
    """Iterable over this process's batches of one split; yields
    ``(batch, n_valid, extra)``."""

    def __init__(self, dataset, global_batch_size: int, shuffle: bool,
                 drop_last: bool, num_workers: int = 8,
                 prefetch_depth: int = 2, num_hosts: int = 1,
                 host_id: int = 0, seed: int = 0, repeated_aug: int = 0):
        if global_batch_size % num_hosts:
            raise ValueError(f"a global batch of {global_batch_size} does "
                             f"not split over {num_hosts} processes")
        self.dataset = dataset
        self.global_batch = global_batch_size
        self.local_batch = global_batch_size // num_hosts
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch_depth = max(prefetch_depth, 1)
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.seed = seed
        self.repeated_aug = repeated_aug
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for ``epoch`` and re-seed the samples' augmentation
        (reference ``loader.py:142-160``)."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return (n + self.global_batch - 1) // self.global_batch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.repeated_aug > 1 and self.shuffle:
            # RASampler (reference lib/datasets/samplers.py:8): each sample
            # `repeated_aug` times an epoch, the epoch's length kept
            order = np.repeat(order, self.repeated_aug)[:n]
        return order

    def __iter__(self) -> Iterator:
        order = self._epoch_indices()
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def _put(item, timeout=0.25) -> bool:
            """A put that keeps checking ``stop``: a consumer that leaves
            the generator early sets it, and the producer must not stay
            blocked on a full queue."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=timeout)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending = []
                for b in range(n_batches):
                    if stop.is_set():
                        break
                    gb = order[b * self.global_batch:
                               (b + 1) * self.global_batch]
                    # this process's contiguous shard of the global batch
                    local = gb[self.host_id * self.local_batch:
                               (self.host_id + 1) * self.local_batch]
                    n_valid = len(local)
                    if n_valid < self.local_batch:  # pad the last batch
                        pad = np.resize(local, self.local_batch - n_valid)
                        local = np.concatenate([local, pad])
                    futs = [pool.submit(self.dataset.__getitem__, int(i))
                            for i in local]
                    pending.append((futs, n_valid))
                    # at most prefetch_depth batches in flight
                    while len(pending) > self.prefetch_depth or (
                            b == n_batches - 1 and pending):
                        futs0, nv0 = pending.pop(0)
                        try:
                            batch, _, extra = _collate(
                                [f.result() for f in futs0])
                        except Exception as e:  # raised in the consumer
                            _put(e)
                            pool.shutdown(wait=False, cancel_futures=True)
                            return
                        if not _put((batch, nv0, extra)):
                            # the consumer is gone: decode no queued sample
                            pool.shutdown(wait=False, cancel_futures=True)
                            return
            _put(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def construct_loader(cfg, split: str) -> Loader:
    """The loader of ``split`` (reference ``loader.py:75-140``): train
    shuffles and drops the last partial batch, val and test keep it,
    padded.  ``TRAIN.BATCH_SIZE`` / ``TEST.BATCH_SIZE`` are per host, split
    over its ``NUM_GPUS`` ranks (F12)."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"split {split!r}: expected train, val or test")
    if split == "train" and cfg.MULTIGRID.SHORT_CYCLE:
        raise NotImplementedError(
            "MULTIGRID.SHORT_CYCLE: the multigrid schedule "
            "(utils/multigrid.py) is not ported yet (ROADMAP.md Queue 1 "
            "item 7)")
    if split == "test":
        dataset_name, batch_size = cfg.TEST.DATASET, cfg.TEST.BATCH_SIZE
    else:
        dataset_name, batch_size = cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE
    shuffle = drop_last = split == "train"
    global_batch, _ = ddp.batch_plan(batch_size, cfg)
    return Loader(
        build_dataset(dataset_name, cfg, split),
        global_batch_size=global_batch, shuffle=shuffle,
        drop_last=drop_last, num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        prefetch_depth=cfg.TPU.PREFETCH_DEPTH, num_hosts=get_world_size(),
        host_id=get_rank(), seed=cfg.RNG_SEED,
        repeated_aug=3 if (split == "train" and cfg.DATA.USE_REPEATED_AUG)
        else 0)


def shuffle_dataset(loader: Loader, cur_epoch: int) -> None:
    """reference ``loader.py:142-160``."""
    loader.set_epoch(cur_epoch)


def prefetch_to_device(loader: Loader, device: Union[str, torch.device],
                       size: int = 2) -> Iterator:
    """Iterate ``loader`` with each batch already on ``device``: yields
    ``(dev_batch, n_valid, extra, host_batch)``, ``dev_batch`` a dict of
    tensors, ``host_batch`` the loader's numpy dict.

    On ``cuda`` every array is copied into pinned memory and from there to
    the card with ``non_blocking=True`` on a stream of this generator's,
    ``size`` batches ahead of the one yielded; before a batch is yielded
    the current stream waits for its copy, and each of its tensors is
    recorded on that stream, so the caching allocator does not hand the
    memory on while a step still reads it.  The copies start from the
    consuming thread.  On the CPU the tensors share the arrays' memory.
    Closing the generator stops the loader's producer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    pending = collections.deque()
    it = iter(loader)

    def to_device(batch):
        if not cuda:
            return {k: torch.from_numpy(v) for k, v in batch.items()}, None
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(stream):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(stream)
        COPIES["batches"] += 1
        for t in pinned.values():
            COPIES["tensors"] += 1
            COPIES["pinned"] += int(t.is_pinned())
            COPIES["bytes"] += t.numel() * t.element_size()
        return dev, (done, pinned)

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch, n_valid, extra = next(it)
            except StopIteration:
                return
            dev, copy = to_device(batch)
            pending.append((dev, n_valid, extra, batch, copy))

    try:
        enqueue(size)
        while pending:
            dev, n_valid, extra, batch, copy = pending.popleft()
            if copy is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(copy[0])
                for t in dev.values():
                    t.record_stream(current)
            enqueue(1)
            yield dev, n_valid, extra, batch
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
