"""Dataset composition and a prefetching batch loader (port of
v2v_tpu/data/interface.py).

File-of-paths -> concat of per-file datasets; list-of-configs -> concat
of concats (reference data/data_interface.py:6-21). The loader keeps the
dataset's order unless asked to shuffle (test sets never are; the train
driver shuffles with a per-epoch seed), collates numpy batches, and
builds them on worker threads or processes.
"""
from __future__ import annotations

import bisect
import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from ..config import resolve_target


class ConcatDataset:
    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self) -> int:
        return self.cum[-1] if self.cum else 0

    def __getitem__(self, idx: int):
        ds_idx = bisect.bisect_right(self.cum, idx)
        prev = self.cum[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]

    def set_epoch(self, seed) -> None:
        """Pass a per-epoch seed on to the members that draw, each member
        with its position appended, so no two members share a stream."""
        for k, d in enumerate(self.datasets):
            if hasattr(d, "set_epoch"):
                d.set_epoch(tuple(np.atleast_1d(seed)) + (k,))


def read_path_list(data_file: str) -> List[str]:
    with open(data_file) as f:
        return [line.strip() for line in f if line.strip()]


def make_concat_dataset(configs: Dict[str, Any]) -> ConcatDataset:
    """One config block -> ConcatDataset over its data_file paths."""
    data_paths = read_path_list(configs["data_file"])
    begin = configs.get("begin_seq", 0)
    end = configs.get("end_seq", len(data_paths))
    cls = resolve_target(configs["class_name"])
    return ConcatDataset([cls(p, configs) for p in data_paths[begin:end]])


def make_concat_multi_dataset(configs: List[Dict[str, Any]]) -> ConcatDataset:
    return ConcatDataset([make_concat_dataset(c) for c in configs])


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy/scalar fields into a leading batch dim; keep
    strings/lists as python lists."""
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


class DataLoader:
    """Batches of `dataset`, built by `num_workers` workers with at most
    `prefetch` batches waiting, in the order of `_indices`.

    `shuffle` permutes the indices with `RandomState(seed + epoch)`
    (`set_epoch`), as the JAX package's loader does, and `process_index`
    / `process_count` take every process_count-th of them (the
    DistributedSampler's split). A dataset with `set_epoch` receives
    `seed + epoch` before each pass, for the items' own draws.

    worker_type:
      * "thread": shared memory, safe for datasets that hold open file
        handles (h5). cv2 releases the GIL while it decodes; the numpy
        crop and collate work serializes.
      * "process": spawned worker processes, for decode-heavy video. The
        dataset is pickled to each worker at the start of a pass.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 4,
                 worker_type: str = "thread"):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type {worker_type!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.worker_type = worker_type
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.seed + self.epoch)
        indices = self._indices()
        batches = [[int(i) for i in
                    indices[k * self.batch_size:(k + 1) * self.batch_size]]
                   for k in range(len(self))]
        if self.num_workers <= 1:
            for idx in batches:
                yield collate([self.dataset[i] for i in idx])
            return
        if self.worker_type == "process":
            yield from self._process_iter(batches)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        task_q: "queue.Queue" = queue.Queue()
        for pos, idx in enumerate(batches):
            task_q.put((pos, idx))
        stop = threading.Event()     # the consumer left the loop

        def worker():
            while not stop.is_set():
                try:
                    pos, idx = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = collate([self.dataset[i] for i in idx])
                except Exception as e:       # raised in the consumer
                    batch = e
                # a bounded put that re-checks the stop flag, so a
                # consumer that breaks early leaks no blocked thread
                while not stop.is_set():
                    try:
                        out_q.put((pos, batch), timeout=0.2)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        results: Dict[int, Any] = {}
        try:
            next_pos = 0
            for _ in range(len(batches)):
                pos, batch = out_q.get()
                results[pos] = batch
                while next_pos in results:
                    b = results.pop(next_pos)
                    next_pos += 1
                    if isinstance(b, Exception):
                        raise b
                    yield b
        finally:
            stop.set()
            while True:              # wake blocked putters
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            for t in threads:
                t.join(timeout=5)

    def _process_iter(self, batches: List[List[int]]
                      ) -> Iterator[Dict[str, Any]]:
        """Spawned workers collate whole batches and send them back
        through a queue; the consumer restores the batch order, so a pass
        yields what the thread and serial paths yield."""
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        nw = min(self.num_workers, len(batches))
        task_q = ctx.Queue()
        out_q = ctx.Queue(maxsize=max(2, self.prefetch))
        for pos, idx in enumerate(batches):
            task_q.put((pos, idx))
        for _ in range(nw):
            task_q.put(None)
        procs = [ctx.Process(target=_process_worker,
                             args=(self.dataset, task_q, out_q), daemon=True)
                 for _ in range(nw)]
        for p in procs:
            p.start()
        try:
            results: Dict[int, Any] = {}
            next_pos = 0
            for _ in range(len(batches)):
                pos, batch, err = out_q.get()
                if err is not None:
                    raise RuntimeError(f"loader worker failed: {err}")
                results[pos] = batch
                while next_pos in results:
                    yield results.pop(next_pos)
                    next_pos += 1
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)


def _process_worker(dataset, task_q, out_q) -> None:
    """A spawned loader worker: collate the batches of `task_q` until its
    None, each into `out_q` as (pos, batch, None) or (pos, None,
    traceback)."""
    try:
        import cv2
        cv2.setNumThreads(1)        # one decode thread a process
    except ImportError:
        pass
    while True:
        item = task_q.get()
        if item is None:
            return
        pos, idx = item
        try:
            out_q.put((pos, collate([dataset[i] for i in idx]), None))
        except Exception as e:
            import traceback
            out_q.put((pos, None, f"{e!r}\n{traceback.format_exc()}"))
