"""Dataset composition and a thread-prefetching loader (port of
v2v_tpu/data/interface.py for the test path).

File-of-paths -> concat of per-file datasets; list-of-configs -> concat
of concats (reference data/data_interface.py:6-21). The loader keeps
the dataset's order (test sets are never shuffled), collates numpy
batches, and builds them on worker threads, which is safe for datasets
that open h5 files per item.
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
    """In-order batches of `dataset`, built by `num_workers` threads with
    at most `prefetch` batches waiting."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = False,
                 num_workers: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        batches = [range(i * self.batch_size,
                         min(n, (i + 1) * self.batch_size))
                   for i in range(len(self))]
        if self.num_workers <= 1:
            for idx in batches:
                yield collate([self.dataset[i] for i in idx])
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
