"""Step-indexed, prefetching data pipeline on one device.

The reference's ``data/pipeline.py``: every batch is a pure function of
(seed, step), so a run resumed at step k replays the exact stream, and
``Prefetcher`` overlaps host-side batch synthesis with device compute
through a background thread and a bounded queue. The reference's
``shard_batch`` places a host batch on a mesh under a sharding tree; one
card has no sharding, and its counterpart ``to_device`` copies the batch
to the device from pinned host memory without blocking the host.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


class StepIndexedSource:
    """Deterministic (seed, step) -> global batch function."""

    def __init__(self, make_batch: Callable[[int], Any], seed: int = 0):
        self._make = make_batch
        self.seed = seed

    def batch_at(self, step: int) -> Any:
        return self._make(step)

    def iterate(self, start_step: int = 0) -> Iterator[Any]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


_SENTINEL = object()


class Prefetcher:
    """Background-thread prefetch with a bounded queue (depth 2 by
    default). An error in the iterator is raised by the ``next`` that
    reaches it; ``close`` stops the thread and drops what it queued."""

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 device_put: Optional[Callable[[Any], Any]] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._put = device_put or (lambda x: x)

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(self._put(item))
            except Exception as e:  # raised by the consumer's next()
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()


def to_device(batch: dict, device: str | torch.device = "cuda"
              ) -> dict[str, torch.Tensor]:
    """A host batch (numpy arrays) as tensors on ``device``. To a CUDA
    device each array is copied from pinned host memory with
    ``non_blocking=True``: the host does not wait for the card (a pageable
    copy would wait for the stream)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out
