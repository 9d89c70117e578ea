"""Serving metrics: request/batch counters behind one lock.

The engine records from its flush thread; ``snapshot()`` is safe from any
thread and powers both ``engine.stats()`` and the HTTP ``/stats`` page.
Latency percentiles come from a bounded window (the most recent
``window`` requests) so a long-lived server reports current behavior, not
its lifetime average; QPS is reported both lifetime and over the same
window.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Optional

import numpy as np


class EngineMetrics:
    def __init__(self, window: int = 8192):
        self._lock = threading.Lock()
        self.t_start = time.perf_counter()
        self.n_requests = 0          # single-query requests through the queue
        self.n_cached = 0            # answered straight from the cache
        self.n_batches = 0           # index.search calls issued by the engine
        self.batch_hist: Counter = Counter()   # actual coalesced sizes
        self.bucket_hist: Counter = Counter()  # padded (compiled) sizes
        self._lat = deque(maxlen=window)       # per-request seconds
        self._done = deque(maxlen=window)      # completion timestamps
        self._evals_sum = 0.0        # distance_evals weighted by requests
        self._evals_n = 0
        self.n_escalated = 0         # rows re-run at the next ladder rung

    def record_batch(self, size: int, bucket: int, latencies_s: list,
                     distance_evals: Optional[float],
                     escalated: int = 0) -> None:
        now = time.perf_counter()
        with self._lock:
            self.n_batches += 1
            self.n_requests += size
            self.batch_hist[size] += 1
            self.bucket_hist[bucket] += 1
            self._lat.extend(latencies_s)
            self._done.extend([now] * size)
            if distance_evals is not None:
                self._evals_sum += distance_evals * size
                self._evals_n += size
            self.n_escalated += escalated

    def record_cached(self, latency_s: float) -> None:
        now = time.perf_counter()
        with self._lock:
            self.n_cached += 1
            self._lat.append(latency_s)
            self._done.append(now)

    def snapshot(self) -> dict:
        with self._lock:
            now = time.perf_counter()
            uptime = now - self.t_start
            served = self.n_requests + self.n_cached
            lat = np.asarray(self._lat, np.float64)
            done = list(self._done)
            out = {
                "uptime_s": round(uptime, 3),
                "requests": served,
                "cached_requests": self.n_cached,
                "batches": self.n_batches,
                "qps": round(served / uptime, 2) if uptime > 0 else 0.0,
                "batch_size_mean": round(self.n_requests / self.n_batches, 2)
                if self.n_batches else 0.0,
                "batch_size_hist": {str(b): c for b, c in
                                    sorted(self.batch_hist.items())},
                "bucket_hist": {str(b): c for b, c in
                                sorted(self.bucket_hist.items())},
            }
            if lat.size:
                out["latency_ms"] = {
                    "p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
                    "p99": round(float(np.percentile(lat, 99)) * 1e3, 3),
                    "mean": round(float(lat.mean()) * 1e3, 3),
                }
                # QPS over the latency window: how fast we are NOW
                if len(done) >= 2 and done[-1] > done[0]:
                    out["qps_window"] = round(
                        (len(done) - 1) / (done[-1] - done[0]), 2)
            if self._evals_n:
                out["distance_evals"] = round(
                    self._evals_sum / self._evals_n, 1)
            if self.n_requests:
                # fraction of queued rows whose top-k margin was unstable
                # and paid a second pass (0.0 when escalation is off)
                out["escalation_rate"] = round(
                    self.n_escalated / self.n_requests, 4)
            return out
