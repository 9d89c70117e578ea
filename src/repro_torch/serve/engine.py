"""Micro-batched serving engine over any ``repro_torch.api`` VectorIndex.

A user request is one query; the card's kernels (``rae_encode``,
``l2_topk``, ``pq_adc``, the graph traversals) amortize their launches over
a batch. ``SearchEngine`` closes the gap: concurrent single-query requests
land on an asyncio queue, a scheduler coalesces up to ``max_batch`` of them
(waiting at most ``max_wait_ms`` after the first), pads the stack to a
power-of-two bucket with copies of a real query row, runs ONE
``index.search``, and scatters the per-row results back to their callers.
Every tier answers a coalesced row independently of its batch-mates, bit
for bit (the port's row-invariance contract, tested on the CPU in
``tests/test_torch_serve.py`` and on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 10), except a
CPU HNSW index with ``batched="auto"``: as in the reference, it answers a
lone query on the host heapq engine, which agrees with the batched
traversal up to beam-boundary ties (``api.HNSWIndex``).

On top of the scheduler:

* an :class:`~repro_torch.serve.cache.LRUCache` keyed on ``(index
  fingerprint, operating point, k, query shape, query bytes)``: repeat
  queries skip the index; a hot ``set_index`` swap or a mutation can never
  serve stale answers because the fingerprint changes, and a knob change
  (``set_operating_point``) can never replay answers computed under other
  knobs because the resolved point is part of the key;
* **self-tuning** (``repro_torch.tune``): construct with
  ``target_recall=`` and an offline-fitted ``OperatingCurve`` and the
  engine serves the cheapest knob setting that meets the SLO; add an
  ``EscalationPolicy`` and every batch runs a cheap first pass, answers the
  rows whose top-k margin is stable, and re-runs only the unstable rows one
  :data:`~repro_torch.api.index.KNOB_LADDER` rung up, padded to the
  smallest covering bucket;
* ``warmup()``: searches every bucket x k x rung once, so the first real
  request pays search time, not what a cold path pays on the card (the
  kernel libraries' first load, cuBLAS handles, the caching allocator's
  first blocks; ``analysis.runtime.no_retrace`` counts the first);
* ``stats()``: QPS (lifetime and windowed), p50/p99 latency, batch-size
  histogram, cache hit rate, ``distance_evals``, escalation rate, mutation
  and swap counters (plus a mutable index's own epoch and tombstone stats);
* ``mutate(fn)`` / ``hot_swap(builder)``: live mutation. ``fn(index)``
  runs on the search executor, so it never interleaves with a batch;
  ``hot_swap`` builds and warms the replacement off the serving path and
  promotes it through ``set_index``: no query dropped, none answered stale.

Threading model: the asyncio loop runs on a dedicated daemon thread;
``search_one`` is safe to call from any thread and blocks until its future
resolves. ``index.search`` runs on a single-worker executor, so batch N+1
coalesces while batch N is on the card, and the index never sees
concurrent calls. Every ``search`` ends in a device sync before it
returns (its latency is device-synchronized), and a ``hot_swap`` builder
runs on its caller's thread on the same default stream: batches served
during a build wait for the build's work ahead of them on the stream.
"""
from __future__ import annotations

import asyncio
import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence

import numpy as np

from ..api.index import SearchParams, SearchResult, VectorIndex
from ..tune.autotune import OperatingCurve
from ..tune.escalate import EscalationPolicy, unstable_rows
from .cache import LRUCache
from .metrics import EngineMetrics

_STOP = object()
_UNSET = object()  # set_operating_point: "leave this field alone"


@dataclass
class _Request:
    q: np.ndarray                 # [d] f32
    k: int
    future: "asyncio.Future[SearchResult]"
    t_enq: float = field(default_factory=time.perf_counter)


def _buckets(max_batch: int) -> list[int]:
    """Padded batch sizes the engine searches at: powers of two up to
    (and always including) ``max_batch``."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class SearchEngine:
    """Wrap a built ``VectorIndex`` for concurrent single-query serving.

    >>> engine = SearchEngine(index, max_batch=32, max_wait_ms=2.0)
    >>> engine.start().warmup()
    >>> res = engine.search_one(query, k=10)     # from any thread
    >>> engine.stats()["batch_size_mean"]
    >>> engine.stop()

    Also usable as a context manager (``with SearchEngine(index) as e:``).
    """

    def __init__(self, index: VectorIndex, max_batch: int = 32,
                 max_wait_ms: float = 2.0, cache_size: int = 1024,
                 params: Optional[SearchParams] = None,
                 target_recall: Optional[float] = None,
                 curve: Optional[OperatingCurve] = None,
                 escalation: Optional[EscalationPolicy] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        index._require_built()
        self.index = index
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.buckets = _buckets(max_batch)
        self.cache = LRUCache(cache_size)
        self.metrics = EngineMetrics()
        self._fingerprint = index.fingerprint()
        self._explicit_params = params
        self._target_recall = target_recall
        self._curve = curve
        self._escalation = escalation
        self._resolve_operating_point()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[asyncio.Queue] = None
        self._batcher_task: Optional[asyncio.Task] = None
        self._pending: set[asyncio.Task] = set()
        self._inflight: Optional[asyncio.Task] = None
        self._accepting = False
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="engine-search")
        self._start_lock = threading.Lock()
        self._mutations = 0       # mutate() calls applied
        self._swaps = 0           # set_index()/hot_swap() promotions

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def loop(self) -> Optional[asyncio.AbstractEventLoop]:
        """The engine's event loop (None before start). Async clients can
        drive :meth:`asearch` on it directly via
        ``asyncio.run_coroutine_threadsafe`` — cheaper per request than one
        OS thread per in-flight call."""
        return self._loop

    def start(self) -> "SearchEngine":
        with self._start_lock:
            if self.running:
                return self
            ready = threading.Event()

            def _main():
                loop = asyncio.new_event_loop()
                asyncio.set_event_loop(loop)
                self._loop = loop
                self._queue = asyncio.Queue()
                self._accepting = True
                self._batcher_task = loop.create_task(self._batcher())
                loop.call_soon(ready.set)
                try:
                    loop.run_forever()
                finally:
                    loop.close()

            self._thread = threading.Thread(target=_main, daemon=True,
                                            name="search-engine")
            self._thread.start()
            ready.wait()
        return self

    def stop(self) -> None:
        with self._start_lock:
            if not self.running:
                return
            asyncio.run_coroutine_threadsafe(self._shutdown(),
                                             self._loop).result()
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=10)
            self._thread = None
            self._loop = None

    async def _shutdown(self):
        # refuse new submissions FIRST (same thread as asearch, which has
        # no await between its accepting-check and its enqueue, so no
        # request can slip in after the drain below and hang its caller)
        self._accepting = False
        await self._queue.put(_STOP)
        await self._batcher_task
        if self._pending:
            await asyncio.gather(*self._pending, return_exceptions=True)
        # requests that raced the sentinel would otherwise hang their
        # callers forever: fail them loudly instead
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if item is not _STOP and not item.future.done():
                item.future.set_exception(
                    RuntimeError("engine stopped before request was served"))

    def __enter__(self) -> "SearchEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # operating point (repro_torch.tune)
    # ------------------------------------------------------------------
    def _resolve_operating_point(self) -> None:
        """Collapse (target_recall, curve, explicit params, escalation)
        into the concrete per-call knobs every search uses:
        ``self._params`` (pass 1; None = index defaults),
        ``self._esc_params`` (pass 2; None = escalation off) and
        ``self._op_token`` (the cache-key component). Called under
        ``__init__`` and, via the search executor, whenever the index or
        the point changes — never concurrently with a batch."""
        base = SearchParams()
        if self._target_recall is not None:
            if self._curve is None:
                raise ValueError(
                    "target_recall needs an OperatingCurve: run "
                    "repro_torch.tune.sweep offline and pass curve=")
            if self._curve.fingerprint != self._fingerprint:
                raise ValueError(
                    f"operating curve was tuned for fingerprint "
                    f"{self._curve.fingerprint}, live index is "
                    f"{self._fingerprint} — re-run repro_torch.tune.sweep "
                    f"on this build (or set_operating_point(curve=...))")
            # escalation closes small recall gaps, so its recall_slack
            # DISCOUNTS the curve selection: start up to one rung
            # cheaper, let pass 2 recover (held-out queries verify the
            # SLO: chip_smoke.py phase 10)
            slack = (-self._escalation.recall_slack
                     if self._escalation is not None else 0.0)
            base = self._curve.select(self._target_recall, slack=slack).params
        if self._explicit_params is not None:
            base = base.merged(self._explicit_params)
        self._params = base if base.key() != (None, None, None) else None
        if self._escalation is None:
            self._esc_params = None
        else:
            ep = self._escalation.params
            if ep is None and self._params is not None:
                ep = self._params.escalated()
            if ep is None:
                raise ValueError(
                    "escalation needs a pass-2 operating point: give "
                    "EscalationPolicy(params=...), or set params/"
                    "target_recall so the engine can take the next "
                    "ladder rung")
            self._esc_params = ep
        self._op_token = (
            self._target_recall,
            None if self._params is None else self._params.key(),
            None if self._escalation is None else
            (self._escalation.delta, float(self._escalation.threshold),
             self._esc_params.key()))

    def set_operating_point(self, *, params=_UNSET, target_recall=_UNSET,
                            curve=_UNSET, escalation=_UNSET) -> None:
        """Change any part of the operating point on a live engine.
        Omitted keywords keep their current value; pass ``None`` to clear
        one. Runs on the search executor, so the switch is atomic with
        respect to in-flight batches, and the new resolved point enters
        the cache key — a knob change can never replay an answer computed
        under the old knobs."""

        def _apply():
            if params is not _UNSET:
                self._explicit_params = params
            if target_recall is not _UNSET:
                self._target_recall = target_recall
            if curve is not _UNSET:
                self._curve = curve
            if escalation is not _UNSET:
                self._escalation = escalation
            self._resolve_operating_point()

        if self.running:
            self._executor.submit(_apply).result()
        else:
            _apply()

    def _warm_points(self, k: int) -> list[tuple[int, Optional[SearchParams]]]:
        """(k_effective, params) pairs a warmup must search at for one
        served ``k``: with escalation on, BOTH passes over-fetch
        ``k + delta`` — pass 1 at the base point, pass 2 one rung up."""
        if self._escalation is None:
            return [(k, self._params)]
        kk = k + self._escalation.delta
        return [(kk, self._params), (kk, self._esc_params)]

    # ------------------------------------------------------------------
    # serving paths
    # ------------------------------------------------------------------
    def _cache_key(self, q: np.ndarray, k: int) -> tuple:
        # fingerprint pins the build, op_token pins the knobs: both can
        # change under a live engine (hot swap / set_operating_point) and
        # either change must retire every prior answer
        return (self._fingerprint, self._op_token, k, q.shape, q.tobytes())

    async def asearch(self, query: np.ndarray, k: int = 10) -> SearchResult:
        """Single-query path: cache lookup, then the micro-batch queue."""
        q = np.ascontiguousarray(query, np.float32)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]
        if q.ndim != 1:
            raise ValueError("asearch/search_one take ONE query vector "
                             f"([d] or [1, d]); got shape {q.shape}. "
                             "Use engine.search for explicit batches.")
        if q.shape[0] != self.index.dim:
            # reject BEFORE the queue: a wrong-dim request inside a
            # coalesced batch would fail every co-batched request
            raise ValueError(f"query has dim {q.shape[0]} but the index "
                             f"takes {self.index.dim}-d queries")
        if self.cache.maxsize:  # disabled cache: skip the key hash entirely
            t0 = time.perf_counter()
            hit = self.cache.get(self._cache_key(q, k))
            if hit is not None:
                dt = time.perf_counter() - t0
                self.metrics.record_cached(dt)
                # arrays are shared (frozen); latency + stats are this
                # serve's own so a caller mutating them can't leak back
                return replace(hit, latency_s=dt, stats=dict(hit.stats))
        if not self._accepting:
            raise RuntimeError("engine is stopping; request rejected")
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(_Request(q=q, k=int(k), future=fut))
        return await fut

    def search_one(self, query: np.ndarray, k: int = 10) -> SearchResult:
        """Thread-safe blocking wrapper around :meth:`asearch` (auto-starts
        the engine). This is the path HTTP handlers and threaded clients
        use — N threads calling it concurrently coalesce into shared
        batches."""
        if not self.running:  # fast path: skip the start lock per request
            self.start()
        loop = self._loop  # local capture: a concurrent stop() nulls it
        if loop is None:
            raise RuntimeError("engine stopped while request was submitted")
        return asyncio.run_coroutine_threadsafe(
            self.asearch(query, k), loop).result()

    def _escalated_search(self, qs: np.ndarray, k: int
                          ) -> tuple[SearchResult, np.ndarray]:
        """One engine-side search at the resolved operating point,
        returning ([Q, k] result, escalated-row mask).

        Without escalation this is a plain ``index.search`` at the tuned
        params. With it: pass 1 over-fetches ``k + delta`` at the cheap
        point, the normalized top-k tail margin flags unstable rows
        (``repro_torch.tune.escalate``), and ONLY those rows re-run one ladder
        rung up — padded to the engine's smallest covering bucket, so
        pass 2 reuses the same warmed shapes regardless of how many rows
        escalate, and a row escalated solo is bitwise identical to the
        same row escalated inside any batch (the tiers' row-invariance
        contract). Stable rows answer from pass 1 untouched. Stats
        compose: ``distance_evals`` amortizes the pass-2 cost over the
        whole batch; per-row attribution happens in ``_run_batch``."""
        esc = self._escalation
        if esc is None:
            r = self.index.search(qs, k, params=self._params)
            return r, np.zeros(qs.shape[0], bool)
        kk = k + esc.delta
        r1 = self.index.search(qs, kk, params=self._params)
        if r1.scores.shape[1] < kk:
            # corpus smaller than k + delta: a wider search has nothing
            # more to find, and the margin is undefined — serve pass 1,
            # trimmed to the k columns the caller asked for
            return SearchResult(
                scores=np.asarray(r1.scores)[:, :k],
                indices=np.asarray(r1.indices)[:, :k],
                latency_s=r1.latency_s, stats=dict(r1.stats)), \
                np.zeros(qs.shape[0], bool)
        mask = unstable_rows(r1.scores, k, esc.delta, esc.threshold,
                             ntotal=self.index.ntotal)
        scores = np.asarray(r1.scores)[:, :k].copy()
        idx = np.asarray(r1.indices)[:, :k].copy()
        n, n_esc = qs.shape[0], int(mask.sum())
        e1 = r1.stats.get("distance_evals", 0.0)
        e2, latency = 0.0, r1.latency_s
        if n_esc:
            sub = qs[mask]
            bucket = next((b for b in self.buckets if b >= n_esc), n_esc)
            if bucket > n_esc:
                sub = np.concatenate(
                    [sub, np.repeat(sub[:1], bucket - n_esc, axis=0)])
            r2 = self.index.search(sub, kk, params=self._esc_params)
            scores[mask] = np.asarray(r2.scores)[:n_esc, :k]
            idx[mask] = np.asarray(r2.indices)[:n_esc, :k]
            e2 = r2.stats.get("distance_evals", 0.0)
            latency += r2.latency_s
        stats = dict(r1.stats)
        stats.update({
            "distance_evals": e1 + e2 * (n_esc / n),
            "pass1_distance_evals": e1,
            "pass2_distance_evals": e2,
            "escalated_frac": n_esc / n,
        })
        return SearchResult(scores=scores, indices=idx,
                            latency_s=latency, stats=stats), mask

    def search(self, queries: np.ndarray, k: int = 10) -> SearchResult:
        """Explicit-batch passthrough: the caller already batched, so skip
        the queue (and the single-query cache) but keep the metrics. Runs
        at the engine's resolved operating point, escalation included —
        benches measuring the tuned engine go through here."""
        queries = np.asarray(queries, np.float32)
        res, mask = self._escalated_search(queries, k)
        n = queries.shape[0]
        self.metrics.record_batch(size=n, bucket=n,
                                  latencies_s=[res.latency_s] * n,
                                  distance_evals=res.distance_evals,
                                  escalated=int(mask.sum()))
        return res

    def set_index(self, index: VectorIndex) -> None:
        """Hot-swap the served index. Runs on the search executor so it
        can never interleave with an in-flight batch; the new fingerprint
        invalidates every cached result implicitly. Re-resolves the
        operating point against the new build — an engine pinned to a
        ``target_recall`` curve refuses a swap to a build the curve was
        not tuned on (re-sweep first, then ``set_operating_point``)."""
        index._require_built()

        def _swap():
            self.index = index
            self._fingerprint = index.fingerprint()
            self._resolve_operating_point()

        if self.running:
            self._executor.submit(_swap).result()
        else:
            _swap()
        self._swaps += 1

    def mutate(self, fn):
        """Apply a mutation to the served index, atomically with respect
        to in-flight batches: ``fn(index)`` runs on the single-worker
        search executor (the only thread that ever calls
        ``index.search``), so no query can observe a half-applied insert
        or delete, and the refreshed fingerprint retires every cached
        pre-mutation answer. Returns whatever ``fn`` returns —
        ``engine.mutate(lambda ix: ix.add(rows))`` hands back the new
        ids. Queries keep coalescing while the mutation waits its turn;
        none are dropped."""

        def _apply():
            out = fn(self.index)
            self._fingerprint = self.index.fingerprint()
            # re-resolve: a tuned curve is pinned to the pre-mutation
            # fingerprint, so an engine serving a recall SLO fails loudly
            # here rather than serve an SLO its curve no longer certifies
            self._resolve_operating_point()
            return out

        if self.running:
            result = self._executor.submit(_apply).result()
        else:
            result = _apply()
        self._mutations += 1
        return result

    def hot_swap(self, builder, ks: Sequence[int] = (10,),
                 seed: int = 0) -> VectorIndex:
        """Zero-downtime replacement via double buffering: ``builder()``
        constructs the NEW index entirely off the serving path — queries
        keep flowing against the old one for however long the build takes
        — then the fresh index is warmed at every padded bucket size
        (first-use costs paid off-path too) and promoted through
        :meth:`set_index`, which runs on the search executor and is
        therefore atomic with in-flight batches: every query is answered,
        each one entirely by the old or entirely by the new index, and
        the fingerprint change keeps the cache honest. Returns the
        promoted index."""
        new_index = builder()
        new_index._require_built()
        rng = np.random.default_rng(seed)
        for k in ks:
            for kw, p in self._warm_points(k):
                for b in self.buckets:
                    q = rng.standard_normal(
                        (b, new_index.dim)).astype(np.float32)
                    new_index.search(q, kw, params=p)
        self.set_index(new_index)
        return new_index

    def warmup(self, dim: Optional[int] = None,
               ks: Sequence[int] = (10,), seed: int = 0) -> "SearchEngine":
        """Search every padded bucket size (x every k the deployment
        serves, x both escalation rungs) once, so no real request pays a
        cold path: the kernel libraries' first load, cuBLAS handles and
        workspaces, the caching allocator's first blocks. Warm-up queries
        are seeded random normals, not zeros: an all-zeros batch ties every
        query at the graph's entry point and stops a traversal after one
        hop. Warm-up searches bypass the metrics: stats reflect traffic."""
        dim = dim if dim is not None else self.index.dim
        rng = np.random.default_rng(seed)
        for k in ks:
            # with escalation on, warm BOTH passes' shapes: k + delta at
            # the base rung and at the escalated rung, every bucket —
            # serving then never meets a cold path, however many escalate
            for kw, p in self._warm_points(k):
                for b in self.buckets:
                    q = rng.standard_normal((b, dim)).astype(np.float32)
                    self.index.search(q, kw, params=p)
        return self

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    async def _batcher(self):
        loop = asyncio.get_running_loop()
        while True:
            head = await self._queue.get()
            if head is _STOP:
                return
            batch = [head]
            deadline = loop.time() + self.max_wait_ms / 1e3
            stop = False
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    if self._inflight is None or self._inflight.done():
                        break
                    # past the deadline but the search executor is still
                    # chewing the previous batch: flushing now would only
                    # queue behind it, so keep coalescing (batches FILL
                    # under load, at zero added latency) — sleeping until
                    # a request arrives OR the executor frees, no polling
                    get_task = loop.create_task(self._queue.get())
                    await asyncio.wait({get_task, self._inflight},
                                       return_when=asyncio.FIRST_COMPLETED)
                    if not get_task.done():
                        get_task.cancel()
                        with contextlib.suppress(asyncio.CancelledError):
                            await get_task
                        continue  # executor freed: loop breaks above
                    item = get_task.result()
                else:
                    try:
                        item = await asyncio.wait_for(self._queue.get(),
                                                      timeout)
                    except asyncio.TimeoutError:
                        continue  # re-check deadline + executor state
                if item is _STOP:
                    stop = True
                    break
                batch.append(item)
            # same-k requests share one padded search; mixed k (rare in
            # practice) split into per-k flushes, still inside this cycle
            groups: dict[int, list[_Request]] = {}
            for req in batch:
                groups.setdefault(req.k, []).append(req)
            for k, reqs in groups.items():
                task = loop.create_task(self._flush(k, reqs))
                self._pending.add(task)
                task.add_done_callback(self._pending.discard)
                self._inflight = task  # last task: executor is FIFO
            if stop:
                return

    async def _flush(self, k: int, reqs: list[_Request]):
        loop = asyncio.get_running_loop()
        try:
            results = await loop.run_in_executor(
                self._executor, self._run_batch, k, reqs)
        except Exception as e:  # surface to every caller, keep serving
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(e)
            return
        for req, res in zip(reqs, results):
            if not req.future.done():
                req.future.set_result(res)

    def _run_batch(self, k: int, reqs: list[_Request]) -> list[SearchResult]:
        """Executor-side: pad to the bucket, search once (escalating
        unstable rows at the operating point), slice per caller."""
        size = len(reqs)
        bucket = next(b for b in self.buckets if b >= size)
        qs = np.stack([r.q for r in reqs])
        if bucket > size:
            # pad with a REAL query row (not zeros): identical numerics to
            # the unpadded rows, and never a degenerate all-zero distance
            qs = np.concatenate(
                [qs, np.repeat(qs[:1], bucket - size, axis=0)])
        res, esc_mask = self._escalated_search(qs, k)
        done = time.perf_counter()
        e1 = res.stats.get("pass1_distance_evals",
                           res.stats.get("distance_evals", 0.0))
        e2 = res.stats.get("pass2_distance_evals", 0.0)
        out = []
        for i, req in enumerate(reqs):
            stats = dict(res.stats)
            if self._escalation is not None:
                # per-row attribution: an escalated row paid both passes,
                # a stable row only the first
                stats["distance_evals"] = e1 + (e2 if esc_mask[i] else 0.0)
                stats["escalated"] = bool(esc_mask[i])
            single = SearchResult(scores=res.scores[i:i + 1].copy(),
                                  indices=res.indices[i:i + 1].copy(),
                                  latency_s=res.latency_s,
                                  stats=stats)
            if self.cache.maxsize:
                # the cached object IS the returned object: freeze its
                # arrays so a caller mutating its result can't poison
                # every future hit on this key
                single.scores.setflags(write=False)
                single.indices.setflags(write=False)
                self.cache.put(self._cache_key(req.q, k), single)
            out.append(single)
        self.metrics.record_batch(
            size=size, bucket=bucket,
            latencies_s=[done - r.t_enq for r in reqs],
            distance_evals=res.distance_evals,
            escalated=int(esc_mask[:size].sum()))
        return out

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        out = self.metrics.snapshot()
        out["cache"] = self.cache.stats()
        out["index"] = {"kind": self.index.kind,
                        "ntotal": self.index.ntotal,
                        "fingerprint": self._fingerprint,
                        "bytes_per_vector": self.index.bytes_per_vector,
                        "shards": getattr(self.index, "shard_count", None)}
        out["scheduler"] = {"max_batch": self.max_batch,
                            "max_wait_ms": self.max_wait_ms,
                            "buckets": self.buckets,
                            "running": self.running}
        out["operating_point"] = {
            "target_recall": self._target_recall,
            "params": None if self._params is None
            else self._params.to_dict(),
            "escalation": None if self._escalation is None else {
                "delta": self._escalation.delta,
                "threshold": self._escalation.threshold,
                "params": self._esc_params.to_dict()},
            "tuned": self._curve is not None,
        }
        out["mutation"] = {"mutations": self._mutations,
                           "swaps": self._swaps}
        ms = getattr(self.index, "mutation_stats", None)
        if ms is not None:
            out["mutation"]["index"] = ms()
        return out
