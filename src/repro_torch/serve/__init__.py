"""Serving layer: the micro-batched engine and its HTTP front end over
``repro_torch.api``.

``SearchEngine`` turns any built ``VectorIndex`` into a concurrent service:
an asyncio scheduler coalesces single-query requests into padded batches,
an LRU cache (keyed on the index fingerprint, the operating point, k and
the query bytes) absorbs repeats, warm-up searches every padded shape once,
and ``stats()`` reports QPS, latency percentiles, the batch-size histogram
and the cache hit rate. ``repro_torch.serve.http`` exposes it as
``/search``, ``/stats`` and ``/healthz`` on the stdlib HTTP server;
``python -m repro_torch.launch.serve --serve`` is the launcher.
"""
from .cache import LRUCache
from .engine import SearchEngine
from .http import make_server, start_http_server
from .metrics import EngineMetrics

__all__ = ["EngineMetrics", "LRUCache", "SearchEngine", "make_server",
           "start_http_server"]
