"""Minimal stdlib HTTP front end for the port's
:class:`~repro_torch.serve.engine.SearchEngine`.

Three endpoints, all JSON:

* ``POST /search`` — body ``{"query": [d floats], "k": 10}`` for a single
  query (rides the micro-batch scheduler + cache), or
  ``{"queries": [[...], ...], "k": 10}`` for an explicit batch (direct
  passthrough). Response: ``{"indices", "scores", "latency_ms",
  "distance_evals"}`` (batch shapes are ``[Q, k]``; single responses are
  flattened to ``[k]``).
* ``GET /stats`` — ``engine.stats()`` verbatim.
* ``GET /healthz`` — ``{"status": "ok", ...}`` once the index is built and
  the scheduler thread is alive (503 otherwise) — the k8s-style liveness
  probe.

``ThreadingHTTPServer`` gives one thread per in-flight request, which is
exactly what the engine wants: concurrent handlers block in
``search_one`` and coalesce into shared batches. Start with
:func:`make_server` + ``serve_forever`` (or ``start_http_server`` for a
background thread, which the tests use).
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .engine import SearchEngine


def _json_safe(scores: np.ndarray):
    """Scores -> nested lists with non-finite floats as None: index tiers
    pad short results with -inf (FAISS convention), and ``json.dumps``
    would emit the literal ``-Infinity``, which is not RFC 8259 JSON."""
    return [[s if math.isfinite(s) else None for s in row]
            for row in scores.tolist()]


class _Handler(BaseHTTPRequestHandler):
    engine: SearchEngine  # set by make_server on the handler subclass
    protocol_version = "HTTP/1.1"

    # quiet by default: serving logs belong to the launcher, not stderr
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib naming)
        if self.path == "/healthz":
            eng = self.engine
            ok = eng.index.built and eng.running
            self._reply(200 if ok else 503,
                        {"status": "ok" if ok else "unavailable",
                         "ntotal": eng.index.ntotal,
                         "fingerprint": eng.stats()["index"]["fingerprint"]})
        elif self.path == "/stats":
            self._reply(200, self.engine.stats())
        else:
            self._reply(404, {"error": f"unknown path {self.path!r}; "
                                       "try /search /stats /healthz"})

    def _validate(self, q: np.ndarray, ndim: int) -> None:
        """Reject malformed query payloads BEFORE they reach the engine:
        a NaN/inf query would poison the fingerprint-keyed result cache
        (the cache keys on query bytes, so the poisoned entry keeps
        serving), and a wrong-dim or ragged vector would surface as an
        opaque 500 from deep inside a kernel. Raises ValueError — the
        handler's 400 net."""
        if q.ndim != ndim:
            what = "query (one vector)" if ndim == 1 else \
                "queries (a batch of vectors)"
            raise ValueError(f"{what} must have {ndim} dimension(s), got "
                             f"shape {list(q.shape)}")
        want = self.engine.index.dim if self.engine.index.built else None
        if want is not None and q.shape[-1] != want:
            raise ValueError(f"query dim {q.shape[-1]} != index dim {want}")
        if not np.isfinite(q).all():
            raise ValueError("query contains NaN or infinite values")

    def do_POST(self):  # noqa: N802
        if self.path != "/search":
            self._reply(404, {"error": f"unknown path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            k = int(req.get("k", 10))
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            if "query" in req:
                q = np.asarray(req["query"], np.float32)
                self._validate(q, 1)
                res = self.engine.search_one(q, k)
                payload = {"indices": res.indices[0].tolist(),
                           "scores": _json_safe(res.scores)[0]}
            elif "queries" in req:
                q = np.asarray(req["queries"], np.float32)
                self._validate(q, 2)
                res = self.engine.search(q, k)
                payload = {"indices": res.indices.tolist(),
                           "scores": _json_safe(res.scores)}
            else:
                self._reply(400, {"error": 'body needs "query" (one vector) '
                                           'or "queries" (a batch)'})
                return
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        payload["latency_ms"] = round(res.latency_s * 1e3, 3)
        if res.distance_evals is not None:
            payload["distance_evals"] = res.distance_evals
        self._reply(200, payload)


class _Server(ThreadingHTTPServer):
    # concurrent single-query clients are the POINT of the engine: a
    # thundering herd of connects must queue, not bounce off the stdlib
    # default backlog of 5
    request_queue_size = 128
    daemon_threads = True


def make_server(engine: SearchEngine, port: int = 8000,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind (port 0 picks a free one — ``server.server_address`` tells
    which); caller runs ``serve_forever()``."""
    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    return _Server((host, port), handler)


def start_http_server(engine: SearchEngine, port: int = 8000,
                      host: str = "127.0.0.1"
                      ) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """Serve on a daemon thread; ``server.shutdown()`` stops it."""
    server = make_server(engine, port, host)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="serve-http")
    thread.start()
    return server, thread
