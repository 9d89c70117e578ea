"""Vector-search serving launcher on the port's ``repro_torch.api``.

The index stack is a FAISS-style spec string (``--index-spec``), built by
``api.index_factory`` on ``--device`` (default ``cuda``)::

    RAE64,Flat,Rerank4         # the paper stack: RAE -> reduced scan -> rerank
    RAE64,IVF256,Rerank4       # + coarse quantization in the reduced space
    RAE64,HNSW32,Rerank4       # + graph beam search: sublinear per-query work
    RAE64,IVF256,PQ8x8,Rerank4 # + PQ list payloads (8 bytes/vector, ADC)
    RAE32,SQ8                  # reduce, then int8 scalar codes
    PCA64,Flat,Rerank4         # baseline reducer, same serving path
    Flat                       # exact full-space scan (the recall reference)

Every batch reports ``distance_evals`` (the mean number of corpus vectors
each query scored). ``--ef-search`` tunes the HNSW beam width at serve
time. Built indexes persist (``--save-index DIR``) and reload without
retraining (``--load-index DIR``, a directory either package saved).

The built index is wrapped in :class:`repro_torch.serve.SearchEngine`
(warmed up at every padded batch size). Two modes:

* default: a closed-loop run through the engine's batch path, reporting
  recall against the exact scan and the engine's stats;
* ``--serve``: stay up as an HTTP service (``POST /search``,
  ``GET /stats``, ``GET /healthz``) where concurrent single-query clients
  are coalesced by the micro-batching scheduler (``--max-batch`` /
  ``--max-wait-ms`` / ``--cache-size``).

``--device cpu`` runs the plain versions of the kernels (the tests use
it); there is no fallback: without a CUDA card the default device fails.

    python -m repro_torch.launch.serve --n 20000 --dim 256 --m 64
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np

from .. import api
from ..data import synthetic
from ..serve import SearchEngine, make_server


def build_or_load_index(args) -> tuple[api.VectorIndex, np.ndarray]:
    """Returns (ready index, corpus). The corpus is synthesized either way:
    a loaded index serves it from its own persisted state, but the recall
    reference scan still needs the raw vectors."""
    corpus = synthetic.embedding_corpus(args.n, args.dim, n_clusters=16,
                                        intrinsic=args.dim // 4,
                                        seed=args.seed)
    if args.load_index:
        print(f"[2/5] loading index from {args.load_index}")
        index = api.load_index(args.load_index, device=args.device)
        if args.ef_search is not None:
            # ef_search is a pure query-time knob: retune the beam on a
            # loaded graph instead of silently serving the saved width
            hnsw = index.base if isinstance(index, api.TwoStageIndex) \
                else index
            if isinstance(hnsw, api.HNSWIndex):
                hnsw.ef_search = args.ef_search
                print(f"      ef_search -> {args.ef_search}")
        if index.ntotal != args.n:
            raise SystemExit(
                f"loaded index holds {index.ntotal} vectors but "
                f"--n={args.n}: the recall reference would compare ids "
                f"across different corpora. Re-serve with --n "
                f"{index.ntotal} (and the --dim/--seed the index was "
                f"built with).")
        if index.dim != args.dim:
            raise SystemExit(
                f"loaded index takes {index.dim}-d queries but "
                f"--dim={args.dim}: re-serve with --dim {index.dim}.")
        return index, corpus

    spec = args.index_spec or f"RAE{args.m},Flat,Rerank{args.rerank_factor}"
    parsed = api.parse_index_spec(spec)
    reducer_kw = {}
    if parsed.reducer == "rae":
        reducer_kw = dict(steps=args.steps, weight_decay=args.weight_decay,
                          seed=args.seed)
    index_kw = {}
    if parsed.base == "hnsw":
        index_kw = dict(ef_construction=args.ef_construction or 100,
                        ef_search=args.ef_search or 64, seed=args.seed)
    print(f"[2/5] building {spec!r}"
          + (f" (rae: {args.steps} steps, lambda={args.weight_decay})"
             if reducer_kw else "")
          + (f" (hnsw: efC={index_kw['ef_construction']}, "
             f"efS={index_kw['ef_search']})" if index_kw else ""))
    index = api.index_factory(spec, reducer_kw=reducer_kw, index_kw=index_kw,
                              device=args.device)
    t0 = time.perf_counter()
    index.build(corpus)
    print(f"      built in {time.perf_counter() - t0:.2f}s "
          f"(ntotal={index.ntotal}, "
          f"{index.bytes_per_vector:.0f} bytes/vector stage-1)")
    return index, corpus


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--m", type=int, default=64,
                    help="reducer target dim for the default spec")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--rerank-factor", type=int, default=4)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--weight-decay", type=float, default=1e-2)
    ap.add_argument("--ef-construction", type=int, default=None,
                    help="HNSW insert-time beam width (default 100; "
                         "HNSW specs only)")
    ap.add_argument("--ef-search", type=int, default=None,
                    help="HNSW query-time beam width, the recall/latency "
                         "knob (default 64); also retunes a --load-index'd "
                         "graph")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the index lives and searches (cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--index-spec", default=None,
                    help='factory spec, e.g. "RAE64,IVF256,PQ8x8,Rerank4" '
                         'or "RAE32,SQ8" '
                         "(default: RAE<m>,Flat,Rerank<rerank-factor>)")
    ap.add_argument("--save-index", default=None, metavar="DIR",
                    help="persist the built index (reducer + base + corpus)")
    ap.add_argument("--load-index", default=None, metavar="DIR",
                    help="serve a previously saved index (skips training)")
    ap.add_argument("--serve", action="store_true",
                    help="stay up as an HTTP service instead of running "
                         "the one-shot benchmark loop")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port for --serve (0 picks a free one)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="scheduler: coalesce at most this many concurrent "
                         "single-query requests per index.search call")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="scheduler: max wait after the first queued "
                         "request before flushing a partial batch")
    ap.add_argument("--cache-size", type=int, default=1024,
                    help="LRU result-cache entries (0 disables)")
    args = ap.parse_args(argv)

    print(f"[1/5] corpus: {args.n} x {args.dim} (device {args.device})")
    index, corpus = build_or_load_index(args)

    if args.save_index:
        index.save(args.save_index)
        print(f"      saved -> {args.save_index}")

    engine = SearchEngine(index, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          cache_size=args.cache_size)

    if args.serve:
        print(f"[3/5] engine warm-up: buckets {engine.buckets}, k={args.k}")
        engine.start().warmup(ks=(args.k,))  # dim from the index itself
        server = make_server(engine, port=args.port, host=args.host)
        host, port = server.server_address[:2]
        print(f"[4/5] serving http://{host}:{port} "
              f"(POST /search, GET /stats, GET /healthz) — ^C to stop")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            print("[5/5] final stats:")
            print(json.dumps(engine.stats(), indent=1))
            engine.stop()
        return 0

    print("[3/5] exact reference index (recall baseline)")
    exact = api.FlatIndex(device=args.device).build(corpus)

    print(f"[4/5] serving {args.batches} batches x {args.queries} queries "
          "through the engine")
    rng = np.random.default_rng(args.seed + 1)
    lat, recalls = [], []
    for _ in range(args.batches):
        q = corpus[rng.integers(0, args.n, args.queries)] + \
            0.01 * rng.standard_normal(
                (args.queries, args.dim)).astype(np.float32)
        res = engine.search(q, args.k)
        lat.append(res.latency_s)
        ref = exact.search(q, args.k)
        inter = (ref.indices[:, :, None] ==
                 res.indices[:, None, :]).any(-1).mean()
        recalls.append(float(inter))
    lat_ms = np.array(lat[1:] or lat) * 1e3  # drop the first (cold) batch
    stats = engine.stats()
    evals_str = ""
    if "distance_evals" in stats:
        ev = stats["distance_evals"]
        evals_str = (f" | distance evals/query {ev:.0f} "
                     f"({ev / args.n:.1%} of corpus)")
    print(f"[5/5] recall@{args.k}: {np.mean(recalls):.4f} | "
          f"latency p50 {np.percentile(lat_ms, 50):.2f} ms "
          f"p99 {np.percentile(lat_ms, 99):.2f} ms" + evals_str)
    print(f"      engine: {stats['requests']} queries in "
          f"{stats['batches']} batches, qps={stats['qps']:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
