"""``ShardedIndex``: scatter-gather search over disjoint shards.

The port of the reference's ``api/sharded.py`` (its thread-pool mode). The
corpus is partitioned across shards (contiguous row ranges,
``partition="rows"``, or k-means cells, ``partition="ivf"``, through
``distributed.partitioning``), and each shard is an independent child
:class:`VectorIndex` built from a factory spec (``"Flat"``, ``"IVF256"``)
on the same device. ``search`` fans the query batch out to every child on
a thread pool, maps local hits to global row ids through the shard's row
map, and reduces the gathered ``[Q, k * S]`` candidates with the
``topk_merge`` op (the hand-written kernel on the card) under (score desc,
global id asc): the answer is bitwise invariant to the shard count when
scores are exact.

On one card the children's kernels share PyTorch's default stream, so they
run one after another; the answer does not depend on it. Children return
numpy results, which go back to the device for the merge, as in the
reference (``api/sharded.py:247-260``).

``workers="mesh"`` (the corpus row-sharded over several devices, merged on
the device) needs more than one device and is not ported: it raises.

``fingerprint()`` composes over the child fingerprints and row maps, with
the reference's bytes; ``save``/``load_index`` use its layout (``rows<i>``
arrays, ``shard<i>/`` subdirectories).
"""
from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.partitioning import partition_ivf_cells, partition_rows
from ..kernels.common import PAD_ID
from ..kernels.topk_merge import topk_merge
from .index import (SearchResult, VectorIndex, _load_arrays, _numpy,
                    _save_dir, _sync, alive_tensor, load_index,
                    register_index)
from .reducer import as_device_tensor


@register_index("sharded")
class ShardedIndex(VectorIndex):
    """Partition the corpus across ``n_shards`` child indexes and merge
    per-shard top-k with the deterministic ``topk_merge``."""

    def __init__(self, n_shards: int = 2, child_spec: str = "Flat",
                 partition: str = "rows", metric: str = "euclidean",
                 workers: str = "threads", n_workers: int = 0,
                 n_cells: int = 0, seed: int = 0,
                 index_kw: Optional[dict[str, Any]] = None,
                 device: str | torch.device = "cuda"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if partition not in ("rows", "ivf"):
            raise ValueError(f"unknown partition {partition!r} "
                             "(rows | ivf)")
        if workers not in ("threads", "mesh"):
            raise ValueError(f"unknown workers {workers!r} (threads | mesh)")
        self.n_shards = n_shards
        self.child_spec = child_spec
        self.partition = partition
        self.metric = metric
        self.workers = workers
        self.n_workers = n_workers
        self.n_cells = n_cells
        self.seed = seed
        self.index_kw = dict(index_kw or {})
        self.device = torch.device(device)
        self._shards: list[VectorIndex] = []
        self._row_maps: list[np.ndarray] = []
        self._row_maps_dev: list[torch.Tensor] = []  # derived, on device
        self._ntotal = 0
        self._dim = 0
        #: host seconds of the last build: partition, then each child
        self.build_times: dict[str, Any] = {}

    # -- identity ----------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self._ntotal

    @property
    def built(self) -> bool:
        return bool(self._shards)

    @property
    def shard_count(self) -> int:
        """Shards actually built (<= n_shards: empty partitions collapse)."""
        return len(self._shards)

    @property
    def bytes_per_vector(self) -> float:
        self._require_built()
        return max(c.bytes_per_vector for c in self._shards)

    @property
    def bytes_per_shard(self) -> float:
        """Largest per-shard payload: what must fit one worker."""
        self._require_built()
        return max(c.ntotal * c.bytes_per_vector for c in self._shards)

    @property
    def dim(self) -> int:
        self._require_built()
        return self._dim

    @property
    def stage1_oversample(self) -> int:
        """Under a rerank, inherit the children's oversample."""
        if not self._shards:
            return 1
        return max(getattr(c, "stage1_oversample", 1) for c in self._shards)

    def _fingerprint_state(self) -> list:
        state = [f"shards={self.n_shards}:{self.partition}:"
                 f"{self.child_spec}:{self.metric}"]
        for child in self._shards:
            state.append(child.fingerprint())
        for rows in self._row_maps:
            state.append(rows)
        return state

    # -- build -------------------------------------------------------------
    def _make_child(self) -> VectorIndex:
        from .factory import index_factory, parse_index_spec  # cycle: lazy

        parsed = parse_index_spec(self.child_spec)
        if parsed.reducer or parsed.shards or parsed.rerank_factor > 1:
            raise ValueError(
                f"child_spec {self.child_spec!r} must be a storage stack "
                "(base [, quant]); reducers/Shard/Rerank wrap the sharded "
                "index, not its children")
        return index_factory(self.child_spec, metric=self.metric,
                             index_kw=dict(self.index_kw),
                             device=self.device)

    def build(self, corpus) -> "ShardedIndex":
        if self.workers == "mesh":
            raise NotImplementedError(
                "ShardedIndex(workers='mesh') row-shards the corpus over a "
                "mesh of several devices and merges on the device; the port "
                "runs on one card, so that mode is not ported (it waits for "
                "a 4-chip cell). Use workers='threads'.")
        corpus = as_device_tensor(corpus, self.device)
        n = int(corpus.shape[0])
        t0 = time.perf_counter()
        if self.partition == "rows":
            parts = partition_rows(n, self.n_shards)
        else:
            parts = partition_ivf_cells(corpus, self.n_shards,
                                        n_cells=self.n_cells,
                                        seed=self.seed)
        parts = [p for p in parts if len(p)]  # empty shards answer nothing
        _sync(self.device)
        times: dict[str, Any] = {"partition_s": time.perf_counter() - t0,
                                 "children_s": []}
        self._shards = []
        self._row_maps = []
        for rows in parts:
            t0 = time.perf_counter()
            sel = torch.as_tensor(rows, dtype=torch.long, device=self.device)
            self._shards.append(self._make_child().build(corpus[sel]))
            self._row_maps.append(np.asarray(rows, np.int32))
            _sync(self.device)
            times["children_s"].append(time.perf_counter() - t0)
        self._ntotal = n
        self._dim = int(corpus.shape[1])
        self._upload_row_maps()
        self.build_times = times
        return self

    def _upload_row_maps(self) -> None:
        self._row_maps_dev = [torch.as_tensor(r, dtype=torch.long,
                                              device=self.device)
                              for r in self._row_maps]

    # -- search ------------------------------------------------------------
    @functools.cached_property
    def _pool(self) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(
            max_workers=self.n_workers or max(1, len(self._shards)),
            thread_name_prefix="shard")

    def set_params(self, params) -> None:
        """Broadcast a tuned operating point to every shard (the children
        hold the knobs and hash them)."""
        self._require_built()
        for child in self._shards:
            child.set_params(params)

    def fan_out(self, queries, k_req: int, alive=None,
                params=None) -> list[SearchResult]:
        """Every child's local top-``k_req`` (clamped to its size), on the
        thread pool when there is more than one child."""
        q = as_device_tensor(queries, self.device)
        # tombstones slice per shard through the row maps, on the device
        al = None if alive is None else alive_tensor(alive, self.device)
        child_alive = [None if al is None else al[rows]
                       for rows in self._row_maps_dev]
        if len(self._shards) == 1:
            child = self._shards[0]
            return [child.search(q, min(k_req, child.ntotal),
                                 alive=child_alive[0], params=params)]
        futs = [self._pool.submit(child.search, q, min(k_req, child.ntotal),
                                  alive=child_alive[s], params=params)
                for s, child in enumerate(self._shards)]
        return [f.result() for f in futs]

    def candidates(self, results: list[SearchResult]
                   ) -> tuple[np.ndarray, np.ndarray]:
        """The children's answers side by side: (scores [Q, sum k_s]
        float32, global ids [Q, sum k_s] int32, -1 for pads)."""
        vals = np.concatenate(
            [np.asarray(r.scores, np.float32) for r in results], axis=1)
        local = np.concatenate(
            [np.asarray(r.indices, np.int64) for r in results], axis=1)
        # local -> global ids shard by shard; -1 pads stay -1
        gids = np.empty_like(local, dtype=np.int32)
        off = 0
        for rows, r in zip(self._row_maps, results):
            w = r.indices.shape[1]
            blk = local[:, off:off + w]
            gids[:, off:off + w] = np.where(
                blk >= 0, rows[np.clip(blk, 0, len(rows) - 1)], PAD_ID)
            off += w
        return vals, gids

    def merge(self, results: list[SearchResult], k_req: int
              ) -> tuple[np.ndarray, np.ndarray]:
        """``topk_merge`` the children's candidates on the index's device.
        Pads come out as the API's ``(-inf, -1)``."""
        vals, gids = self.candidates(results)
        v, i = topk_merge(torch.as_tensor(vals, device=self.device),
                          torch.as_tensor(gids, device=self.device), k_req)
        scores = np.array(_numpy(v))
        idx = _numpy(i)
        scores[idx < 0] = -np.inf  # the API layer speaks the FAISS pad dialect
        return scores, idx

    def search(self, queries, k: int, alive=None,
               params=None) -> SearchResult:
        self._require_built()
        _sync(self.device)
        t0 = time.perf_counter()
        k_req = min(k, self.ntotal)
        results = self.fan_out(queries, k_req, alive, params)
        scores, idx = self.merge(results, k_req)
        dt = time.perf_counter() - t0
        stats = {"distance_evals": float(sum(
            r.stats.get("distance_evals", 0.0) for r in results)),
            "shards": float(len(results))}
        return SearchResult(scores=scores, indices=idx, latency_s=dt,
                            stats=stats)

    # -- persistence -------------------------------------------------------
    def save(self, directory: str) -> None:
        self._require_built()
        meta = {"kind": self.kind, "n_shards": self.n_shards,
                "partition": self.partition, "child_spec": self.child_spec,
                "metric": self.metric, "ntotal": self._ntotal,
                "dim": self._dim, "built_shards": len(self._shards)}
        _save_dir(directory, meta,
                  {f"rows{i}": rows
                   for i, rows in enumerate(self._row_maps)})
        for i, child in enumerate(self._shards):
            child.save(os.path.join(directory, f"shard{i}"))

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "ShardedIndex":
        self = cls(n_shards=meta["n_shards"], partition=meta["partition"],
                   child_spec=meta["child_spec"], metric=meta["metric"],
                   device=device)
        arrays = _load_arrays(directory)
        n_built = int(meta["built_shards"])
        self._row_maps = [np.asarray(arrays[f"rows{i}"], np.int32)
                          for i in range(n_built)]
        self._shards = [load_index(os.path.join(directory, f"shard{i}"),
                                   device)
                        for i in range(n_built)]
        self._ntotal = int(meta["ntotal"])
        self._dim = int(meta["dim"])
        self._upload_row_maps()
        return self
