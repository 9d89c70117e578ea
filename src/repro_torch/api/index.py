"""``VectorIndex``: one build/search/save/load interface for the search tiers.

``FlatIndex`` is the exact scan (``search.distributed``: the ``l2_topk``
kernel on the card), ``IVFFlatIndex`` the k-means cells + probe scan
(``search.ivf``), and ``TwoStageIndex`` composes a
:class:`~repro_torch.api.reducer.Reducer` with a base index: reduced-space
candidate generation, full-space rerank (the paper's deployment stack).
The HNSW tier lives in ``api/graph.py``, the sharded tier in
``api/sharded.py``, the quantized tiers in ``api/quantized.py`` and the
live-mutation wrapper in ``api/mutable.py``.

Indexes keep their vectors on ``device`` (default ``"cuda"``). ``search``
takes numpy arrays or tensors and returns a :class:`SearchResult` of
numpy arrays with device-synchronized wall latency. Scores follow the
engine convention: higher = closer.

Persistence layout is the reference's (``meta.json`` + ``arrays.npz`` per
directory, ``TwoStageIndex`` nesting ``reducer/`` and ``base/``), so
``load_index`` reads what either package saved.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..search import distributed as ds
from ..search import ivf as ivf_lib
from ..search import twostage as ts_lib
from .reducer import Reducer, as_device_tensor, load_reducer

_META = "meta.json"
_ARRAYS = "arrays.npz"


#: Geometric ladder every per-call knob snaps to — each rung ~1.5x the
#: previous (8*2^i interleaved with 12*2^i), as in the reference, so a
#: tuned operating point means the same knob values in both packages.
KNOB_LADDER = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
               768, 1024, 1536, 2048)


def snap_knob(value: int) -> int:
    """Round ``value`` UP to its :data:`KNOB_LADDER` rung (a snapped knob
    always does at least the work asked for); past the top rung, clamp."""
    v = int(value)
    for rung in KNOB_LADDER:
        if rung >= v:
            return rung
    return KNOB_LADDER[-1]


def next_rung(value: int) -> int:
    """The ladder rung strictly above ``value``'s — the escalation step.
    The top rung escalates to itself."""
    snapped = snap_knob(value)
    i = KNOB_LADDER.index(snapped)
    return KNOB_LADDER[min(i + 1, len(KNOB_LADDER) - 1)]


@dataclass(frozen=True)
class SearchParams:
    """Per-call search-knob overrides (``params=`` of every ``search``).
    ``None`` leaves a knob at the index's default; each tier consumes the
    knobs it understands and forwards the rest down its stack. Values snap
    UP to :data:`KNOB_LADDER` at construction."""

    ef_search: Optional[int] = None
    nprobe: Optional[int] = None
    rerank_k1: Optional[int] = None

    def __post_init__(self):
        for name in ("ef_search", "nprobe", "rerank_k1"):
            v = getattr(self, name)
            if v is None:
                continue
            if int(v) < 1:
                raise ValueError(f"SearchParams.{name} must be >= 1, "
                                 f"got {v}")
            object.__setattr__(self, name, snap_knob(v))

    def key(self) -> tuple:
        """Hashable operating-point token (cache keys, curve JSON)."""
        return (self.ef_search, self.nprobe, self.rerank_k1)

    def merged(self, override: "SearchParams") -> "SearchParams":
        """This point with ``override``'s set knobs winning."""
        return SearchParams(
            ef_search=override.ef_search if override.ef_search is not None
            else self.ef_search,
            nprobe=override.nprobe if override.nprobe is not None
            else self.nprobe,
            rerank_k1=override.rerank_k1 if override.rerank_k1 is not None
            else self.rerank_k1)

    def escalated(self) -> "SearchParams":
        """One ladder rung up on every set knob — the pass-2 point of
        per-query escalation. Unset knobs stay unset."""
        return SearchParams(
            ef_search=None if self.ef_search is None
            else next_rung(self.ef_search),
            nprobe=None if self.nprobe is None else next_rung(self.nprobe),
            rerank_k1=None if self.rerank_k1 is None
            else next_rung(self.rerank_k1))

    def to_dict(self) -> dict[str, Optional[int]]:
        return {"ef_search": self.ef_search, "nprobe": self.nprobe,
                "rerank_k1": self.rerank_k1}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SearchParams":
        return cls(ef_search=d.get("ef_search"), nprobe=d.get("nprobe"),
                   rerank_k1=d.get("rerank_k1"))


@dataclass
class SearchResult:
    """Uniform k-NN result: ``scores``/``indices`` are [Q, k] numpy arrays;
    higher score = closer; ``latency_s`` is device-synchronized wall time.
    ``stats["distance_evals"]`` is the mean number of corpus vectors scored
    per query."""

    scores: np.ndarray
    indices: np.ndarray
    latency_s: float
    stats: dict[str, float] = field(default_factory=dict)

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    @property
    def distance_evals(self) -> Optional[float]:
        """Mean distance evaluations per query (None if not reported)."""
        return self.stats.get("distance_evals")


# ---------------------------------------------------------------------------
# Registry / persistence plumbing
# ---------------------------------------------------------------------------
_INDEXES: dict[str, type] = {}


def register_index(name: str):
    def deco(cls):
        _INDEXES[name.lower()] = cls
        cls.kind = name.lower()
        return cls

    return deco


def load_index(directory: str, device: str | torch.device = "cuda"
               ) -> "VectorIndex":
    with open(os.path.join(directory, _META)) as f:
        meta = json.load(f)
    try:
        cls = _INDEXES[meta["kind"]]
    except KeyError:
        raise KeyError(f"unknown index kind {meta['kind']!r}; "
                       f"known: {sorted(_INDEXES)}") from None
    return cls._load(directory, meta, device)


def _save_dir(directory: str, meta: dict[str, Any],
              arrays: dict[str, np.ndarray]) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, _META), "w") as f:
        json.dump(meta, f, indent=1)
    np.savez(os.path.join(directory, _ARRAYS), **arrays)


def _load_arrays(directory: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(directory, _ARRAYS)) as z:
        return {k: z[k] for k in z.files}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def alive_tensor(alive, device: torch.device) -> torch.Tensor:
    """A tombstone mask as a bool tensor on ``device``: a host mask is
    uploaded; a tensor already there is used as it is (a mask kept on the
    card costs no copy a search)."""
    if isinstance(alive, torch.Tensor):
        return alive.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(alive, bool), device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class VectorIndex:
    """Base class: ``build(corpus)`` then ``search(queries, k)``."""

    kind: str = "abstract"

    #: Multiple of the rerank budget to fetch when serving as stage 1
    #: under a rerank (lossy-ranking tiers override it).
    stage1_oversample: int = 1

    @property
    def ntotal(self) -> int:
        raise NotImplementedError

    @property
    def built(self) -> bool:
        raise NotImplementedError

    @property
    def bytes_per_vector(self) -> float:
        raise NotImplementedError

    @property
    def dim(self) -> int:
        raise NotImplementedError

    def _fingerprint_state(self) -> list:
        raise NotImplementedError

    def fingerprint(self) -> str:
        """Stable content hash of the built index; the same bytes as the
        reference's for the same state."""
        self._require_built()
        h = hashlib.sha1()
        h.update(f"{self.kind}:{self.ntotal}".encode())
        for item in self._fingerprint_state():
            if isinstance(item, str):
                h.update(item.encode())
            else:
                a = _numpy(item)
                h.update(f"{a.shape}:{a.dtype}".encode())
                h.update(a.tobytes())
        return h.hexdigest()[:16]

    def build(self, corpus) -> "VectorIndex":
        raise NotImplementedError

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        """k-NN. ``alive`` (bool [ntotal], optional) tombstones rows: a
        dead row never appears in the result, its slot padding to
        (NEG_INF, -1). ``params`` overrides the tier's knobs for this call
        only."""
        raise NotImplementedError

    def set_params(self, params: SearchParams) -> None:
        """Apply ``params``'s set knobs as this index's new defaults."""
        del params

    def save(self, directory: str) -> None:
        raise NotImplementedError

    def _require_built(self):
        if not self.built:
            raise RuntimeError(f"{self.kind}: search before build")


def _pad_result(v: torch.Tensor, i: torch.Tensor, k_req: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """FAISS pad convention when fewer than k candidates exist: tail rows
    get score -inf / index -1. Shared by every tier that can come up
    short (IVF probes)."""
    pad = k_req - v.shape[1]
    if pad <= 0:
        return v, i
    v = torch.cat([v, torch.full((v.shape[0], pad), float("-inf"),
                                 dtype=v.dtype, device=v.device)], 1)
    i = torch.cat([i, torch.full((i.shape[0], pad), -1, dtype=i.dtype,
                                 device=i.device)], 1)
    return v, i


def _probed_sizes(queries: np.ndarray, centroids: np.ndarray,
                  cell_sizes: np.ndarray, nprobe: int) -> float:
    """Mean members the probe scan evaluates per query — the IVF
    ``distance_evals`` stat. The reference's host computation, line for
    line (numpy, Q x C), so the stat is the reference's number; the
    centroid scan is reported separately as ``centroid_evals``."""
    q = np.asarray(queries, np.float32)
    c = np.asarray(centroids, np.float32)
    d2 = (np.sum(q * q, 1)[:, None] - 2.0 * q @ c.T
          + np.sum(c * c, 1)[None, :])
    p = min(nprobe, c.shape[0])
    cells = np.argpartition(d2, p - 1, axis=1)[:, :p]
    return float(cell_sizes[cells].sum(axis=1).mean())


def _timed(fn: Callable[[], tuple[torch.Tensor, torch.Tensor]],
           device: torch.device,
           stats: Optional[dict[str, float]] = None) -> SearchResult:
    """Wall time of the query, read after ``torch.cuda.synchronize`` —
    otherwise the clock measures the enqueue, not the scan."""
    _sync(device)
    t0 = time.perf_counter()
    scores, idx = fn()
    _sync(device)
    dt = time.perf_counter() - t0
    return SearchResult(scores=_numpy(scores), indices=_numpy(idx),
                        latency_s=dt, stats=dict(stats or {}))


# ---------------------------------------------------------------------------
# Flat (exact scan)
# ---------------------------------------------------------------------------
@register_index("flat")
class FlatIndex(VectorIndex):
    """Exact k-NN over the stored corpus: on the card, one ``l2_topk``
    kernel call per search."""

    def __init__(self, metric: str = "euclidean",
                 device: str | torch.device = "cuda"):
        self.metric = metric
        self.device = torch.device(device)
        self._db: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        return 0 if self._db is None else int(self._db.shape[0])

    @property
    def built(self) -> bool:
        return self._db is not None

    @property
    def bytes_per_vector(self) -> float:
        self._require_built()
        return float(self._db.shape[1] * self._db.element_size())

    @property
    def dim(self) -> int:
        self._require_built()
        return int(self._db.shape[1])

    def _fingerprint_state(self) -> list:
        return [self.metric, self._db]

    def build(self, corpus) -> "FlatIndex":
        self._db = as_device_tensor(corpus, self.device).contiguous()
        return self

    def add(self, vecs) -> None:
        """Streaming insert: append rows; existing rows keep their ids."""
        self._require_built()
        self._db = torch.cat([self._db, as_device_tensor(vecs, self.device)])

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        del params  # exact scan has no knobs: every row is always scored
        self._require_built()
        q = as_device_tensor(queries, self.device)
        al = None if alive is None else alive_tensor(alive, self.device)
        return _timed(lambda: ds.search(q, self._db, min(k, self.ntotal),
                                        metric=self.metric, alive=al),
                      self.device,
                      stats={"distance_evals": float(self.ntotal)})

    def save(self, directory: str) -> None:
        self._require_built()
        _save_dir(directory, {"kind": self.kind, "metric": self.metric},
                  {"db": _numpy(self._db)})

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "FlatIndex":
        self = cls(metric=meta["metric"], device=device)
        self._db = torch.as_tensor(_load_arrays(directory)["db"],
                                   device=self.device)
        return self


# ---------------------------------------------------------------------------
# IVF-Flat (coarse quantization)
# ---------------------------------------------------------------------------
@register_index("ivf_flat")
class IVFFlatIndex(VectorIndex):
    """k-means cells + padded-dense probe scan (``search.ivf``) on
    ``device``. Euclidean only (scores = negative squared distance).
    ``nprobe`` defaults to n_cells/16 (min 8)."""

    def __init__(self, n_cells: int = 256, nprobe: int = 0,
                 cell_cap: Optional[int] = None, kmeans_iters: int = 10,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.n_cells = n_cells
        self.nprobe = nprobe or max(8, n_cells // 16)
        self.cell_cap = cell_cap
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.device = torch.device(device)
        self._ivf: Optional[ivf_lib.IVFIndex] = None
        self._cell_sizes: Optional[np.ndarray] = None  # fixed at build
        self._ntotal = 0

    @property
    def ntotal(self) -> int:
        return self._ntotal

    @property
    def built(self) -> bool:
        return self._ivf is not None

    @property
    def bytes_per_vector(self) -> float:
        """f32 list vector + int32 row id."""
        self._require_built()
        return float(self._ivf.list_vecs.shape[2] * 4 + 4)

    @property
    def dim(self) -> int:
        self._require_built()
        return int(self._ivf.centroids.shape[1])

    def _fingerprint_state(self) -> list:
        return [f"nprobe={self.nprobe}", self._ivf.centroids,
                self._ivf.lists, self._ivf.list_vecs]

    def build(self, corpus) -> "IVFFlatIndex":
        corpus = as_device_tensor(corpus, self.device)
        n_cells = min(self.n_cells, corpus.shape[0])
        self._ivf = ivf_lib.build(corpus, n_cells, cell_cap=self.cell_cap,
                                  kmeans_iters=self.kmeans_iters,
                                  seed=self.seed)
        self._cell_sizes = _numpy(self._ivf.list_mask).sum(axis=1)
        self._ntotal = int(corpus.shape[0])
        return self

    def add(self, vecs) -> None:
        """Streaming insert: assign each new row to its nearest centroid
        and append into that cell's padded list (centroids stay fixed;
        :meth:`cell_imbalance` exposes the skew). Touched cells are
        re-packed prefix-dense; list capacity grows when a cell fills.
        The reference's host code, line for line in numpy, then the lists
        go back to ``device``."""
        self._require_built()
        nv = np.asarray(_numpy(vecs), np.float32)
        cent = _numpy(self._ivf.centroids).astype(np.float32)
        d2 = (np.sum(nv * nv, 1)[:, None] - 2.0 * nv @ cent.T
              + np.sum(cent * cent, 1)[None, :])
        cells = np.argmin(d2, axis=1)
        lists = _numpy(self._ivf.lists).copy()
        mask = _numpy(self._ivf.list_mask).copy()
        lvecs = _numpy(self._ivf.list_vecs).copy()
        need = mask.sum(axis=1)
        np.add.at(need, cells, 1)
        cap = lists.shape[1]
        new_cap = int(max(cap, need.max()))
        if new_cap > cap:
            pad = new_cap - cap
            lists = np.pad(lists, ((0, 0), (0, pad)), constant_values=-1)
            mask = np.pad(mask, ((0, 0), (0, pad)))
            lvecs = np.pad(lvecs, ((0, 0), (0, pad), (0, 0)))
        new_ids = np.arange(self._ntotal, self._ntotal + nv.shape[0],
                            dtype=lists.dtype)
        for c in np.unique(cells):
            sel = cells == c
            old = mask[c]
            ids = np.concatenate([lists[c][old], new_ids[sel]])
            vv = np.concatenate([lvecs[c][old], nv[sel]])
            lists[c] = -1
            mask[c] = False
            lvecs[c, : len(ids)] = vv
            lists[c, : len(ids)] = ids
            mask[c, : len(ids)] = True
        dev = self.device
        self._ivf = ivf_lib.IVFIndex(
            centroids=self._ivf.centroids,
            lists=torch.as_tensor(lists, device=dev),
            list_vecs=torch.as_tensor(lvecs, device=dev),
            list_mask=torch.as_tensor(mask, device=dev),
            spill=self._ivf.spill)
        self._cell_sizes = mask.sum(axis=1)
        self._ntotal += int(nv.shape[0])

    def cell_imbalance(self) -> float:
        """Largest cell over the mean cell size (1.0 = balanced)."""
        self._require_built()
        sizes = np.asarray(self._cell_sizes, np.float64)
        return float(sizes.max() / max(sizes.mean(), 1e-12))

    def set_params(self, params: SearchParams) -> None:
        """Adopt a tuned ``nprobe`` default (fingerprint state)."""
        if params.nprobe is not None:
            self.nprobe = params.nprobe

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        """Like FAISS, a query whose probed cells hold fewer than k members
        pads the tail with index -1 / score -inf. ``alive`` folds into the
        list mask (ids nulled too), so a tombstoned row can neither score
        nor surface. ``params.nprobe`` overrides ``self.nprobe`` for this
        call."""
        self._require_built()
        q = as_device_tensor(queries, self.device)
        nprobe = (self.nprobe if params is None or params.nprobe is None
                  else params.nprobe)
        nprobe = min(nprobe, int(self._ivf.centroids.shape[0]))
        k_req = min(k, self.ntotal)
        # the probe scan can surface at most nprobe * cell_cap rows
        k_eff = min(k_req, nprobe * int(self._ivf.lists.shape[1]))
        index = self._ivf
        if alive is not None:
            lists = index.lists
            al = alive_tensor(alive, self.device)
            mask = index.list_mask & al[torch.where(lists >= 0, lists,
                                                    0).long()]
            index = dataclasses.replace(
                index, lists=torch.where(mask, lists,
                                         torch.full_like(lists, -1)),
                list_mask=mask)

        def run():
            v, i = ivf_lib.search(index, q, k_eff, nprobe=nprobe)
            return _pad_result(v, i, k_req)

        return _timed(run, self.device, stats={
            "distance_evals": _probed_sizes(_numpy(q),
                                            _numpy(self._ivf.centroids),
                                            self._cell_sizes, nprobe),
            "centroid_evals": float(self._ivf.centroids.shape[0]),
        })

    def save(self, directory: str) -> None:
        self._require_built()
        meta = {"kind": self.kind, "n_cells": self.n_cells,
                "nprobe": self.nprobe, "kmeans_iters": self.kmeans_iters,
                "seed": self.seed, "ntotal": self._ntotal,
                "spill": int(self._ivf.spill)}
        _save_dir(directory, meta, {
            "centroids": _numpy(self._ivf.centroids),
            "lists": _numpy(self._ivf.lists),
            "list_vecs": _numpy(self._ivf.list_vecs),
            "list_mask": _numpy(self._ivf.list_mask),
        })

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "IVFFlatIndex":
        self = cls(n_cells=meta["n_cells"], nprobe=meta["nprobe"],
                   kmeans_iters=meta["kmeans_iters"], seed=meta["seed"],
                   device=device)
        a = _load_arrays(directory)
        dev = self.device
        self._ivf = ivf_lib.IVFIndex(
            centroids=torch.as_tensor(a["centroids"], device=dev),
            lists=torch.as_tensor(a["lists"], device=dev),
            list_vecs=torch.as_tensor(a["list_vecs"], device=dev),
            list_mask=torch.as_tensor(a["list_mask"], device=dev),
            spill=int(meta.get("spill", 0)))
        self._cell_sizes = a["list_mask"].sum(axis=1)
        self._ntotal = int(meta["ntotal"])
        return self


# ---------------------------------------------------------------------------
# TwoStage: reducer -> base index -> full-space rerank
# ---------------------------------------------------------------------------
@register_index("two_stage")
class TwoStageIndex(VectorIndex):
    """Compose a reducer with a base index.

    ``build`` fits the reducer on the corpus (skipped if already fitted),
    encodes the corpus into R^m and builds the base index over the REDUCED
    vectors. ``search`` encodes the queries, fetches ``k * rerank_factor *
    base.stage1_oversample`` candidates (or ``rerank_k1``) from the base
    index, and reranks them with exact distances in the ORIGINAL space."""

    def __init__(self, reducer: Reducer, base_index: VectorIndex,
                 rerank_factor: int = 4, metric: str = "euclidean",
                 rerank_k1: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        self.reducer = reducer
        self.base = base_index
        self.rerank_factor = rerank_factor
        self.metric = metric
        # tuned absolute stage-1 budget; None = k * rerank_factor * oversample
        self.rerank_k1 = None if rerank_k1 is None else snap_knob(rerank_k1)
        self.device = torch.device(device)
        self._db_full: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        return 0 if self._db_full is None else int(self._db_full.shape[0])

    @property
    def built(self) -> bool:
        return self._db_full is not None and self.base.built

    @property
    def bytes_per_vector(self) -> float:
        """Stage-1 payload only (the paper's deployment split)."""
        return self.base.bytes_per_vector

    @property
    def dim(self) -> int:
        """Queries arrive in the ORIGINAL space (the reducer encodes them)."""
        self._require_built()
        return int(self._db_full.shape[1])

    def _fingerprint_state(self) -> list:
        return [f"rerank={self.rerank_factor}:{self.rerank_k1}:{self.metric}",
                f"reducer={self.reducer.fingerprint()}",
                self.base.fingerprint(), self._db_full]

    def build(self, corpus) -> "TwoStageIndex":
        if not self.reducer.fitted:
            self.reducer.fit(_numpy(corpus).astype(np.float32, copy=False))
        full = as_device_tensor(corpus, self.device).contiguous()
        self.base.build(self.reducer.transform(full))
        self._db_full = full
        return self

    def add(self, vecs) -> None:
        """Streaming insert: encode the new rows once and push them down
        the stack (incrementally when the base has ``add``: HNSW graph
        insert, IVF cell append, flat concat; else by rebuilding the base
        over the extended reduced corpus), then extend the full-space
        rerank store. The reducer is not refit here: drift policy belongs
        to ``MutableIndex``."""
        self._require_built()
        nv = as_device_tensor(vecs, self.device)
        full = torch.cat([self._db_full, nv])
        if hasattr(self.base, "add"):
            self.base.add(self.reducer.transform(nv))
        else:
            self.base.build(self.reducer.transform(full))
        self._db_full = full

    def set_params(self, params: SearchParams) -> None:
        """Adopt a tuned stage-1 budget and forward the rest down the
        stack (``rerank_k1`` is fingerprint state)."""
        if params.rerank_k1 is not None:
            self.rerank_k1 = params.rerank_k1
        self.base.set_params(params)

    def stage1_k(self, k: int, params: Optional[SearchParams] = None) -> int:
        """Candidates stage 1 fetches for a top-``k`` search: an explicit
        (tuned / per-call) k1 beats the oversample formula; never below
        ``min(k, ntotal)``, never above ``ntotal``."""
        k_eff = min(k, self.ntotal)
        pk1 = (self.rerank_k1 if params is None or params.rerank_k1 is None
               else params.rerank_k1)
        if pk1 is not None:
            return min(max(int(pk1), k_eff), self.ntotal)
        return min(k_eff * self.rerank_factor * self.base.stage1_oversample,
                   self.ntotal)

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        self._require_built()
        _sync(self.device)
        t0 = time.perf_counter()
        q = as_device_tensor(queries, self.device)
        zq = self.reducer.transform(q)
        k1 = self.stage1_k(k, params)
        # tombstones are enforced in stage 1, so the rerank can't resurface
        # a deleted row
        stage1 = self.base.search(zq, k1, alive=alive, params=params)
        cand = torch.as_tensor(stage1.indices, device=self.device)
        scores, idx = ts_lib.rerank_candidates(
            q, self._db_full, cand, min(k, self.ntotal), self.metric)
        _sync(self.device)
        dt = time.perf_counter() - t0
        s1_evals = stage1.stats.get("distance_evals", 0.0)
        stats = dict(stage1.stats)
        stats.update({"distance_evals": s1_evals + float(k1),
                      "stage1_distance_evals": s1_evals,
                      "rerank_evals": float(k1)})
        return SearchResult(scores=_numpy(scores), indices=_numpy(idx),
                            latency_s=dt, stats=stats)

    def save(self, directory: str) -> None:
        self._require_built()
        _save_dir(directory, {"kind": self.kind,
                              "rerank_factor": self.rerank_factor,
                              "rerank_k1": self.rerank_k1,
                              "metric": self.metric},
                  {"db_full": _numpy(self._db_full)})
        self.reducer.save(os.path.join(directory, "reducer"))
        self.base.save(os.path.join(directory, "base"))

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "TwoStageIndex":
        reducer = load_reducer(os.path.join(directory, "reducer"), device)
        base = load_index(os.path.join(directory, "base"), device)
        self = cls(reducer, base, rerank_factor=meta["rerank_factor"],
                   metric=meta["metric"], rerank_k1=meta.get("rerank_k1"),
                   device=device)
        self._db_full = torch.as_tensor(_load_arrays(directory)["db_full"],
                                        device=self.device)
        return self
