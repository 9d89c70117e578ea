"""Offline recall-SLO autotuner: sweep the knob ladder, fit the Pareto
operating curve, persist it keyed by index fingerprint.

Given a built index and held-out queries with exact ground truth:

1. :func:`candidate_params` walks the index stack and enumerates
   :class:`~repro_torch.api.index.SearchParams` along the
   :data:`~repro_torch.api.index.KNOB_LADDER` for the knobs that stack
   has: IVF stage 1 sweeps ``nprobe``; HNSW under a rerank sweeps
   ``ef_search`` and ``rerank_k1`` together.
2. :func:`sweep` measures each candidate (recall@k against the exact
   ground truth, mean ``distance_evals`` from ``SearchResult.stats``, QPS
   from the host clock around a ``search`` that ends in a device sync)
   and keeps the Pareto front: recall strictly increasing with cost.
3. The resulting :class:`OperatingCurve` maps a recall SLO to the
   cheapest operating point (:meth:`OperatingCurve.select`);
   :func:`save_curve` / :func:`load_curve` persist it as JSON keyed by
   ``index.fingerprint()``. The JSON is the reference's (version 1), so
   each package reads the other's curves.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..api.index import KNOB_LADDER, SearchParams, VectorIndex, snap_knob
from ..core.metrics import recall_at_k

_CURVE_VERSION = 1


@dataclass(frozen=True)
class OperatingPoint:
    """One measured (knobs -> quality/cost) sample on the curve."""

    params: SearchParams
    recall: float
    distance_evals: float
    qps: float

    def to_dict(self) -> dict:
        return {"params": self.params.to_dict(), "recall": self.recall,
                "distance_evals": self.distance_evals, "qps": self.qps}

    @classmethod
    def from_dict(cls, d: dict) -> "OperatingPoint":
        return cls(params=SearchParams.from_dict(d["params"]),
                   recall=float(d["recall"]),
                   distance_evals=float(d["distance_evals"]),
                   qps=float(d["qps"]))


@dataclass(frozen=True)
class OperatingCurve:
    """Pareto front of measured operating points, cheapest first.

    ``fingerprint`` pins the curve to the index build it was measured on;
    ``k`` to the result size. The serving engine refuses a curve whose
    fingerprint does not match its live index."""

    points: tuple[OperatingPoint, ...]
    fingerprint: str
    k: int

    def select(self, target_recall: float,
               slack: float = 0.0) -> OperatingPoint:
        """Cheapest point whose measured recall covers ``target_recall +
        slack``; the most accurate point when none does (best effort)."""
        if not self.points:
            raise ValueError("empty operating curve")
        want = target_recall + slack
        for p in self.points:
            if p.recall >= want:
                return p
        return self.points[-1]

    def to_dict(self) -> dict:
        return {"version": _CURVE_VERSION, "fingerprint": self.fingerprint,
                "k": self.k, "points": [p.to_dict() for p in self.points]}

    @classmethod
    def from_dict(cls, d: dict) -> "OperatingCurve":
        return cls(points=tuple(OperatingPoint.from_dict(p)
                                for p in d["points"]),
                   fingerprint=str(d["fingerprint"]), k=int(d["k"]))


def pareto(points: Sequence[OperatingPoint]) -> tuple[OperatingPoint, ...]:
    """Cost-sorted Pareto front: walking up the cost axis, keep a point
    only if it strictly improves recall."""
    front: list[OperatingPoint] = []
    for p in sorted(points, key=lambda p: (p.distance_evals, -p.recall)):
        if not front or p.recall > front[-1].recall:
            front.append(p)
    return tuple(front)


def _stage1(index: VectorIndex) -> VectorIndex:
    """The knob-bearing stage-1 tier of a stack: unwrap Mutable
    (``_inner``), TwoStage (``base``) and Sharded (shard 0; shards are
    homogeneous by construction)."""
    seen = 0
    while seen < 8:
        seen += 1
        if hasattr(index, "_inner"):           # MutableIndex
            index = index._inner
        elif hasattr(index, "rerank_factor"):  # TwoStageIndex
            index = index.base
        elif hasattr(index, "_shards"):        # ShardedIndex
            index = index._shards[0]
        else:
            return index
    return index


def candidate_params(index: VectorIndex, k: int,
                     max_rung: int = 512) -> list[SearchParams]:
    """Ladder-walk candidates for the knobs this stack has.

    * IVF-family stage 1 (has ``nprobe``): ``nprobe`` over the rungs up to
      the cell count.
    * HNSW stage 1: ``ef_search`` from ``snap(max(k, 8))`` up to
      ``max_rung``; under a rerank ``rerank_k1`` is tied to the same rung
      (the beam width is ``max(ef, k1)``).
    * Knob-free stacks (flat / flat-quantized): the single default point.
    """
    s1 = _stage1(index)
    reranked = hasattr(index, "rerank_factor") or (
        hasattr(index, "_inner") and hasattr(index._inner, "rerank_factor"))
    if hasattr(s1, "nprobe"):
        n_cells = max(1, getattr(s1, "n_cells", KNOB_LADDER[-1]))
        rungs = [r for r in KNOB_LADDER if r <= n_cells] or [KNOB_LADDER[0]]
        return [SearchParams(nprobe=r) for r in rungs if r <= max_rung]
    if hasattr(s1, "ef_search"):
        lo = snap_knob(max(k, 8))
        rungs = [r for r in KNOB_LADDER if lo <= r <= max_rung]
        if reranked:
            return [SearchParams(ef_search=r, rerank_k1=r) for r in rungs]
        return [SearchParams(ef_search=r) for r in rungs]
    return [SearchParams()]


def sweep(index: VectorIndex, queries: np.ndarray,
          ground_truth: np.ndarray, k: int,
          candidates: Optional[Sequence[SearchParams]] = None
          ) -> OperatingCurve:
    """Measure every candidate on held-out ``queries`` against exact
    ``ground_truth`` ids ([Q, >= k]) and return the Pareto operating curve.

    Each candidate runs twice: a one-query call that pays the rung's
    first-use costs, then a timed call that supplies recall, mean
    ``distance_evals`` and QPS (``search`` ends in a device sync, so the
    clock covers the work)."""
    if candidates is None:
        candidates = candidate_params(index, k)
    gt = np.asarray(ground_truth)[:, :k]
    measured = []
    for params in candidates:
        index.search(queries[:1], k, params=params)  # warm this rung
        t0 = time.perf_counter()
        r = index.search(queries, k, params=params)
        dt = time.perf_counter() - t0
        measured.append(OperatingPoint(
            params=params,
            recall=recall_at_k(r.indices[:, :k], gt),
            distance_evals=float(r.stats.get("distance_evals", 0.0)),
            qps=float(queries.shape[0] / max(dt, 1e-9))))
    return OperatingCurve(points=pareto(measured),
                          fingerprint=index.fingerprint(), k=k)


def save_curve(curve: OperatingCurve, path: str) -> None:
    """Persist as JSON; the conventional name is
    ``curve_<fingerprint>_k<k>.json`` (:func:`curve_path`)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(curve.to_dict(), f, indent=1)


def load_curve(path: str,
               index: Optional[VectorIndex] = None) -> OperatingCurve:
    """Load a persisted curve; with ``index`` given, refuse one measured on
    a different build."""
    with open(path) as f:
        curve = OperatingCurve.from_dict(json.load(f))
    if index is not None:
        fp = index.fingerprint()
        if curve.fingerprint != fp:
            raise ValueError(
                f"operating curve was tuned for fingerprint "
                f"{curve.fingerprint}, live index is {fp} — re-run "
                f"repro_torch.tune.sweep on this build")
    return curve


def curve_path(directory: str, fingerprint: str, k: int) -> str:
    """The conventional on-disk location for a build's tuned curve."""
    return os.path.join(directory, f"curve_{fingerprint}_k{k}.json")
