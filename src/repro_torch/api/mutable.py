"""``MutableIndex``: streaming inserts + tombstone deletes over any tier.

The port of the reference's ``api/mutable.py`` (factory prefix ``Mut``,
e.g. ``"Mut,RAE64,IVF256,Rerank4"``). Every other ``VectorIndex`` is
write-once: ``build`` then ``search``. This wrapper owns the mutation
state (the appended corpus, the tombstone mask, a monotonically bumped
**mutation epoch**) and pushes each mutation down the wrapped stack by the
cheapest mechanism the tier supports:

* **insert**: tiers with an ``add`` method take rows incrementally (HNSW
  runs the Alg. 1 insert against the live graph, re-packs and re-uploads;
  IVF appends to the nearest centroid's list; Flat concatenates; TwoStage
  encodes once and recurses); anything else is rebuilt over the extended
  corpus. Either way the new rows answer the moment ``add`` returns.
* **delete**: rows are never removed on the query path. ``delete`` flips
  bits in the ``alive`` mask, which ``search`` threads down every tier into
  the kernels' ``db_mask`` operand (or the IVF list masks), so a
  tombstoned row never surfaces, not even as a pre-rerank candidate. The
  mask is kept on the index's device too, refreshed by every mutation, so
  a search over a mutated index uploads nothing a clean one does not. When
  the HNSW entry point is tombstoned the entry is reassigned to the highest
  alive node.
* **rebuild**: compacts tombstones away and re-clusters / re-packs from
  scratch. Triggered explicitly, by IVF cell imbalance after appends, or by
  the RAE drift monitor (:class:`repro_torch.core.theory.DriftTracker`),
  which forces a reducer **retrain** once the violation rate of the Eq. 15
  band says the live distribution left the fitted manifold. Reducer and
  index swap together.

**Row ids are stable for life.** ``add`` returns monotonically assigned
external ids; ``search`` results and ``delete`` arguments speak those ids,
and a compacting ``rebuild`` remaps internals without changing them. A
compaction keeps the alive rows in external-id order, and the IVF probes
break score ties by row (``search/ivf.py:topk_by_score_then_id``), so tied
rows keep their order across a rebuild too.

**Every mutation bumps the epoch**, and the epoch is fingerprint state
(with the alive mask, the id map and the inner fingerprint), so a cache
keyed on the fingerprint never replays a pre-mutation answer.

``_corpus`` is a host copy of every row (the reference's), re-concatenated
on each ``add``; it feeds rebuilds. Persistence is the reference's layout
(``meta.json`` + ``arrays.npz`` with ``corpus``/``alive``/``row_ids``, the
wrapped stack under ``inner/``), so either package loads the other's
directory with the same fingerprint.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from ..core import rae as rae_lib
from ..core.theory import DriftTracker
from ..search import hnsw as hnsw_lib
from .graph import HNSWIndex
from .index import (SearchResult, VectorIndex, _load_arrays, _save_dir,
                    load_index, register_index)
from .reducer import as_device_tensor


@register_index("mutable")
class MutableIndex(VectorIndex):
    """Wrap a built (or buildable) index stack with add/delete/rebuild."""

    #: Attributes the fingerprint leaves out, and why (the reference's
    #: list; its fingerprint lint is not part of the port).
    _fp_exempt = {
        "_corpus": "row content is hashed via the inner index fingerprint "
                   "(rows are inserted into the inner tier verbatim); the "
                   "host copy only feeds rebuilds",
        "_next_id": "derived: _row_ids.max()+1, and _row_ids is hashed",
        "imbalance_trigger": "rebuild policy knob: a triggered rebuild "
                             "reshapes the hashed inner fingerprint and "
                             "bumps the hashed epoch",
        "drift_tol": "drift policy knob; same argument as "
                     "imbalance_trigger",
        "drift_threshold": "drift policy knob; same argument as "
                           "imbalance_trigger",
        "_drift": "monitoring state; changes answers only through a "
                  "rebuild, which bumps the hashed epoch",
        "n_added": "host-side telemetry; the hashed epoch advances with "
                   "every counted mutation",
        "n_deleted": "host-side telemetry; same as n_added",
        "n_rebuilds": "host-side telemetry; same as n_added",
        "n_reducer_retrains": "host-side telemetry; same as n_added",
        "_alive_dev": "derived: the device copy of the hashed _alive",
        "_n_alive": "derived: _alive.sum()",
        "device": "placement, not content",
    }

    def __init__(self, inner: VectorIndex, imbalance_trigger: float = 4.0,
                 drift_tol: float = 0.25, drift_threshold: float = 0.10):
        self._inner = inner
        self.imbalance_trigger = imbalance_trigger
        self.drift_tol = drift_tol
        self.drift_threshold = drift_threshold
        self.device = torch.device(getattr(inner, "device", "cuda"))
        self._corpus: Optional[np.ndarray] = None
        self._alive: Optional[np.ndarray] = None
        self._alive_dev: Optional[torch.Tensor] = None
        self._n_alive = 0
        self._row_ids: Optional[np.ndarray] = None
        self._next_id = 0
        self._epoch = 0
        self._drift: Optional[DriftTracker] = None
        self.n_added = 0
        self.n_deleted = 0
        self.n_rebuilds = 0
        self.n_reducer_retrains = 0

    # -- identity ----------------------------------------------------------
    @property
    def ntotal(self) -> int:
        """Alive rows: the logical corpus size (tombstoned rows still
        occupy inner slots until a rebuild compacts them)."""
        return self._n_alive

    @property
    def built(self) -> bool:
        return self._corpus is not None and self._inner.built

    @property
    def bytes_per_vector(self) -> float:
        return self._inner.bytes_per_vector

    @property
    def dim(self) -> int:
        return self._inner.dim

    @property
    def epoch(self) -> int:
        """Mutation counter: bumps on every add/delete/rebuild."""
        return self._epoch

    @property
    def stage1_oversample(self) -> int:
        return getattr(self._inner, "stage1_oversample", 1)

    def _fingerprint_state(self) -> list:
        # the epoch makes every mutation a new identity; alive + row_ids
        # pin the tombstone set and the external id mapping; the inner
        # fingerprint pins the searched content
        return [f"epoch={self._epoch}", self._inner.fingerprint(),
                self._alive, self._row_ids]

    def mutation_stats(self) -> dict[str, float]:
        """Host-side mutation telemetry."""
        out = {"epoch": float(self._epoch), "added": float(self.n_added),
               "deleted": float(self.n_deleted),
               "rebuilds": float(self.n_rebuilds),
               "reducer_retrains": float(self.n_reducer_retrains),
               "tombstones": 0.0 if self._alive is None
               else float((~self._alive).sum())}
        if self._drift is not None:
            out["drift_violation_rate"] = self._drift.violation_rate
        return out

    def _refresh_alive(self) -> None:
        """Derive the alive count and the mask's device copy from the host
        mask, once a mutation (not once a search)."""
        self._n_alive = int(self._alive.sum())
        self._alive_dev = torch.as_tensor(self._alive, device=self.device)

    # -- drift monitor -----------------------------------------------------
    def _reducer(self):
        return getattr(self._inner, "reducer", None)

    def _arm_drift(self) -> None:
        """(Re)build the Eq. 15 monitor from the fitted reducer's encoder
        weights; reducers without a weight matrix (or no reducer at all)
        leave drift tracking off."""
        self._drift = None
        r = self._reducer()
        params = getattr(r, "params_", None)
        if params is not None and "w_e" in params:
            self._drift = DriftTracker.from_weights(
                rae_lib.encoder_matrix(params), tol=self.drift_tol,
                threshold=self.drift_threshold)

    def _graph_index(self) -> Optional[HNSWIndex]:
        obj: Any = self._inner
        while obj is not None:
            if isinstance(obj, HNSWIndex):
                return obj
            obj = getattr(obj, "base", None)
        return None

    def _imbalance(self) -> float:
        obj: Any = self._inner
        while obj is not None:
            fn = getattr(obj, "cell_imbalance", None)
            if fn is not None:
                return float(fn())
            obj = getattr(obj, "base", None)
        return 1.0

    # -- lifecycle ---------------------------------------------------------
    def build(self, corpus) -> "MutableIndex":
        if isinstance(corpus, torch.Tensor):
            corpus = corpus.detach().cpu().numpy()
        corpus = np.asarray(corpus, np.float32)
        self._inner.build(corpus)
        return self._adopt(corpus)

    def _adopt(self, corpus: np.ndarray) -> "MutableIndex":
        """Take ``corpus`` as the rows of the inner stack, which is already
        built over them: the mutation state ``build`` sets up after
        building the inner stack (external ids 0..N-1, all alive, epoch
        0)."""
        corpus = np.asarray(corpus, np.float32)
        self._corpus = corpus.copy()
        self._alive = np.ones(corpus.shape[0], bool)
        self._row_ids = np.arange(corpus.shape[0], dtype=np.int64)
        self._next_id = int(corpus.shape[0])
        self._epoch = 0
        self._refresh_alive()
        self._arm_drift()
        return self

    def add(self, vecs) -> np.ndarray:
        """Insert rows; returns their external ids. New rows answer the
        very next ``search``. May trigger a synchronous rebuild (IVF
        imbalance / reducer drift). The drift monitor gets the rows' norms
        taken on the device, not the encoded rows."""
        self._require_built()
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.detach().cpu().numpy()
        nv = np.atleast_2d(np.asarray(vecs, np.float32))
        if nv.shape[1] != self._corpus.shape[1]:
            raise ValueError(f"add: dim {nv.shape[1]} != index dim "
                             f"{self._corpus.shape[1]}")
        ext = np.arange(self._next_id, self._next_id + nv.shape[0],
                        dtype=np.int64)
        self._next_id += int(nv.shape[0])
        self._corpus = np.concatenate([self._corpus, nv])
        self._alive = np.concatenate(
            [self._alive, np.ones(nv.shape[0], bool)])
        self._row_ids = np.concatenate([self._row_ids, ext])
        nv_dev = as_device_tensor(nv, self.device)
        r = self._reducer()
        if self._drift is not None and r is not None:
            self._drift.observe(nv_dev, r.transform(nv_dev))
        if hasattr(self._inner, "add"):
            self._inner.add(nv_dev)
        else:
            # no incremental path (sharded / quantized tiers without a
            # reducer): rebuild the inner structure over the full slab;
            # tombstones stay masked, ids stay positional
            self._inner.build(self._corpus)
        self._refresh_alive()
        self._epoch += 1
        self.n_added += int(nv.shape[0])
        if self._drift is not None and self._drift.should_retrain:
            self.rebuild(refit_reducer=True)
        elif self._imbalance() > self.imbalance_trigger:
            self.rebuild()
        return ext

    def delete(self, ids) -> int:
        """Tombstone external ids; returns how many were newly deleted
        (re-deleting is a no-op, unknown ids raise). The rows stop
        surfacing immediately; no rebuild on the delete path."""
        self._require_built()
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size == 0:
            return 0
        pos = np.searchsorted(self._row_ids, ids)
        bad = (pos >= self._row_ids.shape[0]) \
            | (self._row_ids[np.minimum(pos, self._row_ids.shape[0] - 1)]
               != ids)
        if bad.any():
            raise KeyError(f"delete: unknown ids {ids[bad][:8].tolist()}")
        newly = int(self._alive[pos].sum())
        if newly == 0:
            return 0
        self._alive[pos] = False
        self._refresh_alive()
        self._epoch += 1
        self.n_deleted += newly
        g = self._graph_index()
        if g is not None and self._alive.any() \
                and not self._alive[g._g.entry]:
            # the beam must start somewhere alive; pick the highest alive
            # node so upper-layer routing keeps working
            hnsw_lib.reassign_entry(g._g, self._alive)
        return newly

    def rebuild(self, refit_reducer: bool = False) -> "MutableIndex":
        """Compact tombstones away and rebuild the inner stack from
        scratch over only the alive rows, kept in external-id order.
        ``refit_reducer=True`` also retrains the reducer on the compacted
        corpus (the drift-retrain path); reducer and index swap together.
        External ids survive the remap."""
        self._require_built()
        keep = np.flatnonzero(self._alive)
        self._corpus = np.ascontiguousarray(self._corpus[keep])
        self._row_ids = np.ascontiguousarray(self._row_ids[keep])
        self._alive = np.ones(keep.shape[0], bool)
        r = self._reducer()
        if refit_reducer and r is not None and hasattr(r, "params_"):
            r.params_ = None  # TwoStageIndex.build refits unfitted reducers
            self.n_reducer_retrains += 1
        self._inner.build(self._corpus)
        self._refresh_alive()
        self._arm_drift()
        self._epoch += 1
        self.n_rebuilds += 1
        return self

    # -- search ------------------------------------------------------------
    def set_params(self, params) -> None:
        """Forward a tuned operating point to the wrapped tier (its knobs
        are its fingerprint state, and the mutable fingerprint composes
        over the inner one)."""
        self._require_built()
        self._inner.set_params(params)

    def search(self, queries, k: int, alive=None,
               params=None) -> SearchResult:
        self._require_built()
        if alive is not None:
            raise ValueError("MutableIndex owns the tombstone mask; "
                             "callers never pass alive")
        q = queries if isinstance(queries, torch.Tensor) \
            else np.atleast_2d(np.asarray(queries, np.float32))
        if self._n_alive == 0:
            return SearchResult(
                scores=np.full((q.shape[0], 0), -np.inf, np.float32),
                indices=np.full((q.shape[0], 0), -1, np.int64),
                latency_s=0.0, stats={"distance_evals": 0.0})
        # alive=None keeps the inner tiers on their static paths
        mask = None if self._n_alive == self._alive.shape[0] \
            else self._alive_dev
        r = self._inner.search(q, min(k, self._n_alive), alive=mask,
                               params=params)
        idx = np.asarray(r.indices)
        safe = np.clip(idx, 0, self._row_ids.shape[0] - 1)
        ext = np.where(idx >= 0, self._row_ids[safe], -1)
        return SearchResult(scores=np.asarray(r.scores), indices=ext,
                            latency_s=r.latency_s, stats=dict(r.stats))

    # -- persistence -------------------------------------------------------
    def save(self, directory: str) -> None:
        self._require_built()
        meta = {"kind": self.kind, "epoch": self._epoch,
                "next_id": self._next_id,
                "imbalance_trigger": self.imbalance_trigger,
                "drift_tol": self.drift_tol,
                "drift_threshold": self.drift_threshold,
                "n_added": self.n_added, "n_deleted": self.n_deleted,
                "n_rebuilds": self.n_rebuilds,
                "n_reducer_retrains": self.n_reducer_retrains}
        _save_dir(directory, meta,
                  {"corpus": self._corpus, "alive": self._alive,
                   "row_ids": self._row_ids})
        self._inner.save(os.path.join(directory, "inner"))

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "MutableIndex":
        inner = load_index(os.path.join(directory, "inner"), device)
        self = cls(inner,
                   imbalance_trigger=float(meta["imbalance_trigger"]),
                   drift_tol=float(meta["drift_tol"]),
                   drift_threshold=float(meta["drift_threshold"]))
        a = _load_arrays(directory)
        self._corpus = np.asarray(a["corpus"], np.float32)
        self._alive = np.asarray(a["alive"], bool)
        self._row_ids = np.asarray(a["row_ids"], np.int64)
        self._epoch = int(meta["epoch"])
        self._next_id = int(meta["next_id"])
        self.n_added = int(meta.get("n_added", 0))
        self.n_deleted = int(meta.get("n_deleted", 0))
        self.n_rebuilds = int(meta.get("n_rebuilds", 0))
        self.n_reducer_retrains = int(meta.get("n_reducer_retrains", 0))
        self._refresh_alive()
        self._arm_drift()
        return self
