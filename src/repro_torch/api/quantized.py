"""Quantized ``VectorIndex`` tiers: SQ8 and PQ codes, flat or IVF.

The port of the reference's ``api/quantized.py``. Every class stores codes
instead of float32 vectors (uint8 tensors on ``device``) and searches them
asymmetrically (exact float32 query against the quantized corpus):

=============  =======================================  ==================
factory stage  class                                    bytes / vector
=============  =======================================  ==================
``SQ8``        :class:`SQ8Index` (flat dequant-free)    d + 4
``PQ{m}x{b}``  :class:`PQIndex` (``pq_adc`` kernel)     m
``IVF{c},SQ8`` :class:`IVFSQ8Index` (probe + SQ8)       d + 8
``IVF{c},PQ…`` :class:`IVFPQIndex` (probe + LUT ADC)    m + 4
=============  =======================================  ==================

All compose with a reducer through ``TwoStageIndex``:
``"RAE64,PQ8x8,Rerank4"`` scans 8-byte codes with the hand-written
``pq_adc`` kernel on the card and reranks exactly in the full space.
Persistence is the reference's layout (``meta.json`` + ``arrays.npz``,
codes as uint8), and ``fingerprint()`` hashes the reference's state, so
either package loads what the other saved.

Tombstones (``alive``): the flat scans have no mask operand, so they
over-fetch ``k + n_dead`` rows and drop the dead ones
(:func:`_drop_tombstones`); the IVF probes fold ``alive`` into the list
mask. Both as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..kernels.pq_adc import pq_adc
from ..search import ivf as ivf_lib
from ..search import quantize as qz
from .index import (SearchParams, SearchResult, VectorIndex, _load_arrays,
                    _numpy, _pad_result, _probed_sizes, _save_dir, _timed,
                    alive_tensor, register_index)
from .reducer import as_device_tensor


def _drop_tombstones(vals: torch.Tensor, idx: torch.Tensor,
                     alive: torch.Tensor, k_req: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Strip tombstoned ids out of an over-fetched top-k: survivors shift
    left in their order (a stable sort on "dead?") and the tail pads with
    ``(-inf, -1)``."""
    idx = idx.long()
    keep = (idx >= 0) & alive[torch.where(idx >= 0, idx, 0)]
    order = torch.sort((~keep).to(torch.uint8), dim=1,
                       stable=True).indices[:, :k_req]
    kept = torch.gather(keep, 1, order)
    out_v = torch.where(kept, torch.gather(vals, 1, order),
                        torch.full_like(vals[:, :k_req], float("-inf")))
    out_i = torch.where(kept, torch.gather(idx, 1, order),
                        torch.full_like(order, -1))
    return out_v, out_i.to(torch.int32)


def _fold_alive_into_lists(lists: torch.Tensor, mask: torch.Tensor,
                           alive: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """A dead row's list slot is masked AND its id nulled to -1: the probe
    scans keep real ids on masked slots (at -inf), which could surface when
    a probe holds fewer than k alive members."""
    mask = mask & alive[torch.where(lists >= 0, lists, 0).long()]
    return torch.where(mask, lists, torch.full_like(lists, -1)), mask


def _flat_search(index: VectorIndex, queries, k: int, alive,
                 scan) -> SearchResult:
    """A flat code scan, ``scan(q, k) -> (vals, ids)``, timed; with
    ``alive`` it over-fetches ``k + n_dead`` rows and drops the dead."""
    index._require_built()
    q = as_device_tensor(queries, index.device)
    k_eff = min(k, index.ntotal)
    stats = {"distance_evals": float(index.ntotal)}
    if alive is None:
        return _timed(lambda: scan(q, k_eff), index.device, stats=stats)
    al = alive_tensor(alive, index.device)
    k_fetch = min(index.ntotal, k_eff + int((~al).sum()))
    return _timed(lambda: _drop_tombstones(*scan(q, k_fetch), al, k_eff),
                  index.device, stats=stats)


# ---------------------------------------------------------------------------
# SQ8 flat
# ---------------------------------------------------------------------------
@register_index("sq8_flat")
class SQ8Index(VectorIndex):
    """Flat exact-order scan over SQ8 codes (4x smaller than float32):
    uint8 codes + per-row ``|x_hat|^2``, searched without decoding."""

    # SQ8 ordering is near-exact; a light oversample under a rerank
    # recovers the borderline swaps
    stage1_oversample = 2

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self._sq: Optional[qz.ScalarQuantizer] = None
        self._codes: Optional[torch.Tensor] = None
        self._recon_sq: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        return 0 if self._codes is None else int(self._codes.shape[0])

    @property
    def built(self) -> bool:
        return self._codes is not None

    @property
    def bytes_per_vector(self) -> float:
        """uint8 per dim + f32 reconstruction norm."""
        self._require_built()
        return float(self._codes.shape[1] + 4)

    @property
    def dim(self) -> int:
        self._require_built()
        return int(self._codes.shape[1])

    def _fingerprint_state(self) -> list:
        return [self._sq.vmin, self._sq.step, self._codes]

    def build(self, corpus) -> "SQ8Index":
        corpus = as_device_tensor(corpus, self.device)
        self._sq = qz.sq8_train(corpus)
        self._codes = qz.sq8_encode(self._sq, corpus)
        self._recon_sq = qz.sq8_recon_sq_norms(self._sq, self._codes)
        return self

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        del params  # a flat code scan has no knobs: every row is scored
        sq = self._sq
        return _flat_search(self, queries, k, alive, lambda q, kk: (
            qz.sq8_scan(sq.vmin, sq.step, q, self._codes, self._recon_sq, kk)))

    def save(self, directory: str) -> None:
        self._require_built()
        _save_dir(directory, {"kind": self.kind}, {
            "vmin": _numpy(self._sq.vmin), "step": _numpy(self._sq.step),
            "codes": _numpy(self._codes),
            "recon_sq": _numpy(self._recon_sq)})

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "SQ8Index":
        a = _load_arrays(directory)
        self = cls(device=device)
        dev = self.device
        self._sq = qz.ScalarQuantizer(
            vmin=torch.as_tensor(a["vmin"], device=dev),
            step=torch.as_tensor(a["step"], device=dev))
        self._codes = torch.as_tensor(a["codes"], device=dev)
        self._recon_sq = torch.as_tensor(a["recon_sq"], device=dev)
        return self


# ---------------------------------------------------------------------------
# PQ flat
# ---------------------------------------------------------------------------
@register_index("pq_flat")
class PQIndex(VectorIndex):
    """Flat ADC scan over PQ codes through the ``pq_adc`` op (the
    hand-written kernel on the card). ``m`` bytes per vector: 32x smaller
    than float32 at d = 8m."""

    # ADC ordering is noisy at PQ rates: over-fetch and let the exact
    # rerank sort it out
    stage1_oversample = 8

    def __init__(self, m: int = 8, bits: int = 8, kmeans_iters: int = 15,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.m = m
        self.bits = bits
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.device = torch.device(device)
        self._pq: Optional[qz.ProductQuantizer] = None
        self._codes: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        return 0 if self._codes is None else int(self._codes.shape[0])

    @property
    def built(self) -> bool:
        return self._codes is not None

    @property
    def bytes_per_vector(self) -> float:
        return float(qz.bytes_per_code(self.m, self.bits))

    @property
    def dim(self) -> int:
        self._require_built()
        return self._pq.m * self._pq.dsub

    def _fingerprint_state(self) -> list:
        return [self._pq.codebooks, self._codes]

    def build(self, corpus) -> "PQIndex":
        corpus = as_device_tensor(corpus, self.device)
        self._pq = qz.pq_train(corpus, self.m, self.bits,
                               iters=self.kmeans_iters, seed=self.seed)
        self._codes = qz.pq_encode(self._pq, corpus)
        return self

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        del params  # a flat ADC scan has no knobs: every row is scored
        return _flat_search(self, queries, k, alive, lambda q, kk: pq_adc(
            q, self._pq.codebooks, self._codes, kk))

    def save(self, directory: str) -> None:
        self._require_built()
        _save_dir(directory, {"kind": self.kind, "m": self.m,
                              "bits": self.bits,
                              "kmeans_iters": self.kmeans_iters,
                              "seed": self.seed},
                  {"codebooks": _numpy(self._pq.codebooks),
                   "codes": _numpy(self._codes)})

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "PQIndex":
        a = _load_arrays(directory)
        self = cls(m=meta["m"], bits=meta["bits"],
                   kmeans_iters=meta["kmeans_iters"], seed=meta["seed"],
                   device=device)
        self._pq = qz.ProductQuantizer(
            codebooks=torch.as_tensor(a["codebooks"], device=self.device))
        self._codes = torch.as_tensor(a["codes"], device=self.device)
        return self


# ---------------------------------------------------------------------------
# IVF + quantized list payloads (shared coarse layer)
# ---------------------------------------------------------------------------
class _IVFQuantBase(VectorIndex):
    """Shared coarse layer: k-means cells from ``search.ivf`` whose padded
    dense lists store codes instead of float32 vectors."""

    def __init__(self, n_cells: int = 256, nprobe: int = 0,
                 cell_cap: Optional[int] = None, kmeans_iters: int = 10,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.n_cells = n_cells
        # ADC scans are cheap: probe 2x the IVF-flat share by default
        self.nprobe = nprobe or max(8, n_cells // 8)
        self.cell_cap = cell_cap
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.device = torch.device(device)
        self._centroids: Optional[torch.Tensor] = None
        self._lists: Optional[torch.Tensor] = None
        self._mask: Optional[torch.Tensor] = None
        self._cell_sizes: Optional[np.ndarray] = None  # fixed at build
        self._ntotal = 0
        self.spill = 0

    @property
    def ntotal(self) -> int:
        return self._ntotal

    @property
    def built(self) -> bool:
        return self._lists is not None

    @property
    def dim(self) -> int:
        self._require_built()
        return int(self._centroids.shape[1])

    def _build_coarse(self, corpus: torch.Tensor) -> ivf_lib.IVFIndex:
        n_cells = min(self.n_cells, corpus.shape[0])
        coarse = ivf_lib.build(corpus, n_cells, cell_cap=self.cell_cap,
                               kmeans_iters=self.kmeans_iters, seed=self.seed)
        self._centroids = coarse.centroids
        self._lists = coarse.lists
        self._mask = coarse.list_mask
        self._cell_sizes = _numpy(coarse.list_mask).sum(axis=1)
        self._ntotal = int(corpus.shape[0])
        self.spill = int(coarse.spill)
        return coarse

    def _fingerprint_state(self) -> list:
        # the coarse layer; subclasses append their code payloads
        return [f"nprobe={self.nprobe}", self._centroids, self._lists]

    def set_params(self, params: SearchParams) -> None:
        """Adopt a tuned ``nprobe`` default (fingerprint state)."""
        if params.nprobe is not None:
            self.nprobe = params.nprobe

    def _probe_budget(self, k: int, params: Optional[SearchParams] = None
                      ) -> tuple[int, int, int]:
        """(k requested, k servable by the probe scan, nprobe);
        ``params.nprobe`` overrides ``self.nprobe`` for this call."""
        nprobe = (self.nprobe if params is None or params.nprobe is None
                  else params.nprobe)
        nprobe = min(nprobe, int(self._centroids.shape[0]))
        k_req = min(k, self.ntotal)
        k_eff = min(k_req, nprobe * int(self._lists.shape[1]))
        return k_req, k_eff, nprobe

    def _probe_stats(self, queries: torch.Tensor,
                     nprobe: int) -> dict[str, float]:
        return {"distance_evals": _probed_sizes(_numpy(queries),
                                                _numpy(self._centroids),
                                                self._cell_sizes, nprobe),
                "centroid_evals": float(self._centroids.shape[0])}

    def _lists_for(self, alive) -> tuple[torch.Tensor, torch.Tensor]:
        if alive is None:
            return self._lists, self._mask
        return _fold_alive_into_lists(self._lists, self._mask,
                                      alive_tensor(alive, self.device))

    def _search(self, queries, k: int, alive, params, scan) -> SearchResult:
        """Run ``scan(q, lists, mask, k_eff, nprobe)`` and pad to k."""
        self._require_built()
        q = as_device_tensor(queries, self.device)
        k_req, k_eff, nprobe = self._probe_budget(k, params)
        lists, mask = self._lists_for(alive)
        return _timed(lambda: _pad_result(*scan(q, lists, mask, k_eff,
                                                nprobe), k_req),
                      self.device, stats=self._probe_stats(q, nprobe))

    def _coarse_meta(self) -> dict[str, Any]:
        return {"kind": self.kind, "n_cells": self.n_cells,
                "nprobe": self.nprobe, "kmeans_iters": self.kmeans_iters,
                "seed": self.seed, "ntotal": self._ntotal,
                "spill": self.spill}

    def _coarse_arrays(self) -> dict[str, np.ndarray]:
        return {"centroids": _numpy(self._centroids),
                "lists": _numpy(self._lists), "mask": _numpy(self._mask)}

    def _load_coarse(self, meta: dict[str, Any],
                     a: dict[str, np.ndarray]) -> None:
        dev = self.device
        self._centroids = torch.as_tensor(a["centroids"], device=dev)
        self._lists = torch.as_tensor(a["lists"], device=dev)
        self._mask = torch.as_tensor(a["mask"], device=dev)
        self._cell_sizes = a["mask"].sum(axis=1)
        self._ntotal = int(meta["ntotal"])
        self.spill = int(meta.get("spill", 0))


@register_index("ivf_sq8")
class IVFSQ8Index(_IVFQuantBase):
    """IVF cells whose lists hold SQ8 codes: probe ``nprobe`` cells, scan
    their codes without decoding. Short results pad with ``(-inf, -1)``."""

    stage1_oversample = 2  # the near-exact ordering of SQ8Index

    def __init__(self, n_cells: int = 256, nprobe: int = 0,
                 cell_cap: Optional[int] = None, kmeans_iters: int = 10,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__(n_cells, nprobe, cell_cap, kmeans_iters, seed,
                         device)
        self._sq: Optional[qz.ScalarQuantizer] = None
        self._codes: Optional[torch.Tensor] = None      # [C, cap, d] uint8
        self._recon_sq: Optional[torch.Tensor] = None   # [C, cap]

    @property
    def bytes_per_vector(self) -> float:
        """uint8 per dim + f32 recon norm + int32 row id."""
        self._require_built()
        return float(self._codes.shape[2] + 4 + 4)

    def _fingerprint_state(self) -> list:
        return super()._fingerprint_state() + [self._sq.vmin, self._sq.step,
                                               self._codes]

    def build(self, corpus) -> "IVFSQ8Index":
        corpus = as_device_tensor(corpus, self.device)
        coarse = self._build_coarse(corpus)
        self._sq = qz.sq8_train(corpus)
        c, cap, d = coarse.list_vecs.shape
        flat = qz.sq8_encode(self._sq, coarse.list_vecs.reshape(c * cap, d))
        self._codes = flat.reshape(c, cap, d)
        self._recon_sq = qz.sq8_recon_sq_norms(self._sq, flat).reshape(c, cap)
        return self

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        def scan(q, lists, mask, k_eff, nprobe):
            return qz.ivf_sq8_search(self._centroids, lists, self._codes,
                                     self._recon_sq, mask, self._sq.vmin,
                                     self._sq.step, q, k_eff, nprobe)

        return self._search(queries, k, alive, params, scan)

    def save(self, directory: str) -> None:
        self._require_built()
        arrays = self._coarse_arrays()
        arrays.update({"vmin": _numpy(self._sq.vmin),
                       "step": _numpy(self._sq.step),
                       "codes": _numpy(self._codes),
                       "recon_sq": _numpy(self._recon_sq)})
        _save_dir(directory, self._coarse_meta(), arrays)

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "IVFSQ8Index":
        a = _load_arrays(directory)
        self = cls(n_cells=meta["n_cells"], nprobe=meta["nprobe"],
                   kmeans_iters=meta["kmeans_iters"], seed=meta["seed"],
                   device=device)
        self._load_coarse(meta, a)
        dev = self.device
        self._sq = qz.ScalarQuantizer(
            vmin=torch.as_tensor(a["vmin"], device=dev),
            step=torch.as_tensor(a["step"], device=dev))
        self._codes = torch.as_tensor(a["codes"], device=dev)
        self._recon_sq = torch.as_tensor(a["recon_sq"], device=dev)
        return self


@register_index("ivf_pq")
class IVFPQIndex(_IVFQuantBase):
    """IVF cells whose lists hold PQ codes, scanned with a per-query ADC
    LUT (FAISS ``IVFx,PQy``). The codebooks are trained on the raw corpus,
    not residuals: one LUT per query instead of one per probed cell."""

    stage1_oversample = 8  # the ADC ordering noise of PQIndex

    def __init__(self, n_cells: int = 256, m: int = 8, bits: int = 8,
                 nprobe: int = 0, cell_cap: Optional[int] = None,
                 kmeans_iters: int = 10, pq_iters: int = 15, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__(n_cells, nprobe, cell_cap, kmeans_iters, seed,
                         device)
        self.m = m
        self.bits = bits
        self.pq_iters = pq_iters
        self._pq: Optional[qz.ProductQuantizer] = None
        self._codes: Optional[torch.Tensor] = None      # [C, cap, m] uint8

    @property
    def bytes_per_vector(self) -> float:
        """Code + int32 row id."""
        return float(qz.bytes_per_code(self.m, self.bits) + 4)

    def _fingerprint_state(self) -> list:
        return super()._fingerprint_state() + [self._pq.codebooks,
                                               self._codes]

    def build(self, corpus) -> "IVFPQIndex":
        corpus = as_device_tensor(corpus, self.device)
        coarse = self._build_coarse(corpus)
        self._pq = qz.pq_train(corpus, self.m, self.bits,
                               iters=self.pq_iters, seed=self.seed)
        c, cap, d = coarse.list_vecs.shape
        flat = qz.pq_encode(self._pq, coarse.list_vecs.reshape(c * cap, d))
        self._codes = flat.reshape(c, cap, self.m)
        return self

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        def scan(q, lists, mask, k_eff, nprobe):
            return qz.ivf_pq_search(self._centroids, lists, self._codes,
                                    mask, self._pq.codebooks, q, k_eff,
                                    nprobe)

        return self._search(queries, k, alive, params, scan)

    def save(self, directory: str) -> None:
        self._require_built()
        arrays = self._coarse_arrays()
        arrays.update({"codebooks": _numpy(self._pq.codebooks),
                       "codes": _numpy(self._codes)})
        meta = self._coarse_meta()
        meta.update({"m": self.m, "bits": self.bits,
                     "pq_iters": self.pq_iters})
        _save_dir(directory, meta, arrays)

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "IVFPQIndex":
        a = _load_arrays(directory)
        self = cls(n_cells=meta["n_cells"], m=meta["m"], bits=meta["bits"],
                   nprobe=meta["nprobe"], kmeans_iters=meta["kmeans_iters"],
                   pq_iters=meta["pq_iters"], seed=meta["seed"],
                   device=device)
        self._load_coarse(meta, a)
        self._pq = qz.ProductQuantizer(
            codebooks=torch.as_tensor(a["codebooks"], device=self.device))
        self._codes = torch.as_tensor(a["codes"], device=self.device)
        return self
