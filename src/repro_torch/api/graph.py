"""Graph ``VectorIndex`` tier: HNSW beam search behind the factory.

The port of the reference's ``api/graph.py``::

    index_factory("HNSW32")                  # graph over the raw space
    index_factory("RAE64,HNSW32,Rerank4")    # graph over the reduced space,
                                             # exact full-space rerank

``build`` runs the sequential heuristic insert on the host
(:func:`repro_torch.search.hnsw.build`, numpy, bitwise the reference's
graph) and uploads the packed adjacency to ``device``. ``search`` routes
queries to one of two engines:

* the batched traversal (:func:`~repro_torch.search.hnsw.search_batched`),
  on ``device``: on the card one launch of the traversal kernel for the
  whole batch (a block a query, the beam and the visited bits in shared
  memory, no host sync until the answer), on the CPU one ``graph_beam``
  hop a step for the whole batch;
* the sequential heapq beam (:func:`~repro_torch.search.hnsw.search`), on
  the host.

Routing is a decision of the port. On a CUDA index ``batched="auto"``
sends every batch through the device traversal, q=1 included (the
reference's ``batched=True``): the reference's rule sends q=1 to the host
engine, which on the card would be a host path inside a CUDA index. On a
CPU index ``"auto"`` follows the reference's rule (q=1 host, q>1 batched).
``batched=True/False`` pin either engine.

Under a rerank the graph declares ``stage1_oversample=2``, as the
reference does. ``frontier`` is the reference's knob of its host
frontier driver, which the port does not have; it is kept because the
fingerprint and the saved ``meta.json`` carry it. ``add`` inserts rows
into the live graph on the host and re-uploads it (the reference's
``insert_batch``).

**Quantized payloads** (``quant="sq8"`` / ``"pq"``; the factory's
``"RAE64,HNSW32,SQ8,Rerank4"``): the graph is built in float32 as usual,
then a code payload (:func:`~repro_torch.search.hnsw.make_graph_codes`) is
trained over the same corpus on ``device`` and attached, and every step of
the traversal gathers codes through the ``graph_beam_q`` hop. A PQ graph
inherits the PQ codec's ``stage1_oversample = 8``. Every query, q=1
included, takes the batched engine on either device: the heapq engine
scores float32 and would answer differently alone than in a batch.

Persistence is the reference's layout (``meta.json`` + ``arrays.npz``:
vectors, levels, every layer's adjacency, the packed norms, the
``codec_*`` arrays), so either package loads what the other saved.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Union

import numpy as np
import torch

from ..search import hnsw as hnsw_lib
from .index import (SearchParams, SearchResult, VectorIndex, _load_arrays,
                    _numpy, _save_dir, _sync, register_index)


@register_index("hnsw")
class HNSWIndex(VectorIndex):
    """Hierarchical navigable small-world graph (euclidean only)."""

    stage1_oversample = 2

    def __init__(self, m: int = 32, ef_construction: int = 100,
                 ef_search: int = 64, seed: int = 0,
                 batched: Union[str, bool] = "auto", frontier: int = 8,
                 quant: Optional[str] = None, pq_m: int = 8,
                 pq_bits: int = 8, kmeans_iters: int = 15,
                 device: str | torch.device = "cuda"):
        if m < 2:
            raise ValueError(f"HNSW needs M >= 2, got {m}")
        if batched not in ("auto", True, False):
            raise ValueError(f"batched must be 'auto', True or False, "
                             f"got {batched!r}")
        if frontier < 1:
            raise ValueError(f"frontier must be >= 1, got {frontier}")
        if quant not in (None, "sq8", "pq"):
            raise ValueError(f"quant must be None, 'sq8' or 'pq', "
                             f"got {quant!r}")
        if quant == "pq":
            if pq_m < 1:
                raise ValueError(f"PQ needs at least one subspace, "
                                 f"got pq_m={pq_m}")
            if not 1 <= pq_bits <= 8:
                raise ValueError(f"PQ bits must be in 1..8, got {pq_bits}")
            # ADC hops miss more boundary neighbours than SQ8: the PQ
            # codec's wider oversample (the class keeps 2)
            self.stage1_oversample = 8
        self.m = m
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.seed = seed
        self.batched = batched
        self.frontier = frontier
        self.quant = quant
        self.pq_m = pq_m
        self.pq_bits = pq_bits
        self.kmeans_iters = kmeans_iters
        self.device = torch.device(device)
        self._g: Optional[hnsw_lib.HNSWGraph] = None
        #: host seconds of the last ``add``: insert, then re-pack + upload
        self.add_times: dict[str, float] = {}

    @property
    def ntotal(self) -> int:
        return 0 if self._g is None else self._g.ntotal

    @property
    def built(self) -> bool:
        return self._g is not None

    @property
    def bytes_per_vector(self) -> float:
        """f32 vector + int32 link slots in every layer the node occupies
        (2M at layer 0, M per upper layer, averaged over the levels) +
        int32 level, + the code row and its f32 bias when quantized."""
        self._require_built()
        g = self._g
        upper_slots = g.M * float(g.levels.mean())
        codec = 0.0 if g.codec is None else float(g.codec.gather_bytes)
        return float(g.vecs.shape[1] * 4
                     + 4 * (g.links0.shape[1] + upper_slots) + 4 + codec)

    @property
    def dim(self) -> int:
        self._require_built()
        return int(self._g.vecs.shape[1])

    def _fingerprint_state(self) -> list:
        # the reference's state, byte for byte: vectors, every layer's
        # adjacency, levels, and the query-time knobs that change answers
        g = self._g
        state = [f"ef={self.ef_search}:entry={g.entry}"
                 f":batched={self.batched}:frontier={self.frontier}"
                 f":quant={self.quant}",
                 g.vecs, g.links0, g.links, g.levels]
        if g.codec is not None:
            # the code payload answers differently: it is identity too
            c = g.codec
            state += [c.codes, c.node_bias]
            state += [a for a in (c.vmin, c.step, c.codebooks)
                      if a is not None]
        return state

    def build(self, corpus) -> "HNSWIndex":
        self._g = hnsw_lib.build(corpus, M=self.m,
                                 ef_construction=self.ef_construction,
                                 seed=self.seed)
        if self.quant is not None:
            # the graph is built in float32; the payload swaps what the
            # hop gathers (a codec that cannot train raises here)
            self._g.codec = hnsw_lib.make_graph_codes(
                self._g.vecs, self.quant, m=self.pq_m, bits=self.pq_bits,
                iters=self.kmeans_iters, seed=self.seed, device=self.device)
        if self.batched is not False or self.quant is not None:
            self._upload()
        return self

    def _upload(self) -> None:
        """Pack the graph and put it (and its codes) on the device once,
        at build/load and after an ``add``."""
        self._g.pack().device_arrays(self._g.vecs, self.device)
        if self._g.codec is not None:
            self._g.codec.device_arrays(self.device)

    def _use_batched(self, nq: int) -> bool:
        if self.quant is not None:
            # codes exist only on the batched path: a lone query on the
            # float32 heapq engine would answer unlike its batch
            return True
        if self.batched == "auto":
            return self.device.type == "cuda" or nq > 1
        return bool(self.batched)

    def add(self, vecs) -> np.ndarray:
        """Incremental insert: run HNSW Alg. 1 for each new row against the
        live graph on the host (:func:`~repro_torch.search.hnsw.
        insert_batch`, the same code path as ``build``), extend the code
        payload with the already-trained codec, then re-pack and re-upload
        the graph (and its codes) so the next search sees the new rows.
        Returns the new row ids; ``add_times`` holds the host seconds of
        the insert and of the re-pack + upload."""
        self._require_built()
        t0 = time.perf_counter()
        ids = hnsw_lib.insert_batch(self._g, _numpy(vecs),
                                    ef_construction=self.ef_construction,
                                    seed=self.seed, device=self.device)
        t1 = time.perf_counter()
        if self.batched is not False or self.quant is not None:
            self._upload()
            _sync(self.device)
        self.add_times = {"insert_s": t1 - t0,
                          "upload_s": time.perf_counter() - t1}
        return ids

    def set_params(self, params: SearchParams) -> None:
        """Adopt a tuned ``ef_search`` default (fingerprint state)."""
        if params.ef_search is not None:
            self.ef_search = params.ef_search

    def search(self, queries, k: int, alive=None,
               params: Optional[SearchParams] = None) -> SearchResult:
        """Beam search with ef = max(ef_search, k). Queries whose beam
        holds fewer than k nodes pad the tail with index -1 / score -inf.
        ``alive`` (bool [ntotal]) tombstones rows out of both engines; the
        entry point must be alive. ``params.ef_search`` overrides
        ``self.ef_search`` for this call."""
        self._require_built()
        nq = int(queries.shape[0])
        k_req = min(k, self.ntotal)
        ef_base = (self.ef_search if params is None or params.ef_search is None
                   else params.ef_search)
        ef = max(ef_base, k_req)
        _sync(self.device)
        t0 = time.perf_counter()
        if self._use_batched(nq):
            scores, idx, evals, hops = hnsw_lib.search_batched(
                self._g, queries, k_req, ef_search=ef, alive=alive,
                device=self.device)
            scores, idx, evals = _numpy(scores), _numpy(idx), _numpy(evals)
            g = self._g
            row_bytes = (g.codec.gather_bytes if g.codec is not None
                         else 4 * g.vecs.shape[1] + 4)
            stats = {"distance_evals": float(evals.mean()),
                     "beam_hops": float(hops),
                     # the payload row + bias gathered per eval, over the
                     # hops: the bandwidth axis of the graph gates
                     "gather_bytes_per_hop":
                         float(evals.sum() * row_bytes) / max(hops, 1)}
        else:
            scores, idx, evals = hnsw_lib.search(
                self._g, np.asarray(_numpy(queries), np.float32), k_req,
                ef_search=ef,
                alive=None if alive is None else _numpy(alive))
            stats = {"distance_evals": float(evals.mean())}
        dt = time.perf_counter() - t0
        return SearchResult(scores=scores, indices=idx, latency_s=dt,
                            stats=stats)

    def save(self, directory: str) -> None:
        self._require_built()
        g = self._g
        p = g.pack()  # the packed norms ride along, as in the reference
        arrays = {"vecs": g.vecs, "levels": g.levels, "links0": g.links0,
                  "links": g.links, "packed_vecs_sq": p.vecs_sq}
        if g.codec is not None:
            # the trained codec rides along: a reload serves codes without
            # training again
            arrays["codec_codes"] = g.codec.codes
            arrays["codec_node_bias"] = g.codec.node_bias
            if g.codec.kind == "sq8":
                arrays["codec_vmin"] = g.codec.vmin
                arrays["codec_step"] = g.codec.step
            else:
                arrays["codec_codebooks"] = g.codec.codebooks
        _save_dir(directory,
                  {"kind": self.kind, "m": self.m,
                   "ef_construction": self.ef_construction,
                   "ef_search": self.ef_search, "seed": self.seed,
                   "entry": int(g.entry), "packed": True,
                   "batched": self.batched, "frontier": self.frontier,
                   "quant": self.quant, "pq_m": self.pq_m,
                   "pq_bits": self.pq_bits,
                   "kmeans_iters": self.kmeans_iters}, arrays)

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "HNSWIndex":
        self = cls(m=meta["m"], ef_construction=meta["ef_construction"],
                   ef_search=meta["ef_search"], seed=meta["seed"],
                   batched=meta.get("batched", "auto"),
                   frontier=int(meta.get("frontier", 8)),
                   quant=meta.get("quant"), pq_m=int(meta.get("pq_m", 8)),
                   pq_bits=int(meta.get("pq_bits", 8)),
                   kmeans_iters=int(meta.get("kmeans_iters", 15)),
                   device=device)
        a = _load_arrays(directory)
        links = a["links"]
        if links.size == 0:  # single-layer graph round-trips as [0, N, M]
            links = links.reshape(0, a["vecs"].shape[0], meta["m"])
        self._g = hnsw_lib.HNSWGraph(
            vecs=a["vecs"], levels=a["levels"], links0=a["links0"],
            links=links, entry=int(meta["entry"]), M=int(meta["m"]))
        if "packed_vecs_sq" in a:  # older saves: pack() on first search
            self._g.packed = hnsw_lib.PackedHNSW(
                nbrs0=self._g.links0, upper=self._g.links,
                vecs_sq=a["packed_vecs_sq"])
        if self.quant is not None:
            self._g.codec = hnsw_lib.GraphCodes(
                kind=self.quant, codes=a["codec_codes"],
                node_bias=a["codec_node_bias"], vmin=a.get("codec_vmin"),
                step=a.get("codec_step"),
                codebooks=a.get("codec_codebooks"))
        if self.batched is not False or self.quant is not None:
            self._upload()
        return self
