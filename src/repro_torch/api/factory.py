"""FAISS-style ``index_factory``: build an index stack from a spec string.

The reference's grammar, parsed in full (comma-separated stages,
case-insensitive)::

    spec     := ["Mut" ","] [reducer ","] [shard ","] stack ["," rerank]
    stack    := base | quant | base "," quant
    reducer  := ("RAE" | "PCA" | "RP" | "MDS" | "ISOMAP" | "UMAP") out_dim
    shard    := "Shard" n_shards
    base     := "Flat" | "IVF" n_cells | "HNSW" M
    quant    := "SQ8" | "PQ" m "x" bits     # bits in 1..8
    rerank   := "Rerank" factor             # requires a reducer stage

``index_factory`` builds every spec of the grammar, as the reference's
(its ``_make_base`` mapping: ``SQ8`` and ``PQ<m>x<bits>`` alone are the
flat quantized tiers, after ``IVF<n>`` the IVF-quantized ones, after
``HNSW<M>`` the graph's code payload); any registered reducer maps the
corpus to R^``out_dim`` (the RAE or a Table 1 baseline), and the ``Mut``
prefix wraps the whole stack in :class:`~repro_torch.api.mutable.
MutableIndex`. ``str(spec)`` renders a parsed spec back canonically.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .graph import HNSWIndex
from .index import FlatIndex, IVFFlatIndex, TwoStageIndex, VectorIndex
from .quantized import IVFPQIndex, IVFSQ8Index, PQIndex, SQ8Index
from .reducer import list_reducers, make_reducer
from .sharded import ShardedIndex

_TOKEN = re.compile(r"^([A-Za-z_]+?)(\d+)?$")
_PQ = re.compile(r"^pq(\d+)x(\d+)$", re.IGNORECASE)

@dataclass(frozen=True)
class IndexSpec:
    """Parsed form of a factory spec string. ``str(spec)`` renders the
    canonical spec string, so ``parse_index_spec(str(spec)) == spec``."""

    reducer: Optional[str] = None     # registry name, e.g. "rae"
    out_dim: int = 0                  # reducer target dim
    base: str = "flat"                # "flat" | "ivf" | "hnsw"
    n_cells: int = 0                  # ivf only
    quant: Optional[str] = None       # None | "sq8" | "pq"
    pq_m: int = 0                     # pq only: subspace count
    pq_bits: int = 0                  # pq only: bits per code
    rerank_factor: int = 1
    hnsw_m: int = 0                   # hnsw only: degree cap M
    shards: int = 0                   # 0 = unsharded
    mutable: bool = False             # Mut prefix: MutableIndex wrapper

    def __str__(self) -> str:
        parts = []
        if self.mutable:
            parts.append("Mut")
        if self.reducer is not None:
            parts.append(f"{self.reducer.upper()}{self.out_dim}")
        if self.shards:
            parts.append(f"Shard{self.shards}")
        if self.base == "ivf":
            parts.append(f"IVF{self.n_cells}")
        elif self.base == "hnsw":
            parts.append(f"HNSW{self.hnsw_m}")
        else:
            parts.append("Flat")
        if self.quant == "sq8":
            parts.append("SQ8")
        elif self.quant == "pq":
            parts.append(f"PQ{self.pq_m}x{self.pq_bits}")
        if self.rerank_factor > 1:
            parts.append(f"Rerank{self.rerank_factor}")
        return ",".join(parts)


def _fail(spec: str, why: str):
    raise ValueError(f"bad index spec {spec!r}: {why}")


def parse_index_spec(spec: str) -> IndexSpec:
    tokens = [t.strip() for t in spec.split(",")]
    if not spec.strip() or any(not t for t in tokens):
        _fail(spec, "empty stage")
    reducers = list_reducers()
    reducer: Optional[str] = None
    out_dim = 0
    base: Optional[str] = None
    n_cells = 0
    quant: Optional[str] = None
    pq_m = pq_bits = 0
    rerank = 0
    hnsw_m = 0
    shards = 0
    mutable = False

    def check_order(stage):
        if rerank:
            _fail(spec, "Rerank must come last")
        if quant is not None and stage in ("base", "quant"):
            _fail(spec, "quantizer must be the last storage stage")

    for tok in tokens:
        pq = _PQ.match(tok)
        if pq:
            check_order("quant")
            m_, bits_ = int(pq.group(1)), int(pq.group(2))
            if m_ <= 0:
                _fail(spec, "PQ needs at least one subspace, e.g. PQ8x8")
            if not 1 <= bits_ <= 8:
                _fail(spec, f"PQ bits must be in 1..8, got {bits_}")
            quant, pq_m, pq_bits = "pq", m_, bits_
            continue
        m = _TOKEN.match(tok)
        if not m:
            _fail(spec, f"unparseable stage {tok!r}")
        name, num = m.group(1).lower(), m.group(2)
        if name == "sq":
            if num != "8":
                _fail(spec, f"only SQ8 is supported, got {tok!r}")
            check_order("quant")
            quant = "sq8"
        elif name == "flat":
            if num is not None:
                _fail(spec, "Flat takes no parameter")
            if base is not None:
                _fail(spec, "multiple base stages")
            check_order("base")
            base = "flat"
        elif name == "ivf":
            if num is None:
                _fail(spec, "IVF needs a cell count, e.g. IVF256")
            if base is not None:
                _fail(spec, "multiple base stages")
            check_order("base")
            base, n_cells = "ivf", int(num)
        elif name == "hnsw":
            if num is None:
                _fail(spec, "HNSW needs a degree cap, e.g. HNSW32")
            if int(num) < 2:
                _fail(spec, f"HNSW needs M >= 2, got {tok!r}")
            if base is not None:
                _fail(spec, "multiple base stages")
            check_order("base")
            base, hnsw_m = "hnsw", int(num)
        elif name == "shard":
            if num is None:
                _fail(spec, "Shard needs a shard count, e.g. Shard8")
            if int(num) < 1:
                _fail(spec, f"Shard needs at least one shard, got {tok!r}")
            if shards:
                _fail(spec, "multiple Shard stages")
            if base is not None or quant is not None:
                _fail(spec, "Shard must come before the base stage "
                            "(it partitions the storage stack)")
            check_order("base")
            shards = int(num)
        elif name == "mut":
            if num is not None:
                _fail(spec, "Mut takes no parameter")
            if mutable:
                _fail(spec, "multiple Mut stages")
            if (reducer is not None or base is not None or quant is not None
                    or shards or rerank):
                _fail(spec, "Mut must come first (it wraps the whole stack)")
            mutable = True
        elif name == "rerank":
            if num is None:
                _fail(spec, "Rerank needs a factor, e.g. Rerank4")
            if rerank:
                _fail(spec, "multiple Rerank stages")
            rerank = int(num)
        elif name in reducers:
            if num is None:
                _fail(spec, f"reducer {name!r} needs a target dim, "
                            f"e.g. {name.upper()}64")
            if reducer is not None:
                _fail(spec, "multiple reducer stages")
            if base is not None or quant is not None or shards:
                _fail(spec, "reducer must come before the base stage")
            reducer, out_dim = name, int(num)
        else:
            _fail(spec, f"unknown stage {tok!r} "
                        f"(reducers: {reducers}; bases: flat, ivf, "
                        f"hnsw; quantizers: sq8, pq<m>x<bits>)")
    if base is None and quant is None and not shards:
        _fail(spec, "no base stage (Flat, IVF<n>, HNSW<M>, SQ8 or "
                    "PQ<m>x<bits>)")
    if rerank and reducer is None:
        _fail(spec, "Rerank requires a reducer stage to rerank against")
    if out_dim <= 0 and reducer is not None:
        _fail(spec, "reducer target dim must be positive")
    return IndexSpec(reducer=reducer, out_dim=out_dim, base=base or "flat",
                     n_cells=n_cells, quant=quant, pq_m=pq_m,
                     pq_bits=pq_bits, rerank_factor=rerank or 1,
                     hnsw_m=hnsw_m, shards=shards, mutable=mutable)


def _make_base(parsed: IndexSpec, metric: str, index_kw: dict[str, Any],
               device: str | torch.device) -> VectorIndex:
    """Map (base, quant) to the index class, as the reference's."""
    if parsed.quant is not None and metric != "euclidean":
        raise ValueError("quantized tiers support euclidean only")
    if parsed.base == "hnsw":
        if metric != "euclidean":
            raise ValueError("HNSW base supports euclidean only")
        if parsed.quant == "sq8":
            index_kw.setdefault("quant", "sq8")
        elif parsed.quant == "pq":
            index_kw.setdefault("quant", "pq")
            index_kw.setdefault("pq_m", parsed.pq_m)
            index_kw.setdefault("pq_bits", parsed.pq_bits)
        return HNSWIndex(m=parsed.hnsw_m, device=device, **index_kw)
    if parsed.base == "ivf":
        if metric != "euclidean":
            raise ValueError("IVF base supports euclidean only")
        if parsed.quant == "sq8":
            return IVFSQ8Index(n_cells=parsed.n_cells, device=device,
                               **index_kw)
        if parsed.quant == "pq":
            return IVFPQIndex(n_cells=parsed.n_cells, m=parsed.pq_m,
                              bits=parsed.pq_bits, device=device, **index_kw)
        return IVFFlatIndex(n_cells=parsed.n_cells, device=device,
                            **index_kw)
    if parsed.quant == "sq8":
        return SQ8Index(device=device, **index_kw)
    if parsed.quant == "pq":
        return PQIndex(m=parsed.pq_m, bits=parsed.pq_bits, device=device,
                       **index_kw)
    return FlatIndex(metric=metric, device=device, **index_kw)


def index_factory(spec: str, *, metric: str = "euclidean",
                  reducer_kw: Optional[dict[str, Any]] = None,
                  index_kw: Optional[dict[str, Any]] = None,
                  device: str | torch.device = "cuda") -> VectorIndex:
    """Build an (unbuilt) index stack from ``spec`` on ``device``.

    ``reducer_kw`` is forwarded to the reducer constructor (e.g. RAE's
    ``steps`` / ``seed``); ``index_kw`` to the base index (e.g. IVF's
    ``nprobe``, PQ's ``kmeans_iters``). A sharded stack's children run on
    a thread pool, quantized children included, as in the reference; a
    ``Mut`` stack is one :class:`MutableIndex` over the whole stack (its
    shards are not wrapped). Call ``.build(corpus)`` on the result."""
    parsed = parse_index_spec(spec)
    if parsed.shards:
        child_spec = str(dataclasses.replace(
            parsed, reducer=None, out_dim=0, shards=0, rerank_factor=1,
            mutable=False))
        stack: VectorIndex = ShardedIndex(
            n_shards=parsed.shards, child_spec=child_spec, metric=metric,
            workers="threads", index_kw=dict(index_kw or {}), device=device)
    else:
        stack = _make_base(parsed, metric, dict(index_kw or {}), device)
    if parsed.reducer is not None:
        reducer = make_reducer(parsed.reducer, parsed.out_dim, device=device,
                               **dict(reducer_kw or {}))
        stack = TwoStageIndex(reducer, stack,
                              rerank_factor=parsed.rerank_factor,
                              metric=metric, device=device)
    if parsed.mutable:
        from .mutable import MutableIndex  # cycle: lazy

        stack = MutableIndex(stack)
    return stack
