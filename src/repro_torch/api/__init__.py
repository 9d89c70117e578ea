"""Retrieval API of the port: ``Reducer`` + ``VectorIndex`` (FAISS-style),
the counterpart of ``repro.api`` for the stages ported so far."""
from .reducer import (
    RAEReducer,
    Reducer,
    get_reducer,
    list_reducers,
    load_reducer,
    make_reducer,
    register_reducer,
)
from .index import (
    KNOB_LADDER,
    FlatIndex,
    IVFFlatIndex,
    SearchParams,
    SearchResult,
    TwoStageIndex,
    VectorIndex,
    load_index,
    next_rung,
    register_index,
    snap_knob,
)
from .graph import HNSWIndex
from .quantized import IVFPQIndex, IVFSQ8Index, PQIndex, SQ8Index
from .sharded import ShardedIndex
from .factory import IndexSpec, index_factory, parse_index_spec

__all__ = [
    "FlatIndex",
    "HNSWIndex",
    "IVFFlatIndex",
    "IVFPQIndex",
    "IVFSQ8Index",
    "IndexSpec",
    "KNOB_LADDER",
    "PQIndex",
    "RAEReducer",
    "Reducer",
    "SQ8Index",
    "SearchParams",
    "SearchResult",
    "ShardedIndex",
    "TwoStageIndex",
    "VectorIndex",
    "get_reducer",
    "index_factory",
    "list_reducers",
    "load_index",
    "load_reducer",
    "make_reducer",
    "next_rung",
    "parse_index_spec",
    "register_index",
    "register_reducer",
    "snap_knob",
]
