"""Retrieval API of the port: ``Reducer`` + ``VectorIndex`` (FAISS-style),
the counterpart of ``repro.api``: the reducers (RAE and the Table 1
baselines), every index tier, ``MutableIndex`` (factory prefix ``Mut``)
and the factory."""
from .reducer import (
    GaussianRPReducer,
    IsomapReducer,
    MDSLinearReducer,
    PCAReducer,
    RAEReducer,
    UMAPLiteReducer,
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
from .mutable import MutableIndex
from .factory import IndexSpec, index_factory, parse_index_spec

__all__ = [
    "FlatIndex",
    "GaussianRPReducer",
    "HNSWIndex",
    "IVFFlatIndex",
    "IVFPQIndex",
    "IVFSQ8Index",
    "IndexSpec",
    "IsomapReducer",
    "KNOB_LADDER",
    "MDSLinearReducer",
    "MutableIndex",
    "PCAReducer",
    "PQIndex",
    "RAEReducer",
    "Reducer",
    "SQ8Index",
    "SearchParams",
    "SearchResult",
    "ShardedIndex",
    "TwoStageIndex",
    "UMAPLiteReducer",
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
