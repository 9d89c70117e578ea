"""Reduced (smoke-scale) configs: same family and topology, tiny widths; the
reference's ``configs/reduce.py`` for the families the port runs."""
from __future__ import annotations

import dataclasses

from .base import RecsysConfig, ShapeCell, TransformerConfig


def reduce_config(cfg, family: str):
    if family == "lm":
        assert isinstance(cfg, TransformerConfig)
        moe = cfg.family == "moe"
        return dataclasses.replace(
            cfg,
            n_layers=2,
            d_model=64,
            n_heads=max(4, min(cfg.n_heads, 4)),
            n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
            d_head=16,
            d_ff=64 if moe else 128,
            vocab_size=251,
            n_experts=8 if moe else 0,
            moe_top_k=min(cfg.moe_top_k, 2) if moe else 0,
            kv_chunk=16,
            xent_chunk=8,
        )
    if family == "recsys":
        assert isinstance(cfg, RecsysConfig)
        tables = tuple(
            dataclasses.replace(t, vocab=min(t.vocab, 1000)) for t in cfg.tables)
        return dataclasses.replace(
            cfg, tables=tables,
            mlp_dims=tuple(min(d, 64) for d in cfg.mlp_dims))
    raise ValueError(family)


def reduce_cell(cell: ShapeCell, family: str) -> ShapeCell:
    if family == "lm":
        return cell.replace(seq_len=min(cell.seq_len, 64),
                            global_batch=min(cell.global_batch, 4))
    if family == "recsys":
        kw = {"global_batch": min(cell.global_batch, 32) or 1}
        if cell.n_candidates:
            kw["n_candidates"] = min(cell.n_candidates, 512)
        return cell.replace(**kw)
    raise ValueError(family)
