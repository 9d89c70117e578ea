"""Shared recsys building blocks: embedding tables and MLP towers.

The reference's ``models/recsys/common.py`` for its serving paths, on one
device: tables are whole on the card, looked up through
``models.common``. The losses are training and wait (ROADMAP.md queue A
item 15).
"""
from __future__ import annotations

import torch

from ...configs.base import RecsysConfig
from ...distributed.partitioning import ParamDef
from ..common import (dtype_of, embedding_bag, pad_to_multiple,
                      sharded_embedding_lookup)

ROW_PAD = 512  # table rows padded as the reference pads them


def table_schema(cfg: RecsysConfig) -> dict[str, ParamDef]:
    pdt = dtype_of(cfg.param_dtype)
    out = {}
    for t in cfg.tables:
        out[f"table_{t.name}"] = ParamDef(
            (pad_to_multiple(t.vocab, ROW_PAD), t.dim), ("table_rows", None),
            pdt, init="embed", scale=0.01)
    return out


def mlp_schema(prefix: str, dims: tuple[int, ...], pdt) -> dict[str, ParamDef]:
    out = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}_w{i}"] = ParamDef((dims[i], dims[i + 1]), (None, None),
                                         pdt)
        out[f"{prefix}_b{i}"] = ParamDef((dims[i + 1],), (None,), pdt,
                                         init="zeros")
    return out


def apply_mlp(params, prefix: str, x: torch.Tensor, n_layers: int,
              final_act: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ params[f"{prefix}_w{i}"].to(x.dtype) \
            + params[f"{prefix}_b{i}"].to(x.dtype)
        if i < n_layers - 1 or final_act:
            x = torch.relu(x)
    return x


def lookup(params, name: str, ids: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    return sharded_embedding_lookup(params[f"table_{name}"], ids,
                                    compute_dtype)


def bag_lookup(params, name: str, ids: torch.Tensor, lengths: torch.Tensor,
               mode: str = "mean", compute_dtype=torch.bfloat16
               ) -> torch.Tensor:
    return embedding_bag(params[f"table_{name}"], ids, lengths, mode=mode,
                         compute_dtype=compute_dtype)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)
