"""Shared recsys building blocks: embedding tables, MLP towers, losses.

The reference's ``models/recsys/common.py`` on one device: tables are
whole on the card, looked up through ``models.common`` (whose lookups are
differentiable through the ``embedding_bag_bwd`` kernel). The in-batch
softmax drops the reference's ``ctx.constrain`` of the logits: one card
holds the whole ``[B, B]`` matrix.
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


def bce_loss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits, in float32 (the stable form)."""
    logit = logit.float()
    return torch.mean(torch.clamp(logit, min=0) - logit * label
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def in_batch_softmax_loss(u: torch.Tensor, v: torch.Tensor,
                          temp: float = 0.05) -> torch.Tensor:
    """Sampled softmax with in-batch negatives: ``diag(U V^T)`` are the
    positives. Logits ``[B, B]`` and positives in float32, divided by
    ``temp`` as the reference divides them."""
    t = torch.full((), temp, dtype=torch.float32, device=u.device)
    logits = (u @ v.T).float() / t
    lse = torch.logsumexp(logits, dim=-1)
    pos = torch.einsum("bd,bd->b", u.float(), v.float()) / t
    return torch.mean(lse - pos)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)
