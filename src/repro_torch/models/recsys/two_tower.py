"""Two-tower retrieval (Yi et al., RecSys'19) with in-batch sampled softmax.

User tower: user embedding + history EmbeddingBag -> MLP -> L2-norm.
Item tower: item embedding -> MLP -> L2-norm. ``serve`` scores (user, item)
pairs by dot product; ``retrieval_scores`` scores one user against a
candidate list, whose top-100 ``models.registry`` takes with
``search.distributed.distributed_topk``. The towers' outputs are the
embeddings a retrieval index over them holds: the paper's RAE slots in
there (encode both sides, scan in R^m). The reference's
``models/recsys/two_tower.py`` on one device; the history bag runs through
the hand-written ``embedding_bag`` kernel on the card, and in training the
gradients of the three tables through the ``embedding_bag_bwd`` kernel.
``loss_fn`` trains with in-batch negatives.
"""
from __future__ import annotations

import torch

from ...configs.base import RecsysConfig
from ...distributed.partitioning import init_from_schema
from ..common import dtype_of
from . import common as rc


def schema(cfg: RecsysConfig) -> dict:
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.embed_dim
    s = dict(rc.table_schema(cfg))
    u_dims = (2 * d,) + cfg.mlp_dims  # user id emb + hist bag
    i_dims = (d,) + cfg.mlp_dims
    s.update(rc.mlp_schema("user_mlp", u_dims, pdt))
    s.update(rc.mlp_schema("item_mlp", i_dims, pdt))
    return s


def init(cfg: RecsysConfig, seed: int = 0,
         device: str | torch.device = "cuda") -> dict:
    return init_from_schema(schema(cfg), seed, device)


def user_tower(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """batch: ``user`` [B], ``hist`` [B, L], ``hist_len`` [B] -> float32
    [B, d_out], unit rows."""
    cdt = dtype_of(cfg.compute_dtype)
    ue = rc.lookup(params, "user", batch["user"], cdt)
    hb = rc.bag_lookup(params, "hist_item", batch["hist"], batch["hist_len"],
                       mode="mean", compute_dtype=cdt)
    x = torch.cat([ue, hb], dim=-1)
    x = rc.apply_mlp(params, "user_mlp", x, len(cfg.mlp_dims))
    return rc.l2norm(x.float())


def item_tower(params, item_ids: torch.Tensor, cfg: RecsysConfig
               ) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    ie = rc.lookup(params, "item", item_ids, cdt)
    x = rc.apply_mlp(params, "item_mlp", ie, len(cfg.mlp_dims))
    return rc.l2norm(x.float())


def loss_fn(params, batch, cfg: RecsysConfig):
    """In-batch softmax over the batch's (user, item) pairs: ``(loss,
    {})``."""
    u = user_tower(params, batch, cfg)
    v = item_tower(params, batch["item"], cfg)
    return rc.in_batch_softmax_loss(u, v), {}


def serve(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """Pairwise scores for a (user, item) batch: float32 [B]."""
    u = user_tower(params, batch, cfg)
    v = item_tower(params, batch["item"], cfg)
    return torch.einsum("bd,bd->b", u, v)


def retrieval_scores(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """One user vs ``batch["candidates"]`` item ids -> float32 [N]."""
    u = user_tower(params, batch, cfg)                     # [1, d]
    cands = item_tower(params, batch["candidates"], cfg)   # [N, d]
    return cands @ u[0]
