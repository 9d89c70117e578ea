"""Shared model primitives: dtypes, norms, embedding lookups.

The reference's ``models/common.py`` on one device: its ``MeshCtx`` and
``shard_map`` branches (row-sharded tables, sequence-parallel boundaries)
need a mesh of several devices and have no counterpart here, so each
function is the reference's single-device branch. The bag reduction goes
through the hand-written ``embedding_bag`` kernel on the card. Both
lookups are differentiable in the table: their gradient is the
``embedding_bag_bwd`` kernel (``kernels/embedding_bag/ops.py``), which sums
each row's gradient in one fixed order where autograd's ``index_select``
backward would scatter with atomics.
"""
from __future__ import annotations

import torch

from ..kernels.embedding_bag import ops as bag_ops
from ..pytree import map_with_path


def dtype_of(name: str) -> torch.dtype:
    """A torch dtype from a config's dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def value_and_grad(loss_fn, params, *args):
    """``((loss, metrics), grads)`` of ``loss_fn(params, *args) -> (loss,
    metrics)``, as ``jax.value_and_grad(..., has_aux=True)`` gives them:
    the gradient of every leaf of ``params``, a tree like it; loss and
    metrics detached."""
    tracked = []

    def leaf(path, p):
        t = p.detach().requires_grad_(True)
        tracked.append((path, t))
        return t

    loss, metrics = loss_fn(map_with_path(leaf, params), *args)
    gs = torch.autograd.grad(loss, [t for _, t in tracked])
    by_path = {path: g for (path, _), g in zip(tracked, gs)}
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            map_with_path(lambda path, _: by_path[path], params))


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``out[..., :] = table[ids]`` in ``compute_dtype``, ids clipped to
    ``[0, V-1]`` as the reference's lookup clips them (``mode="clip"``:
    hash collisions fold into the last row instead of reading a fill)."""
    idx = ids.long().clamp(0, table.shape[0] - 1)
    rows = bag_ops.embedding_lookup(table, idx.reshape(-1))
    return rows.reshape(*ids.shape, table.shape[1]).to(compute_dtype)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  lengths: torch.Tensor, mode: str = "mean",
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """torch.nn.EmbeddingBag's sum / mean of each bag's first
    ``lengths[b]`` rows: ``[B, L]`` ids -> ``[B, d]`` in ``compute_dtype``.

    The reference's single-device branch (``models/common.py:249``) casts
    each row to the compute dtype and sums there. The port sums the
    table's rows in float32 in the ``embedding_bag`` kernel (its plain
    version on the CPU), divides there for the mean, and casts the bag
    once: at ``compute_dtype=float32`` the two agree to float32 rounding,
    in bfloat16 the port's bag is the better rounded of the two."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    return bag_ops.embedding_bag_autograd(table, ids, lengths, mode).to(
        compute_dtype)
