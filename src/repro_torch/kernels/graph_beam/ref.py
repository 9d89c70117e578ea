"""Plain PyTorch version of the fused gather + L2 + beam-merge hop.

One HNSW traversal hop, term for term the reference's
``kernels/graph_beam/ref.py``: gather the ``nbr_ids`` rows, score
``2 q.v - |v|^2 - |q|^2``, set masked slots (id < 0, or a ``db_mask``
tombstone) to ``NEG_INF``, and merge into the ``[Q, ef]`` beam by a stable
descending sort over ``[beam, candidates]``: ties go to the beam entry
first, then to the lower candidate slot (not ``l2_topk``'s lower-id rule).
Pads come out as ``(NEG_INF, PAD_ID)``.

The dot products and norms are summed by :func:`pairwise_sum`, a fixed
balanced tree of elementwise adds. Its order depends on the row width
only, so a row's answer does not depend on its batch-mates, and the CUDA
kernel (``csrc/graph_beam.cu``) sums in the same tree: kernel and plain
version agree bit for bit on any float32 input.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import NEG_INF, canonicalize_pads


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a balanced pairwise tree: adjacent pairs
    first, then adjacent pair sums, and so on, with a zero appended to a
    level of odd width (the same tree as zero-padding the axis to a power
    of two). Elementwise ops only, so the order never depends on the other
    axes' sizes, as a library reduction's may."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def graph_beam_ref(queries: torch.Tensor, db: torch.Tensor,
                   nbr_ids: torch.Tensor, beam_v: torch.Tensor,
                   beam_i: torch.Tensor,
                   db_sq: Optional[torch.Tensor] = None,
                   q_sq: Optional[torch.Tensor] = None,
                   db_mask: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, d]; db [N, d]; nbr_ids [Q, W] int (-1 = masked slot);
    beam_v/beam_i [Q, ef], sorted descending, empty slots ``(NEG_INF, -1)``
    or ``(-inf, -1)``. ``db_sq`` [N] / ``q_sq`` [Q]: squared norms,
    recomputed when absent. ``db_mask`` (bool [N]) tombstones rows: a
    masked candidate is a -1 slot. Returns the merged (vals [Q, ef]
    float32, ids [Q, ef] int32), sorted descending."""
    q = queries.float()
    d = db.float()
    ids = nbr_ids.to(torch.int32)
    bv = beam_v.float()
    bi = beam_i.to(torch.int32)
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    if db_mask is not None:
        valid = valid & db_mask.to(torch.bool)[safe]
    if db_sq is None:
        db_sq = pairwise_sum(d * d)
    if q_sq is None:
        q_sq = pairwise_sum(q * q)
    s = candidate_scores(q, d, safe, db_sq.float(), q_sq.float())
    return merge_into_beam(bv, bi, s, ids, valid)


def candidate_scores(q: torch.Tensor, d: torch.Tensor, safe: torch.Tensor,
                     db_sq: torch.Tensor, q_sq: torch.Tensor) -> torch.Tensor:
    """``(2 q.v - |v|^2) - |q|^2`` of the rows ``safe`` [Q, W] (valid
    ids) of ``d`` against ``q`` [Q, d], summed by :func:`pairwise_sum`."""
    g = d[safe]                                              # [Q, W, d]
    s = 2.0 * pairwise_sum(g * q[:, None, :])
    s = s - db_sq[safe]
    return s - q_sq[:, None]


def merge_into_beam(bv: torch.Tensor, bi: torch.Tensor, s: torch.Tensor,
                    ids: torch.Tensor, valid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate scores ``s`` [Q, W] (ids [Q, W]; slots not
    ``valid`` become ``(NEG_INF, -1)``) into the beam ``(bv, bi)`` [Q, ef]:
    the first ef entries of a stable descending sort of [beam, candidates],
    pads canonicalized. Shared by the f32 and the quantized hops."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    allv = torch.cat([bv, s], dim=1)
    alli = torch.cat([bi, torch.where(valid, ids, torch.full_like(ids, -1))],
                     dim=1)
    order = torch.sort(allv, dim=1, descending=True,
                       stable=True).indices[:, :bv.shape[1]]
    return canonicalize_pads(torch.gather(allv, 1, order),
                             torch.gather(alli, 1, order))


def graph_traverse_ref(q: torch.Tensor, db: torch.Tensor,
                       db_sq: torch.Tensor, q_sq: torch.Tensor,
                       nbrs0: torch.Tensor, upper: torch.Tensor, entry: int,
                       ef: int, alive: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """One query at a time, the card's traversal kernel
    (``csrc/graph_traverse.cuh`` ``graph_traverse_kernel``) over float32
    rows, in its order of work (:func:`traverse_rows`), each step scored
    and merged as :func:`graph_beam_ref` does."""
    d = db.float()

    def score(r, safe):
        return candidate_scores(q[r:r + 1].float(), d, safe[None, :],
                                db_sq.float(), q_sq[r:r + 1].float())[0]

    return traverse_rows(score, q.shape[0], db.shape[0], nbrs0, upper, entry,
                         ef, alive)


def traverse_rows(score, nq: int, n: int, nbrs0: torch.Tensor,
                  upper: torch.Tensor, entry: int, ef: int,
                  alive: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The traversal kernel's order of work for each of ``nq`` queries
    alone, with the payload's scores ``score(r, ids)`` (query r, valid ids
    [w] long -> float32 scores [w]): the entry seed (a 1-wide merge into an
    empty beam), the greedy descent through ``upper`` [L, N, M] (ef=1
    merges; ties keep the current node), then the layer-0 beam over
    ``nbrs0`` [N, W0] with an expanded flag a beam slot carried through
    each merge and one "seen" bit a node. ``alive`` (bool [N]) tombstones
    nodes: seen and counted, never scored. Returns (beam_v [Q, ef], beam_i
    [Q, ef] int32, evals [Q] int64, hops [Q] int32): evals as
    ``search_batched`` counts them, hops the layer-0 steps of each row."""
    alive = (torch.ones(n, dtype=torch.bool) if alive is None
             else alive.to(torch.bool).cpu())
    nbrs0, upper = nbrs0.cpu().long(), upper.cpu().long()
    out_v = torch.empty((nq, ef), dtype=torch.float32)
    out_i = torch.empty((nq, ef), dtype=torch.int32)
    evals = torch.zeros(nq, dtype=torch.int64)
    hops = torch.zeros(nq, dtype=torch.int32)
    for r in range(nq):

        def merge(cand, bv, bi, bx):
            """Score the candidate ids (-1 = none) and merge them into
            (bv, bi) [e], carrying the flags bx of the beam's entries."""
            valid = cand >= 0
            s = torch.where(valid, score(r, torch.where(valid, cand, 0)),
                            torch.full(cand.shape, NEG_INF))
            allv = torch.cat([bv, s])
            alli = torch.cat([bi, torch.where(valid, cand, -1).int()])
            allx = torch.cat([bx, torch.zeros(cand.shape[0],
                                              dtype=torch.bool)])
            order = torch.sort(allv, descending=True,
                               stable=True).indices[:bv.shape[0]]
            vi = alli[order]
            return (torch.where(vi < 0, torch.full_like(allv[order], NEG_INF),
                                allv[order]), vi, allx[order])

        one = torch.zeros(1, dtype=torch.bool)
        seed = torch.tensor([entry if bool(alive[entry]) else -1])
        cv, ci, _ = merge(seed, torch.tensor([NEG_INF]),
                          torch.tensor([-1], dtype=torch.int32), one)
        n_evals = 1
        for layer in range(upper.shape[0], 0, -1):
            while True:
                cur = int(ci[0])
                nb = upper[layer - 1, cur] if cur >= 0 else \
                    torch.full((upper.shape[2],), -1)
                valid = nb >= 0
                n_evals += int(valid.sum())
                cand = torch.where(valid & alive[torch.where(valid, nb, 0)],
                                   nb, -1)
                cv, ci, _ = merge(cand, cv, ci, one)
                if int(ci[0]) == cur:
                    break
        bv = torch.full((ef,), NEG_INF)
        bi = torch.full((ef,), -1, dtype=torch.int32)
        bx = torch.zeros(ef, dtype=torch.bool)
        bv[0], bi[0] = cv[0], ci[0]
        seen = torch.zeros(n, dtype=torch.bool)
        if int(ci[0]) >= 0:
            seen[int(ci[0])] = True
        n_hops = 0
        while True:
            open_ = (bi >= 0) & ~bx
            if not bool(open_.any()):
                break
            node = int(bi[int(torch.nonzero(open_)[0])])
            bx = bx | (bi == node)
            n_hops += 1
            nb = nbrs0[node]
            valid = nb >= 0
            safe = torch.where(valid, nb, 0)
            fresh = valid & ~seen[safe]
            seen[safe[fresh]] = True
            n_evals += int(fresh.sum())
            bv, bi, bx = merge(torch.where(fresh & alive[safe], nb, -1),
                               bv, bi, bx)
        out_v[r], out_i[r] = bv, bi
        evals[r], hops[r] = n_evals, n_hops
    return out_v, out_i, evals, hops
