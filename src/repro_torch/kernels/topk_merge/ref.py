"""Plain PyTorch version of the scatter-gather top-k merge.

The reference's ``kernels/topk_merge/ref.py`` term for term: pads (id < 0)
are pinned to ``(NEG_INF, _ID_MAX)``, a pool narrower than k is padded the
same way, and the row is ordered lexicographically by (value descending,
tie-break id ascending), here as two stable sorts (id first, then value).
Values compare as floats: the value sort runs on ``v + 0.0``, which maps
-0.0 to +0.0, so the two zeros tie (a radix sort on the card would order
their bit patterns apart) and break to the lower id. Each selected slot
keeps its own value; slots whose tie-break id is ``_ID_MAX`` come out as
``(NEG_INF, PAD_ID)``.

The CPU path and the tests use it; on the card ``ops.py`` runs the CUDA
kernel (``csrc/topk_merge.cu``), which agrees with it bit for bit.
"""
from __future__ import annotations

import torch

from ..common import NEG_INF, PAD_ID

#: tie-break id of pad slots: loses every "smaller id wins" comparison
_ID_MAX = 2 ** 31 - 1


def pin_pads(vals: torch.Tensor, ids: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 values and int32 tie-break ids with pads pinned to
    ``(NEG_INF, _ID_MAX)``, the pool widened to at least ``k`` slots."""
    v = vals.float()
    i = ids.to(torch.int32)
    pad = i < 0
    v = torch.where(pad, torch.full_like(v, NEG_INF), v)
    tb = torch.where(pad, torch.full_like(i, _ID_MAX), i)
    if v.shape[1] < k:  # fewer candidates than requested: pad the pool
        extra = (v.shape[0], k - v.shape[1])
        v = torch.cat([v, torch.full(extra, NEG_INF, dtype=v.dtype,
                                     device=v.device)], 1)
        tb = torch.cat([tb, torch.full(extra, _ID_MAX, dtype=tb.dtype,
                                       device=tb.device)], 1)
    return v, tb


def lexsort_desc(v: torch.Tensor, tb: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` of each row under (value desc, id asc): a stable
    sort by id, then a stable descending sort by the value (zeros made
    one class). Returns the selected (values, ids)."""
    by_id = torch.sort(tb, dim=1, stable=True).indices
    v1 = torch.gather(v, 1, by_id)
    order = torch.sort(v1 + 0.0, dim=1, descending=True,
                       stable=True).indices[:, :k]
    order = torch.gather(by_id, 1, order)
    return torch.gather(v, 1, order), torch.gather(tb, 1, order)


def topk_merge_ref(vals: torch.Tensor, ids: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``vals``/``ids`` [Q, C] candidates (ids < 0 = pad; live ids unique
    per row) -> (vals [Q, k] float32, ids [Q, k] int32) ordered by (value
    desc, id asc); slots past the live candidates are ``(NEG_INF,
    PAD_ID)``."""
    v, tb = pin_pads(vals, ids, k)
    out_v, out_tb = lexsort_desc(v, tb, k)
    drained = out_tb == _ID_MAX
    return (torch.where(drained, torch.full_like(out_v, NEG_INF), out_v),
            torch.where(drained, torch.full_like(out_tb, PAD_ID), out_tb))
