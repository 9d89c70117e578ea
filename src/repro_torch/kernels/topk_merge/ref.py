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

:func:`topk_merge_select_ref` models that kernel's own algorithm at its
launch plan (``kernel.plan``): per row, a cut of the 64-bit pair keys to
the k-th (:func:`digit_cut` in a narrow block, :func:`byte_cut` in a wide
one), the keep pass that takes the keys above the cut and only as many
of those at it as are still needed (pads share one key), and the order
of the k survivors. The tests hold it against :func:`topk_merge_ref`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import NEG_INF, PAD_ID
from ..l2_topk.ref import order_keys
from .kernel import DIGIT_BITS, NARROW_THREADS, RANK_MAX_K

#: The narrow cut ranks its candidates directly once this many are left
#: (``few_cut`` of the source: one a lane of a warp).
FEW = 32

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


def unsigned_keys(vals: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
    """The kernel's 64-bit pair keys (``make_key`` of
    ``csrc/topk_select.cuh``; larger = better) of pinned (values, tie-break
    ids), as numpy uint64."""
    return order_keys(vals, ids).numpy().view(np.uint64) ^ np.uint64(2 ** 63)


def _or_and_diff(keys: np.ndarray) -> tuple[int, int]:
    """(bits on which ``keys`` differ, their AND) as Python ints."""
    a = int(np.bitwise_and.reduce(keys))
    return int(np.bitwise_or.reduce(keys)) ^ a, a


def digit_cut(keys: np.ndarray, k: int
              ) -> tuple[int, int, int, int, int]:
    """The narrow blocks' cut of one row's ``keys`` (more than k; pads
    share one key) to its k-th. A pass counts the candidates of each value
    of a ``DIGIT_BITS``-bit window of the keys, and the bin where the k-th
    falls holds the next candidates. The first window starts at the
    candidates' highest differing bit (a round: their OR and AND), and so
    does a window after a pass that split nothing; the others are the bits
    below the last. It stops at the first pass whose chosen bin holds
    exactly the pairs still needed, or when the candidates are one key;
    once ``FEW`` or fewer are left, their ranks put the cut at the one
    key still needed last (a round). Returns (shift, top, need, passes,
    rounds): the keys with ``key >> shift`` above ``top`` are kept, and
    ``need`` of those equal to it."""
    cand = np.ones(keys.shape, bool)
    need, n_cand, passes, rounds = k, keys.size, 0, 0
    jump, lo, prefix = True, 0, 0
    mask = np.uint64(2 ** DIGIT_BITS - 1)
    while True:
        if jump:
            rounds += 1
            diff, common = _or_and_diff(keys[cand])
            if diff == 0:
                return 0, common, need, passes, rounds
            lo = max(diff.bit_length() - DIGIT_BITS, 0)
            top = lo + DIGIT_BITS
            prefix = 0 if top >= 64 else common >> top << top
        else:
            lo = max(lo - DIGIT_BITS, 0)
        passes += 1
        digits = ((keys >> np.uint64(lo)) & mask).astype(np.int64)
        count = np.bincount(digits[cand], minlength=2 ** DIGIT_BITS)
        at_or_above = np.cumsum(count[::-1])[::-1]
        digit = int(np.nonzero(at_or_above >= need)[0].max())
        need -= int(at_or_above[digit] - count[digit])
        prefix |= digit << lo
        cand &= digits == digit
        n = int(count[digit])
        if n == need or lo == 0:
            return lo, prefix >> lo, need, passes, rounds
        if n <= FEW:
            few = np.sort(keys[cand])[::-1]
            cut = int(few[need - 1])
            return 0, cut, need - int((few > cut).sum()), passes, rounds + 1
        jump = n == n_cand
        n_cand = n


def byte_cut(keys: np.ndarray, k: int) -> tuple[int, int, int, int, int]:
    """The wide blocks' cut, with :func:`digit_cut`'s result: one round
    (the row's OR and AND); from the 8-bit digit that holds the highest
    differing bit down, a histogram of 256 bins a pass over the digit of
    the keys that match the digits chosen so far; the chosen digit is the
    highest whose bins at or above it hold the pairs still needed; it
    stops at the first pass whose chosen bin holds exactly those (at the
    last digit at worst)."""
    diff, common = _or_and_diff(keys)
    if diff == 0:
        return 0, common, k, 0, 1
    first = (diff.bit_length() - 1) // 8 * 8
    need, passes, shift = k, 0, first + 8
    top = common >> shift if shift < 64 else 0
    while True:
        shift -= 8
        passes += 1
        t = keys >> np.uint64(shift)
        cand = (t >> np.uint64(8)) == np.uint64(top) if shift < first \
            else np.ones(keys.shape, bool)
        hist = np.bincount((t[cand] & np.uint64(255)).astype(np.int64),
                           minlength=256)
        at_or_above = np.cumsum(hist[::-1])[::-1]
        d = int(np.nonzero(at_or_above >= need)[0].max())
        need -= int(at_or_above[d] - hist[d])
        top = (top << 8) | d
        if int(hist[d]) == need or shift == 0:
            return shift, top, need, passes, 1


def block_barriers(threads: int, k: int, p: int, passes: int,
                   rounds: int) -> int:
    """Block barriers on one row's path: one a round of the cut (the
    keys' OR and AND, the few candidates' ranks), one a narrow pass and
    three a wide one, one before
    and one after the keep pass's stores; above ``RANK_MAX_K`` survivors
    one after the sort's fill, one after each sort stage whose pairs, or
    the next stage's, leave a warp's slots, and one after the sort."""
    n = rounds + passes * (1 if threads == NARROW_THREADS else 3) + 2
    if k <= RANK_MAX_K:
        return n
    per_warp = 32 * max(1, p // (2 * threads))
    n += 2
    size = 2
    while size <= p:
        stride = size // 2
        while stride > 0:
            nxt = stride // 2 if stride > 1 else size
            n += stride > per_warp or nxt > per_warp
            stride //= 2
        size *= 2
    return n


def topk_merge_select_ref(vals: torch.Tensor, ids: torch.Tensor, k: int,
                          plan: tuple[int, int, int]
                          ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The card kernel's merge at ``plan`` = (threads a row, keys a
    thread, sort width) of ``kernel.plan(max(C, k), k)``, one row at a
    time (a block a row): pads pinned and the pool widened to k as
    ``ops.topk_merge`` does; each row's keys cut to k by :func:`digit_cut`
    in a narrow block, :func:`byte_cut` in a wide one (none when k = C);
    kept, in slot order, the keys above the cut and the
    first ``need`` at it; the k survivors ordered best first (the kernel
    counts each one's rank up to ``RANK_MAX_K`` survivors and sorts ``sort
    width`` slots above: one order, the pads' one key printing alike);
    slots whose tie-break id is ``_ID_MAX`` written as ``(NEG_INF,
    PAD_ID)``. Same arguments and result as :func:`topk_merge_ref`, and
    stats: each row's cut passes and block barriers."""
    threads, per_thread, p = plan
    v, tb = pin_pads(vals, ids, k)
    nq, c = v.shape
    if c > threads * per_thread or p < k:
        raise ValueError(f"plan {plan} does not hold C={c}, k={k}")
    keys = unsigned_keys(v, tb)
    cut = digit_cut if threads == NARROW_THREADS else byte_cut
    out_v = torch.empty((nq, k), dtype=torch.float32)
    out_i = torch.empty((nq, k), dtype=torch.int32)
    passes = torch.zeros(nq, dtype=torch.int64)
    barriers = torch.zeros(nq, dtype=torch.int64)
    for r in range(nq):
        kr = keys[r]
        keep = np.ones(c, bool)
        rounds = 0
        if k < c:
            shift, top, need, passes[r], rounds = cut(kr, k)
            t = kr >> np.uint64(shift)
            at = t == np.uint64(top)
            keep = (t > np.uint64(top)) | (at & (np.cumsum(at) <= need))
        if int(keep.sum()) != k:
            raise AssertionError(f"row {r}: kept {int(keep.sum())} of k={k}")
        order = np.argsort(kr[keep], kind="stable")[::-1]
        sk = kr[keep][order]
        sv = v[r].numpy()[keep][order]
        lo = (sk & np.uint64(0xFFFFFFFF)).astype(np.int64)
        drained = lo == 0
        out_v[r] = torch.from_numpy(np.where(drained, np.float32(NEG_INF),
                                             sv))
        out_i[r] = torch.from_numpy(np.where(drained, PAD_ID, _ID_MAX - lo)
                                    .astype(np.int32))
        barriers[r] = block_barriers(threads, k, p, int(passes[r]), rounds)
    return out_v, out_i, {"passes": passes, "block_barriers": barriers}
