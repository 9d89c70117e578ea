"""Per-query adaptive escalation: the top-k margin-stability signal.

The offline autotuner (``repro_torch.tune.autotune``) picks ONE operating
point per recall SLO, but query difficulty is heavy-tailed: most queries
reach the target well below the tuned knobs, a few need more. A wide top-k
margin in the space that was searched certifies the result; a narrow one
flags a query whose true neighbours may sit just past the beam or probe
boundary.

The signal is computed from the scores a cheap pass already produced, with
no extra distance evaluations. The first pass over-fetches ``k + delta``
candidates; for each query the *normalized tail margin*

    margin = (s[k-1] - s[k+delta-1]) / (s[0] - s[k+delta-1])

measures how decisively the k-th neighbour separates from the
(k+delta)-th, on the query's own score scale (higher = closer). It lives in
[0, 1]. Rows whose margin falls below ``threshold``, and rows whose probe
came up short of ``k + delta`` finite candidates when the corpus holds
that many, are re-run one :data:`~repro_torch.api.index.KNOB_LADDER` rung
up by the serving engine (``SearchEngine``).

Host numpy on the result's arrays, as the reference's (``SearchResult``
holds numpy arrays in both packages), so the masks are the reference's
bit for bit on the same scores.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..api.index import SearchParams


@dataclass(frozen=True)
class EscalationPolicy:
    """When and how the engine re-runs unstable queries.

    ``delta``: how far past k the first pass over-fetches; the margin is
    measured between the k-th and (k+delta)-th scores. ``threshold``:
    normalized-margin cut in [0, 1]; 0 never escalates, values > 1 always
    escalate (every finite margin is <= 1). ``params``: explicit pass-2
    operating point; ``None`` derives it as one ladder rung up from the
    engine's resolved pass-1 point (:meth:`SearchParams.escalated`).
    ``recall_slack``: the recall deficit escalation is trusted to close;
    the engine selects the cheapest curve point reaching ``target_recall -
    recall_slack`` and leans on the escalation pass for the gap."""

    delta: int = 3
    threshold: float = 0.15
    params: Optional[SearchParams] = None
    recall_slack: float = 0.0

    def __post_init__(self):
        if self.delta < 1:
            raise ValueError(f"delta must be >= 1, got {self.delta}")
        if self.threshold < 0.0:
            raise ValueError(
                f"threshold must be >= 0, got {self.threshold}")
        if self.recall_slack < 0.0:
            raise ValueError(
                f"recall_slack must be >= 0, got {self.recall_slack}")

    def key(self) -> tuple:
        """Hashable identity for cache keys / operating-point tokens."""
        return (self.delta, float(self.threshold),
                None if self.params is None else self.params.key(),
                float(self.recall_slack))


def topk_margin(scores: np.ndarray, k: int, delta: int) -> np.ndarray:
    """Normalized tail margin per row, from a [Q, >= k+delta] score matrix
    (higher = closer, descending per row).

    Rows without ``k + delta`` finite candidates get margin NaN (the probe
    or beam came up short; :func:`unstable_rows` decides). A full-tie row
    (s[0] == s[k+delta-1]) gets margin 0.0."""
    kk = k + delta
    if scores.shape[1] < kk:
        raise ValueError(f"need k+delta={kk} scores per row, "
                         f"got {scores.shape[1]}")
    s = np.asarray(scores, np.float64)
    top, kth, tail = s[:, 0], s[:, k - 1], s[:, kk - 1]
    finite = np.isfinite(top) & np.isfinite(tail)
    span = top - tail
    margin = np.full(s.shape[0], np.nan)
    ok = finite & (span > 0)
    margin[ok] = (kth[ok] - tail[ok]) / span[ok]
    margin[finite & (span <= 0)] = 0.0
    return margin


def unstable_rows(scores: np.ndarray, k: int, delta: int,
                  threshold: float,
                  ntotal: Optional[int] = None) -> np.ndarray:
    """Boolean mask of rows the engine should re-run at the next rung: a
    margin below ``threshold``, or an undefined margin (fewer than ``k +
    delta`` finite candidates) when the corpus holds that many rows
    (``ntotal``); a tiny corpus simply has nothing more to find."""
    margin = topk_margin(scores, k, delta)
    short = np.isnan(margin)
    out = np.zeros(margin.shape[0], bool)
    fin = ~short
    out[fin] = margin[fin] < threshold
    if ntotal is None or ntotal >= k + delta:
        out |= short
    return out
