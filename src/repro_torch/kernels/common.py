"""Shared pad-sentinel convention for every kernel of the port.

A copy of the reference package's ``kernels/common.py``: every scan pads
(short candidate lists, k > N, tombstoned rows) and every pad slot must
look the same on the way out, score ``NEG_INF`` and id ``PAD_ID``. The
two-stage rerank pins pad slots by id, and the port's answers are held
bitwise against the reference's, so the sentinels are the same numbers.

``NEG_INF`` is a large finite negative instead of ``-inf`` so that the
``2q.d - |d|^2 - |q|^2`` score arithmetic of a padded row stays finite
(``inf - inf`` would be NaN) while still losing every comparison.
"""
from __future__ import annotations

import torch

#: Pad-slot score: loses every max/merge against any real similarity.
NEG_INF = -1e30

#: Pad-slot id (FAISS convention: index -1 = "no result in this slot").
PAD_ID = -1

#: Additive distance penalty for padded or tombstoned *rows* in
#: positive-distance forms: such a row must never win the scan.
PAD_PENALTY = 1e30


def canonicalize_pads(vals: torch.Tensor, ids: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pin every pad slot (``ids < 0``) of a merged (vals, ids) pair to
    the canonical ``(NEG_INF, PAD_ID)`` sentinel. Returns new tensors."""
    return torch.where(ids < 0, torch.full_like(vals, NEG_INF), vals), ids
