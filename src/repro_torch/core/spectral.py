"""Singular-spectrum analysis of the encoder (paper Section 3.3 / Figure 1).

The reference's ``core/spectral.py`` on PyTorch tensors. Every function
works on the tensor's own device, in float32."""
from __future__ import annotations

from typing import NamedTuple

import torch


class SpectralStats(NamedTuple):
    sigma_max: torch.Tensor
    sigma_min: torch.Tensor
    condition_number: torch.Tensor  # kappa(W) = sigma_max / sigma_min (Eq. 16)
    frobenius: torch.Tensor         # ||W||_F  (>= sigma_max, Eq. 8)
    effective_rank: torch.Tensor    # exp(entropy of normalized spectrum)
    singular_values: torch.Tensor


def singular_values(w) -> torch.Tensor:
    """Singular values of ``w``, descending, in float32."""
    return torch.linalg.svdvals(torch.as_tensor(w).float())


def analyze(w) -> SpectralStats:
    """Spectral stats of a (m x n) or (n x m) transformation matrix."""
    s = singular_values(w)
    smax = s[0]
    smin = s[-1]
    p = s / (torch.sum(s) + 1e-30)
    eff_rank = torch.exp(-torch.sum(p * torch.log(p + 1e-30)))
    return SpectralStats(
        sigma_max=smax,
        sigma_min=smin,
        condition_number=smax / torch.clamp(smin, min=1e-30),
        frobenius=torch.sqrt(torch.sum(torch.square(s))),
        effective_rank=eff_rank,
        singular_values=s,
    )


def condition_number(w) -> torch.Tensor:
    s = singular_values(w)
    return s[0] / torch.clamp(s[-1], min=1e-30)
