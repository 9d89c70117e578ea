"""Operational form of the paper's theory (Section 3.3 + Appendix A).

The reference's ``core/theory.py`` on PyTorch tensors:

* Rayleigh quotient R(M, x) and its eigenvalue bounds (Eq. 12-13).
* The singular-value norm bound  sigma_min ||x|| <= ||Wx|| <= sigma_max ||x||
  (Eq. 15), checked empirically.
* The k-NN preservation *certificate* from Eq. 16: for an anchor a with
  neighbor i and non-neighbor j, if  d(a,j) / d(a,i) > kappa(W)  then the
  order d(Wa,Wi) <= d(Wa,Wj) is provably preserved. ``certified_fraction``
  reports how many (i, j) relations the bound certifies.
* :class:`DriftTracker`: the serving-time form of Eq. 15, a streaming
  monitor that counts incoming vectors whose norm distortion
  ``||Wx|| / ||x||`` escapes the trained ``[sigma_min, sigma_max]`` band,
  and trips a retrain signal when the violation rate says the live
  distribution has drifted off the manifold the reducer was fitted on.

``w`` maps R^n -> R^m as f(x) = W x, so it has shape [m, n] (the RAE's
``core.rae.encoder_matrix``). The checks run on the tensors' device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .spectral import singular_values


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).float()


def rayleigh_quotient(m, x) -> torch.Tensor:
    """R(M, x) = x^T M x / x^T x for symmetric M (Eq. 12)."""
    x = _f32(x)
    num = torch.einsum("...i,ij,...j->...", x, _f32(m).to(x.device), x)
    den = torch.einsum("...i,...i->...", x, x)
    return num / torch.clamp(den, min=1e-30)


def norm_upper_bound_holds(w, xs, rtol: float = 1e-4) -> torch.Tensor:
    """||Wx|| <= sigma_max ||x|| (Eq. 15 upper half): holds for ALL x."""
    w = _f32(w)
    s = singular_values(w)
    xs = _f32(xs).to(w.device)
    xn = torch.linalg.norm(xs, dim=-1)
    wn = torch.linalg.norm(xs @ w.T, dim=-1)
    return torch.all(wn <= s[0] * xn * (1 + rtol) + 1e-6)


def norm_bounds_hold(w, xs, rtol: float = 1e-3) -> torch.Tensor:
    """Verify Eq. 15 on a batch: sigma_min||x|| <= ||Wx|| <= sigma_max||x||.

    For a wide W in R^{m x n} (m < n) W has a nullspace, so the lower bound
    with sigma_min = the smallest NONZERO singular value only holds for x
    in row(W). The lower bound is checked on each x's row-space projection
    (the component W acts on); the upper bound is global."""
    w32 = _f32(w)
    s = singular_values(w32)
    smax, smin = s[0], s[-1]
    xs = _f32(xs).to(w32.device)
    # project onto row(W): P = W^+ W = V_r V_r^T (via SVD)
    _, _, vt = torch.linalg.svd(w32, full_matrices=False)
    xr = (xs @ vt.T) @ vt
    xn = torch.linalg.norm(xr, dim=-1)
    wn = torch.linalg.norm(xr @ w32.T, dim=-1)
    upper_all = norm_upper_bound_holds(w32, xs, rtol)
    lower = torch.all(wn >= smin * xn * (1 - rtol) - 1e-6)
    upper = torch.all(wn <= smax * xn * (1 + rtol) + 1e-6)
    return upper_all & lower & upper


def empirical_distortion(w, xs) -> dict[str, torch.Tensor]:
    """Observed ||Wx||/||x|| extremes vs the singular-value bounds."""
    w = _f32(w)
    s = singular_values(w)
    xs = _f32(xs).to(w.device)
    ratio = (torch.linalg.norm(xs @ w.T, dim=-1)
             / torch.clamp(torch.linalg.norm(xs, dim=-1), min=1e-30))
    return {
        "ratio_max": ratio.max(),
        "ratio_min": ratio.min(),
        "sigma_max": s[0],
        "sigma_min": s[-1],
        "kappa": s[0] / torch.clamp(s[-1], min=1e-30),
    }


def certified_fraction(w, x, k: int) -> torch.Tensor:
    """Fraction of (neighbor, non-neighbor) relations certified by Eq. 16.

    For each anchor with k-NN distances d_i and the distances d_j of every
    farther row: the relation is certified iff d_j / d_(k) > kappa(W),
    with d_(k) the k-th nearest distance (the binding constraint). The k
    nearest come from a stable sort. ``x`` is [N, n]; the [N, N] distance
    matrix is made in one piece, as in the reference."""
    x = _f32(x)
    n = x.shape[0]
    sq = torch.sum(x * x, 1)
    d2 = sq[:, None] - 2 * x @ x.T + sq[None, :]
    d2 = torch.clamp(d2, min=0.0) + torch.eye(n, device=x.device) * 1e30
    d = torch.sqrt(d2)
    kth = torch.sort(d, dim=1, stable=True).values[:, k - 1:k]
    s = singular_values(_f32(w).to(x.device))
    kappa = s[0] / torch.clamp(s[-1], min=1e-30)
    far_mask = d > kth
    certified = (d / torch.clamp(kth, min=1e-30) > kappa) & far_mask
    return torch.sum(certified) / torch.clamp(torch.sum(far_mask), min=1)


@dataclass
class DriftTracker:
    """Streaming Eq. 15 monitor for live index mutation.

    At fit time the reducer's singular values bound every in-distribution
    vector's norm distortion: ``sigma_min ||x|| <= ||Wx|| <= sigma_max
    ||x||`` (lower half exact on row(W)). Streamed inserts that land OFF
    that manifold show up as ratios escaping the band. ``observe`` is host
    numpy on the two per-row norm vectors, so the caller takes the norms
    where the rows live (on the card) and copies only ``[b]`` floats.

    ``tol`` widens the band; ``threshold`` is the violation rate that trips
    ``should_retrain``; ``min_observed`` stops a handful of early outliers
    from forcing a retrain.
    """

    sigma_min: float
    sigma_max: float
    tol: float = 0.05
    threshold: float = 0.10
    min_observed: int = 64
    observed: int = 0
    violations: int = 0

    @classmethod
    def from_weights(cls, w, tol: float = 0.05, threshold: float = 0.10,
                     min_observed: int = 64) -> "DriftTracker":
        """Band from the reducer's weight matrix (Eq. 15 verbatim)."""
        s = singular_values(w).cpu().numpy()
        return cls(sigma_min=float(s[-1]), sigma_max=float(s[0]), tol=tol,
                   threshold=threshold, min_observed=min_observed)

    def observe_norms(self, xn: np.ndarray, zn: np.ndarray) -> float:
        """Fold a batch of row norms (``||x||``, ``||Wx||``, float32 [b])
        into the monitor. Returns this batch's violation fraction; the
        cumulative rate is ``violation_rate``. Zero-norm rows are skipped
        (no ratio)."""
        xn = np.asarray(xn, np.float32)
        zn = np.asarray(zn, np.float32)
        ok = xn > 1e-12
        ratio = zn[ok] / xn[ok]
        lo = self.sigma_min * (1.0 - self.tol)
        hi = self.sigma_max * (1.0 + self.tol)
        bad = int(np.sum((ratio < lo) | (ratio > hi)))
        self.observed += int(ratio.shape[0])
        self.violations += bad
        return bad / max(ratio.shape[0], 1)

    def observe(self, xs, zs) -> float:
        """Fold a batch of (original, reduced) vectors into the monitor,
        as the reference's ``observe``: the norms are taken where the rows
        live (a tensor's device, or numpy) and only they reach the host."""
        return self.observe_norms(_row_norms(xs), _row_norms(zs))

    @property
    def violation_rate(self) -> float:
        return self.violations / max(self.observed, 1)

    @property
    def should_retrain(self) -> bool:
        """True once enough stream has been seen AND the violation rate
        clears the threshold: the reducer-retrain trigger."""
        return (self.observed >= self.min_observed
                and self.violation_rate > self.threshold)

    def reset(self) -> None:
        """Forget the stream (called after a retrain swaps the band)."""
        self.observed = 0
        self.violations = 0


def _row_norms(a) -> np.ndarray:
    """float32 L2 norm of each row, as a host array."""
    if isinstance(a, torch.Tensor):
        return torch.linalg.norm(a.float(), dim=-1).cpu().numpy()
    return np.linalg.norm(np.asarray(a, np.float32), axis=-1)
