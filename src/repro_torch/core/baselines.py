"""Baseline DR methods the paper compares against (Table 1).

The reference's ``core/baselines.py``. The fits are its host numpy, line
for line (the SVD, the ``eigh``, the ``lstsq``, the smooth-kNN search and
UMAP's SGD with its ``default_rng`` draws), so from the same inputs the
fitted state is the reference's bit for bit; the one step on a device is
Isomap's min-plus squaring (:func:`_minplus_square_chunked`), whose every
entry is one float32 add per pair and a min, so its geodesics are the
same bits on every device.

* PCA            — Pearson 1901 / Wold 1987: SVD of the centered data.
* GaussianRP     — Achlioptas 2001 (JL): data-independent random projection.
* MDS + linreg   — classical (Torgerson) MDS on the training Gram matrix +
                   linear-regression out-of-sample extension (Chen 2015;
                   Trosset & Priebe 2008).
* Isomap         — Tenenbaum 2000: k-NN graph -> geodesics (min-plus matrix
                   squaring) -> classical MDS; same linreg extension.
* UMAP-lite      — McInnes & Healy 2018: fuzzy k-NN graph (smooth-kNN sigma
                   search), spectral init, attract/repulse SGD with the
                   standard (a, b) curve; out-of-sample via kNN-weighted
                   average of train embeddings.

All expose ``fit(train_X)`` then ``transform(X)``: ``[N, n] -> [N, m]``.
``transform`` takes a tensor (or numpy, then on the CPU) and returns a
float32 tensor on its device. The four affine maps (PCA, RP, MDS, Isomap)
run their product through the ``rae_encode`` op (the hand-written kernel
on the card, its plain version on the CPU): PCA's centring and the
intercept row of MDS / Isomap are separate element-wise steps. The fitted
arrays stay numpy (saved, fingerprinted) and are uploaded once per device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.rae_encode import rae_encode

#: Most bytes one chunk of the min-plus squaring's ``[c, n, n]`` temporary
#: may take.
MINPLUS_BYTES = 1 << 31


class _DeviceArrays:
    """Per-device copies of a fitted dataclass's arrays, made on first use
    and dropped by ``fit``. Kept outside the dataclass fields, so they are
    neither saved nor hashed."""

    def _on(self, name: str, device: torch.device) -> torch.Tensor:
        cache = self.__dict__.setdefault("_dev", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(
                np.ascontiguousarray(getattr(self, name), np.float32),
                device=device)
        return cache[key]

    def _fitted(self) -> None:
        self.__dict__["_dev"] = {}


def _as_input(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _affine(self: _DeviceArrays, x, w_name: str) -> torch.Tensor:
    """``[x, 1] @ w`` for an ``[n + 1, m]`` weight with its intercept as the
    last row: the ``rae_encode`` GEMM over the first n rows, then the
    intercept added."""
    x = _as_input(x)
    w = self._on(w_name, x.device)
    return rae_encode(x, w[:-1].contiguous(), normalize=False) + w[-1]


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------
@dataclass
class PCA(_DeviceArrays):
    out_dim: int
    mean_: Optional[np.ndarray] = None
    components_: Optional[np.ndarray] = None  # [n, m]
    singular_values_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "PCA":
        x = np.asarray(x, np.float32)
        self.mean_ = x.mean(0)
        xc = x - self.mean_
        u, s, vt = np.linalg.svd(xc, full_matrices=False)
        self.components_ = vt[: self.out_dim].T.astype(np.float32)
        self.singular_values_ = s[: self.out_dim]
        self._fitted()
        return self

    def transform(self, x) -> torch.Tensor:
        x = _as_input(x)
        return rae_encode(x - self._on("mean_", x.device),
                          self._on("components_", x.device),
                          normalize=False)


# ---------------------------------------------------------------------------
# Gaussian random projection (JL)
# ---------------------------------------------------------------------------
@dataclass
class GaussianRP(_DeviceArrays):
    out_dim: int
    seed: int = 0
    w_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "GaussianRP":
        n = x.shape[1]
        rng = np.random.default_rng(self.seed)
        self.w_ = rng.normal(0.0, 1.0 / np.sqrt(self.out_dim),
                             size=(n, self.out_dim)).astype(np.float32)
        self._fitted()
        return self

    def transform(self, x) -> torch.Tensor:
        x = _as_input(x)
        return rae_encode(x, self._on("w_", x.device), normalize=False)


# ---------------------------------------------------------------------------
# Classical MDS + linear out-of-sample extension
# ---------------------------------------------------------------------------
def _classical_mds_from_d2(d2: np.ndarray, m: int) -> np.ndarray:
    """Torgerson MDS: double-center the squared-distance matrix, top-m eig."""
    n = d2.shape[0]
    j = np.eye(n, dtype=np.float64) - np.full((n, n), 1.0 / n)
    b = -0.5 * j @ d2.astype(np.float64) @ j
    w, v = np.linalg.eigh(b)
    order = np.argsort(w)[::-1][:m]
    w = np.maximum(w[order], 0.0)
    return (v[:, order] * np.sqrt(w)[None, :]).astype(np.float32)


@dataclass
class MDSLinear(_DeviceArrays):
    out_dim: int
    max_train: int = 2304  # O(N^3); paper capped MDS at 5000 samples
    w_: Optional[np.ndarray] = None  # [n+1, m] linreg with intercept

    def fit(self, x: np.ndarray) -> "MDSLinear":
        x = np.asarray(x, np.float32)
        if x.shape[0] > self.max_train:
            rng = np.random.default_rng(0)
            x = x[rng.choice(x.shape[0], self.max_train, replace=False)]
        sq = np.sum(x * x, 1)
        d2 = np.maximum(sq[:, None] - 2 * x @ x.T + sq[None, :], 0)
        y = _classical_mds_from_d2(d2, self.out_dim)
        xa = np.concatenate([x, np.ones((x.shape[0], 1), np.float32)], 1)
        self.w_, *_ = np.linalg.lstsq(xa, y, rcond=None)
        self._fitted()
        return self

    def transform(self, x) -> torch.Tensor:
        return _affine(self, x, "w_")


# ---------------------------------------------------------------------------
# Isomap (geodesic MDS) + linreg extension
# ---------------------------------------------------------------------------
def _minplus_square_chunked(d: torch.Tensor, chunk: int = 256
                            ) -> torch.Tensor:
    """One tropical-semiring squaring, d'_ij = min_k d_ik + d_kj, in row
    chunks on ``d``'s device. ``chunk`` shrinks so that a chunk's
    ``[c, n, n]`` temporary stays within :data:`MINPLUS_BYTES`."""
    n = d.shape[0]
    chunk = max(1, min(chunk, MINPLUS_BYTES // max(1, 4 * n * n)))
    rows = []
    for i in range(0, n, chunk):
        blk = d[i:i + chunk]  # [c, n]
        rows.append(torch.amin(blk[:, :, None] + d[None, :, :], dim=1))
    return torch.cat(rows, 0)


def geodesics(g: np.ndarray, device: str | torch.device = "cuda"
              ) -> np.ndarray:
    """All-pairs shortest paths of the kNN graph ``g`` ([n, n] float32,
    ``inf`` = no edge) by ceil(log2(n)) min-plus squarings on ``device``;
    a host array."""
    n = g.shape[0]
    gd = torch.as_tensor(g, device=device)
    for _ in range(int(np.ceil(np.log2(max(n, 2))))):
        gd = _minplus_square_chunked(gd)
    return gd.cpu().numpy()


@dataclass
class Isomap(_DeviceArrays):
    out_dim: int
    n_neighbors: int = 10
    max_train: int = 1536
    w_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, device: str | torch.device = "cuda"
            ) -> "Isomap":
        """``device`` runs the geodesics' min-plus squaring; the rest is
        host numpy."""
        x = np.asarray(x, np.float32)
        if x.shape[0] > self.max_train:
            rng = np.random.default_rng(0)
            x = x[rng.choice(x.shape[0], self.max_train, replace=False)]
        n = x.shape[0]
        g = self.knn_graph(x)
        gd = geodesics(g, device)
        finite_max = np.nanmax(np.where(np.isfinite(gd), gd, np.nan))
        gd = np.where(np.isfinite(gd), gd, finite_max)  # disconnected comps
        y = _classical_mds_from_d2(gd ** 2, self.out_dim)
        xa = np.concatenate([x, np.ones((n, 1), np.float32)], 1)
        self.w_, *_ = np.linalg.lstsq(xa, y, rcond=None)
        self._fitted()
        return self

    def knn_graph(self, x: np.ndarray) -> np.ndarray:
        """The symmetric kNN graph of the (subsampled) training rows, zero
        diagonal, ``inf`` off the graph."""
        n = x.shape[0]
        sq = np.sum(x * x, 1)
        d = np.sqrt(np.maximum(sq[:, None] - 2 * x @ x.T + sq[None, :], 0))
        idx = np.argpartition(d, self.n_neighbors + 1,
                              axis=1)[:, : self.n_neighbors + 1]
        g = np.full((n, n), np.inf, np.float32)
        rows = np.repeat(np.arange(n), idx.shape[1])
        g[rows, idx.ravel()] = d[rows, idx.ravel()]
        g = np.minimum(g, g.T)
        np.fill_diagonal(g, 0.0)
        return g

    def transform(self, x) -> torch.Tensor:
        return _affine(self, x, "w_")


# ---------------------------------------------------------------------------
# UMAP-lite
# ---------------------------------------------------------------------------
@dataclass
class UMAPLite(_DeviceArrays):
    out_dim: int
    n_neighbors: int = 15
    n_epochs: int = 100
    lr: float = 1.0
    neg_samples: int = 5
    a: float = 1.576943  # standard UMAP curve params for min_dist=0.1
    b: float = 0.8950609
    seed: int = 0
    max_train: int = 4096
    train_x_: Optional[np.ndarray] = None
    embedding_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "UMAPLite":
        x = np.asarray(x, np.float32)
        if x.shape[0] > self.max_train:
            rng = np.random.default_rng(0)
            x = x[rng.choice(x.shape[0], self.max_train, replace=False)]
        self.train_x_ = x
        n, k = x.shape[0], self.n_neighbors
        sq = np.sum(x * x, 1)
        d = np.sqrt(np.maximum(sq[:, None] - 2 * x @ x.T + sq[None, :], 0))
        np.fill_diagonal(d, np.inf)
        knn_idx = np.argpartition(d, k, axis=1)[:, :k]
        knn_d = np.take_along_axis(d, knn_idx, 1)
        # smooth-kNN: per-point sigma s.t. sum exp(-(d - rho)/sigma) = log2(k)
        rho = knn_d.min(1, keepdims=True)
        target = np.log2(k)
        sigma = np.ones((n, 1), np.float32)
        lo, hi = np.zeros((n, 1), np.float32), np.full((n, 1), 1e4, np.float32)
        for _ in range(32):
            val = np.exp(-np.maximum(knn_d - rho, 0) / sigma).sum(1, keepdims=True)
            hi = np.where(val > target, sigma, hi)
            lo = np.where(val <= target, sigma, lo)
            sigma = np.where(val > target, (lo + sigma) / 2,
                             np.minimum((sigma + hi) / 2, sigma * 2))
        w = np.exp(-np.maximum(knn_d - rho, 0) / sigma)  # [n, k]
        # symmetrize: P = W + W^T - W∘W^T  (probabilistic t-conorm)
        p = np.zeros((n, n), np.float32)
        rows = np.repeat(np.arange(n), k)
        p[rows, knn_idx.ravel()] = w.ravel()
        p = p + p.T - p * p.T
        # spectral init from the symmetric normalized Laplacian
        deg = p.sum(1)
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        lap = np.eye(n, dtype=np.float32) - (dinv[:, None] * p * dinv[None, :])
        ew, ev = np.linalg.eigh(lap)
        y = ev[:, 1: self.out_dim + 1].astype(np.float32)
        y = y / max(np.abs(y).max(), 1e-12) * 10.0
        # edge list for SGD
        ei, ej = np.nonzero(p > 0)
        pw = p[ei, ej]
        pw = pw / pw.max()
        rng = np.random.default_rng(self.seed)
        a_, b_ = self.a, self.b
        for epoch in range(self.n_epochs):
            alpha = self.lr * (1.0 - epoch / self.n_epochs)
            keep = rng.random(len(ei)) < pw
            src, dst = ei[keep], ej[keep]
            diff = y[src] - y[dst]
            d2 = np.sum(diff * diff, 1, keepdims=True)
            # attractive gradient of log(1/(1+a d^{2b}))
            ga = (-2.0 * a_ * b_ * d2 ** (b_ - 1)) / (1.0 + a_ * d2 ** b_)
            grad = np.clip(ga * diff, -4, 4)
            np.add.at(y, src, alpha * grad)
            np.add.at(y, dst, -alpha * grad)
            # repulsive: negative samples
            for _ in range(self.neg_samples):
                neg = rng.integers(0, n, size=len(src))
                diff = y[src] - y[neg]
                d2 = np.sum(diff * diff, 1, keepdims=True) + 1e-3
                gr = (2.0 * b_) / (d2 * (1.0 + a_ * d2 ** b_))
                grad = np.clip(gr * diff, -4, 4)
                np.add.at(y, src, alpha * grad)
        self.embedding_ = y
        self._fitted()
        return self

    def transform(self, x) -> torch.Tensor:
        """Out-of-sample: kNN-weighted average of train embeddings, plain
        PyTorch on x's device. Ties at the k-th distance may pick another
        neighbour set than the reference's ``argpartition``; the weights
        then only reorder a sum."""
        x = _as_input(x)
        t = self._on("train_x_", x.device)
        sq = torch.sum(x * x, 1)[:, None]
        st = torch.sum(t * t, 1)[None, :]
        d = torch.sqrt(torch.clamp(sq - 2 * x @ t.T + st, min=0))
        k = min(self.n_neighbors, t.shape[0])
        dk, idx = torch.topk(d, k, dim=1, largest=False)
        w = 1.0 / torch.clamp(dk, min=1e-6)
        w = w / w.sum(1, keepdim=True)
        return torch.einsum("qk,qkm->qm", w,
                            self._on("embedding_", x.device)[idx])


def make_baseline(name: str, out_dim: int, **kw):
    table = {"pca": PCA, "rp": GaussianRP, "mds": MDSLinear,
             "isomap": Isomap, "umap": UMAPLite}
    return table[name](out_dim=out_dim, **kw)
