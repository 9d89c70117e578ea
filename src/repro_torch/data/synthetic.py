"""Synthetic embedding corpora and model batches (numpy; the same seed gives
the same bytes as the reference package's ``data/synthetic.py``, whose code
this copies).

``embedding_corpus`` is the paper-dataset analogue: anisotropic low-rank
Gaussian mixture with a power-law singular spectrum and per-cluster rotations.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# The paper's four datasets, by embedding dimension.
PAPER_DATASETS = {
    "imagenet_like": dict(dim=384, n_clusters=24, intrinsic=96),
    "celeba_like": dict(dim=512, n_clusters=16, intrinsic=128),
    "imdb_like": dict(dim=768, n_clusters=8, intrinsic=160),
    "flickr_like": dict(dim=1024, n_clusters=12, intrinsic=224),
}


def embedding_corpus(
    n: int,
    dim: int,
    n_clusters: int = 8,
    intrinsic: Optional[int] = None,
    spectrum_decay: float = 0.7,
    noise: float = 0.02,
    normalize: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """[n, dim] float32 embeddings: mixture of rotated low-rank Gaussians."""
    return _mixture(n, 0, dim, n_clusters, intrinsic, spectrum_decay, noise,
                    normalize, seed)[0]


def embedding_corpus_with_holdout(
    n: int,
    holdout: int,
    dim: int,
    n_clusters: int = 8,
    intrinsic: Optional[int] = None,
    spectrum_decay: float = 0.7,
    noise: float = 0.02,
    normalize: bool = False,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """``embedding_corpus(n, ...)`` byte for byte, and ``holdout`` rows more
    of the same mixture (the same shared basis, cluster bases and centres)
    drawn from a generator of their own (seeded ``seed + 1``): rows of the
    corpus' distribution that the corpus does not hold. A cluster the
    corpus drew empty gives no held-out rows, so there may be fewer."""
    return _mixture(n, holdout, dim, n_clusters, intrinsic, spectrum_decay,
                    noise, normalize, seed)


def _mixture(n, holdout, dim, n_clusters, intrinsic, spectrum_decay, noise,
             normalize, seed) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    hrng = np.random.default_rng(seed + 1)
    r = intrinsic or max(dim // 4, 8)
    # One dominant anisotropic spectrum shared across the corpus; clusters
    # are centers within the dominant subspace plus small per-cluster basis
    # perturbations.
    spec = (np.arange(1, r + 1, dtype=np.float32) ** (-spectrum_decay))
    shared, _ = np.linalg.qr(rng.normal(size=(dim, r)).astype(np.float32))
    out = np.empty((n, dim), np.float32)
    held = np.empty((holdout, dim), np.float32)
    sizes = rng.multinomial(n, np.ones(n_clusters) / n_clusters)
    held_sizes = hrng.multinomial(holdout, np.ones(n_clusters) / n_clusters)
    start = held_start = 0
    for c, sz in enumerate(sizes):
        if sz == 0:
            continue
        # mild per-cluster rotation of the shared basis
        pert = rng.normal(scale=0.15, size=(dim, r)).astype(np.float32)
        basis, _ = np.linalg.qr(shared + pert)
        # centers live in the dominant half of the shared subspace
        cz = np.zeros(r, np.float32)
        cz[: max(r // 2, 1)] = rng.normal(
            scale=1.5, size=max(r // 2, 1)) * spec[: max(r // 2, 1)]
        center = shared @ cz
        for g, m, at, dst in ((rng, sz, start, out),
                              (hrng, held_sizes[c], held_start, held)):
            z = g.normal(size=(m, r)).astype(np.float32) * spec[None, :]
            x = z @ basis.T + center[None, :]
            x += g.normal(scale=noise, size=x.shape).astype(np.float32)
            dst[at:at + m] = x
        start += sz
        held_start += held_sizes[c]
    rng.shuffle(out)
    held = held[:held_start]   # a cluster the corpus drew empty holds none
    hrng.shuffle(held)
    if normalize:
        out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
        held /= np.maximum(np.linalg.norm(held, axis=1, keepdims=True),
                           1e-12)
    return out, held


def paper_dataset(name: str, n: int, seed: int = 0, **overrides) -> np.ndarray:
    kw = dict(PAPER_DATASETS[name])
    kw.update(overrides)
    return embedding_corpus(n=n, seed=seed, **kw)


def paper_dataset_with_holdout(name: str, n: int, holdout: int,
                               seed: int = 0, **overrides
                               ) -> tuple[np.ndarray, np.ndarray]:
    """``paper_dataset(name, n, seed)`` and ``holdout`` further rows of the
    same mixture (:func:`embedding_corpus_with_holdout`)."""
    kw = dict(PAPER_DATASETS[name])
    kw.update(overrides)
    return embedding_corpus_with_holdout(n=n, holdout=holdout, seed=seed,
                                         **kw)


def train_test_split(x: np.ndarray, test_frac: float = 0.1, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The paper's 9:1 split."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(x.shape[0])
    n_test = int(round(x.shape[0] * test_frac))
    return x[idx[n_test:]], x[idx[:n_test]]


def token_batch(batch: int, seq: int, vocab: int, seed: int = 0) -> dict:
    """Zipfian token ids ``[batch, seq]`` and their next-token targets."""
    rng = np.random.default_rng(seed)
    # zipfian token distribution (realistic softmax pressure)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    toks = rng.choice(vocab, size=(batch, seq + 1), p=p).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def recsys_batch(batch: int, table_vocabs: dict[str, int], hist_len: int = 0,
                 n_fields: int = 0, field_vocab: int = 200_000,
                 seed: int = 0) -> dict:
    """One id a table a row, a history bag of ``hist_len`` ids with live
    lengths uniform in ``1..hist_len``, field ids, and labels."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for name, vocab in table_vocabs.items():
        out[name] = rng.integers(0, vocab, batch).astype(np.int32)
    if hist_len:
        vocab = table_vocabs.get("item", table_vocabs.get("hist_item", 1000))
        out["hist"] = rng.integers(0, vocab, (batch, hist_len)).astype(np.int32)
        out["hist_len"] = rng.integers(1, hist_len + 1, batch).astype(np.int32)
    if n_fields:
        out["fields"] = rng.integers(0, field_vocab,
                                     (batch, n_fields)).astype(np.int32)
    out["label"] = (rng.random(batch) < 0.2).astype(np.float32)
    return out
