"""Quantized storage codecs for the search tiers: SQ8 + PQ (with ADC).

The reference's ``search/quantize.py`` on PyTorch tensors. Two codecs, both
trading bytes per vector for a small, bounded recall loss:

* **SQ8**: per-dim min/max scalar quantization to uint8. The scan never
  decodes: ``|q - x_hat|^2 = |q|^2 - 2 q.vmin - 2 (q*step).codes +
  |x_hat|^2`` needs a dot of the pre-scaled query with the raw codes and the
  per-row ``|x_hat|^2`` kept at encode time.
* **PQ{m}x{bits}**: product quantization. d splits into m subspaces, each
  with a k-means codebook of ``2^bits`` centroids; a vector stores one
  uint8 code per subspace. Search uses ADC: a per-query LUT of exact
  query-to-centroid distances, summed by code.

Codes stay ``torch.uint8`` on the device. The reference widens them to
int32 only for TPU tiling; here that would make every gather four times
wider, and the gather is what the tier exists to shrink.

Differences from the reference, each kept out of the answers:

* :func:`adc_lut` (the one home of the LUT formula: the flat ``pq_adc``
  scan's plain version, the IVF-PQ probe and the graph codec all call it)
  sums over ``dsub`` with ``kernels/graph_beam/ref.py:pairwise_sum``, a
  fixed tree, so a row's LUT does not depend on its batch-mates and the
  CUDA kernels reproduce it bit for bit. Sums over ``m`` and the SQ8
  reconstruction norms use the same tree.
* :func:`pq_train` seeds each subspace's k-means from
  ``numpy.random.default_rng(seed + mm)`` (``search/ivf.py:init_rows``):
  torch cannot reproduce ``jax.random.choice``. ``init=`` takes the m row
  draws explicitly (the parity tests pass the reference's).
* The scans run in chunks (corpus rows for :func:`sq8_scan`, queries under
  :data:`~repro_torch.search.ivf.SLAB_BYTES` for the IVF probes). The flat
  scans pick their top-k by a stable descending sort, which keeps
  ``lax.top_k``'s lower-index ties; the IVF probes rank by (score
  descending, corpus id ascending), where the reference ranks ties by slab
  position (``ROADMAP.md`` C8). Rows are independent, so chunking changes
  no answer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.graph_beam.ref import pairwise_sum
from .ivf import SLAB_BYTES, kmeans, topk_by_score_then_id

#: Most bytes of float scores or decoded codes one flat-scan chunk holds.
SCAN_BYTES = 1 << 30

#: Corpus rows :func:`pq_encode` scores against the codebooks at once.
_ENCODE_CHUNK = 32768


def _topk_stable(s: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of each row by a stable descending sort: ties to the
    lower column, as ``lax.top_k``."""
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, order), order


def topk_over_rows(score, n: int, rows: int, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best (score, row) pairs per query (``k <= n``) of
    ``score(start, stop)`` -> [Q, stop - start], taken over chunks of
    ``rows`` corpus rows and merged; ties to the lower row. Returns (vals
    [Q, k], rows [Q, k] int32)."""
    vals, ids = [], []
    for s in range(0, n, rows):
        v, i = _topk_stable(score(s, min(s + rows, n)), min(k, rows, n - s))
        vals.append(v)
        ids.append(i + s)
    if len(vals) == 1:
        return vals[0], ids[0].to(torch.int32)
    # chunks in row order: the stable sort keeps lower rows first on ties
    v, j = _topk_stable(torch.cat(vals, dim=1), k)
    return v, torch.gather(torch.cat(ids, dim=1), 1, j).to(torch.int32)


# ---------------------------------------------------------------------------
# SQ8: per-dim min/max scalar quantization
# ---------------------------------------------------------------------------
@dataclass
class ScalarQuantizer:
    """Per-dim affine codebook: ``decode(c) = vmin + c * step``, c in
    0..255."""

    vmin: torch.Tensor   # [d]
    step: torch.Tensor   # [d], >= 1e-12 so constant dims round-trip


def sq8_train(x: torch.Tensor) -> ScalarQuantizer:
    """Fit per-dim [min, max] on the corpus; 256 uniform levels per dim."""
    x = x.float()
    vmin = torch.amin(x, dim=0)
    vmax = torch.amax(x, dim=0)
    # a tensor divisor: on the card, division by a host scalar multiplies
    # by its rounded reciprocal, an ulp off the reference's quotient
    step = torch.clamp((vmax - vmin) / torch.full_like(vmin, 255.0),
                       min=1e-12)
    return ScalarQuantizer(vmin=vmin, step=step)


def sq8_encode(sq: ScalarQuantizer, x: torch.Tensor) -> torch.Tensor:
    """f32 [N, d] -> uint8 codes [N, d]; round half to even, clipped."""
    c = torch.round((x.float() - sq.vmin[None, :]) / sq.step[None, :])
    return torch.clamp(c, 0, 255).to(torch.uint8)


def sq8_decode(sq: ScalarQuantizer, codes: torch.Tensor) -> torch.Tensor:
    return sq.vmin[None, :] + codes.float() * sq.step[None, :]


def sq8_recon_sq_norms(sq: ScalarQuantizer, codes: torch.Tensor
                       ) -> torch.Tensor:
    """``|decode(codes)|^2`` per row: the scan-time constant term."""
    dec = sq8_decode(sq, codes)
    return pairwise_sum(dec * dec)


def sq8_scan(vmin: torch.Tensor, step: torch.Tensor, q: torch.Tensor,
             codes: torch.Tensor, recon_sq: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequant-free exact asymmetric top-k over SQ8 codes (``k <= N``).

    Returns (scores [Q, k], indices [Q, k] int32); scores =
    ``-|q - decode(c)|^2`` (higher = closer). The corpus is scanned in
    chunks of rows, each a ``torch.matmul`` with the codes cast to float."""
    q = q.float()
    n, d = codes.shape
    qdotmin = q @ vmin                                   # [Q]
    qs = q * step[None, :]
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)

    def score(a, b):
        return (2.0 * (qdotmin[:, None] + qs @ codes[a:b].float().T)
                - recon_sq[None, a:b] - q_sq)

    rows = max(1, SCAN_BYTES // (4 * (d + max(q.shape[0], 1))))
    return topk_over_rows(score, n, rows, k)


def _probe_cells(q: torch.Tensor, centroids: torch.Tensor, nprobe: int
                 ) -> torch.Tensor:
    """[Q, nprobe] nearest cells, ties to the lower cell."""
    d2c = (torch.sum(q * q, 1)[:, None] - 2 * q @ centroids.T
           + torch.sum(centroids * centroids, 1)[None, :])
    return torch.sort(-d2c, dim=1, descending=True,
                      stable=True).indices[:, :nprobe]


def _probe_topk(s: torch.Tensor, ids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the flattened ``[q, P * cap]`` slab by (score descending,
    id ascending); -inf slots get id -1."""
    v, idx = topk_by_score_then_id(s.reshape(s.shape[0], -1),
                                   ids.reshape(s.shape[0], -1), k)
    return v, torch.where(torch.isfinite(v), idx, torch.full_like(idx, -1))


def _chunked(q: torch.Tensor, per_query: int, k: int, fn
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``fn(start, stop)`` over query chunks whose slab stays within
    ``SLAB_BYTES`` and concatenate the (vals, ids) pairs."""
    step = max(1, SLAB_BYTES // max(1, per_query))
    out = [fn(s, s + step) for s in range(0, q.shape[0], step)]
    if not out:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def ivf_sq8_search(centroids: torch.Tensor, lists: torch.Tensor,
                   codes: torch.Tensor, recon_sq: torch.Tensor,
                   mask: torch.Tensor, vmin: torch.Tensor, step: torch.Tensor,
                   q: torch.Tensor, k: int, nprobe: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF probe scan over SQ8 list payloads (padded-dense layout).

    ``codes`` [C, cap, d] uint8, ``recon_sq`` [C, cap], ``lists``/``mask``
    as in :class:`~repro_torch.search.ivf.IVFIndex`. Masked slots score
    ``-inf`` and come out with id -1."""
    q = q.float()
    cells = _probe_cells(q, centroids, nprobe)
    cap, d = codes.shape[1:]
    qdotmin = q @ vmin
    qs = q * step[None, :]
    q_sq = torch.sum(q * q, -1)

    def scan(a, b):
        cc = cells[a:b]
        cf = codes[cc].float()                           # [q, P, cap, d]
        s = (2.0 * (qdotmin[a:b, None, None]
                    + torch.einsum("qd,qpcd->qpc", qs[a:b], cf))
             - recon_sq[cc] - q_sq[a:b, None, None])
        del cf
        s = torch.where(mask[cc], s, torch.full_like(s, float("-inf")))
        return _probe_topk(s, lists[cc], k)

    return _chunked(q, nprobe * cap * d * 4, k, scan)


# ---------------------------------------------------------------------------
# PQ: product quantization with ADC
# ---------------------------------------------------------------------------
@dataclass
class ProductQuantizer:
    """``m`` subspace codebooks of ``ksub`` centroids each (dsub = d // m)."""

    codebooks: torch.Tensor   # [m, ksub, dsub] f32

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def ksub(self) -> int:
        return int(self.codebooks.shape[1])

    @property
    def dsub(self) -> int:
        return int(self.codebooks.shape[2])


def pq_train(x: torch.Tensor, m: int, bits: int = 8, iters: int = 15,
             seed: int = 0, init: Optional[Sequence[np.ndarray]] = None
             ) -> ProductQuantizer:
    """Independent k-means per subspace. ``d % m == 0`` required; the
    centroid count is ``min(2**bits, n)`` so tiny corpora still train.
    Subspace ``mm`` starts from ``init[mm]`` rows, or from the port's
    numpy draw of seed ``seed + mm``."""
    x = x.float()
    n, d = x.shape
    if d % m:
        raise ValueError(f"PQ: dim {d} not divisible by m={m}")
    if not 1 <= bits <= 8:
        raise ValueError(f"PQ: bits must be in 1..8, got {bits}")
    if init is not None and len(init) != m:
        raise ValueError(f"PQ: init needs one row draw per subspace ({m}), "
                         f"got {len(init)}")
    ksub = min(2 ** bits, n)
    dsub = d // m
    books = []
    for mm in range(m):
        sub = x[:, mm * dsub:(mm + 1) * dsub].contiguous()
        cent, _ = kmeans(sub, ksub, iters=iters, seed=seed + mm,
                         init=None if init is None else init[mm])
        books.append(cent)
    return ProductQuantizer(codebooks=torch.stack(books))


def pq_encode(pq: ProductQuantizer, x: torch.Tensor) -> torch.Tensor:
    """f32 [N, d] -> uint8 codes [N, m] (nearest centroid per subspace,
    ties to the lower centroid), in chunks of rows."""
    x = x.float()
    cb = pq.codebooks
    cb_sq = torch.sum(cb * cb, -1)[None, :, :]
    out = []
    for s in range(0, x.shape[0], _ENCODE_CHUNK):
        xs = x[s:s + _ENCODE_CHUNK].reshape(-1, pq.m, pq.dsub)
        d2 = (torch.sum(xs * xs, -1)[:, :, None]
              - 2 * torch.einsum("nms,mjs->nmj", xs, cb) + cb_sq)
        out.append(torch.argmin(d2, dim=-1).to(torch.uint8))
    if not out:
        return torch.empty((0, pq.m), dtype=torch.uint8, device=x.device)
    return torch.cat(out)


def pq_decode(pq: ProductQuantizer, codes: torch.Tensor) -> torch.Tensor:
    """codes [N, m] -> reconstructed f32 [N, d]."""
    sub = torch.arange(pq.m, device=codes.device)
    return pq.codebooks[sub[None, :], codes.long()].reshape(
        codes.shape[0], pq.m * pq.dsub)


def adc_lut(codebooks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact query-to-centroid distance LUT [Q, m, ksub]:
    ``lut[q, m, j] = |q_m - codebooks[m, j]|^2``, expanded as
    ``(|q_m|^2 - 2 q_m.c) + |c|^2`` with every sum over ``dsub`` in
    :func:`pairwise_sum`'s tree. The ONE place the ADC LUT formula lives;
    the CUDA kernels (``csrc/pq_adc.cu``) build the same LUT bit for bit."""
    q = q.float()
    cb = codebooks.float()
    m, _, dsub = cb.shape
    qs = q.reshape(q.shape[0], m, dsub)
    return ((pairwise_sum(qs * qs)[:, :, None]
             - 2 * pairwise_sum(qs[:, :, None, :] * cb[None]))
            + pairwise_sum(cb * cb)[None, :, :])


def _code_offsets(codes: torch.Tensor, ksub: int) -> torch.Tensor:
    """codes [..., m] -> int64 offsets into a [m*ksub]-flattened LUT row."""
    m = codes.shape[-1]
    return (codes.long()
            + torch.arange(m, device=codes.device, dtype=torch.long) * ksub)


def pq_adc_lut(pq: ProductQuantizer, q: torch.Tensor) -> torch.Tensor:
    """:func:`adc_lut` over a :class:`ProductQuantizer`."""
    return adc_lut(pq.codebooks, q)


def pq_adc_gather(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Sum the LUT over each row's codes: dist [Q, N] = sum_m lut[q, m, c],
    summed in :func:`pairwise_sum`'s tree."""
    qn, m, ksub = lut.shape
    flat = _code_offsets(codes, ksub).reshape(-1)
    g = lut.reshape(qn, m * ksub)[:, flat]               # [Q, N*m]
    return pairwise_sum(g.reshape(qn, codes.shape[0], m))


def ivf_pq_search(centroids: torch.Tensor, lists: torch.Tensor,
                  codes: torch.Tensor, mask: torch.Tensor,
                  codebooks: torch.Tensor, q: torch.Tensor, k: int,
                  nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF probe scan over PQ list payloads with a per-query ADC LUT.

    ``codes`` [C, cap, m] uint8; the LUT is built once per query and
    gathered per probed row. Masked slots score ``-inf``, id -1. Query
    chunks keep the int64 offsets, the gathered entries and their sums
    within ``SLAB_BYTES``."""
    q = q.float()
    m, ksub, _ = codebooks.shape
    cells = _probe_cells(q, centroids, nprobe)
    cap = codes.shape[1]
    lut = adc_lut(codebooks, q).reshape(q.shape[0], m * ksub)

    def scan(a, b):
        cc = cells[a:b]
        qn = cc.shape[0]
        offs = _code_offsets(codes[cc], ksub)            # [q, P, cap, m]
        g = torch.gather(lut[a:b], 1, offs.reshape(qn, -1))
        del offs
        dist = pairwise_sum(g.reshape(qn, nprobe, cap, m))
        del g
        s = torch.where(mask[cc], -dist, torch.full_like(dist,
                                                         float("-inf")))
        return _probe_topk(s, lists[cc], k)

    return _chunked(q, nprobe * cap * m * 16, k, scan)


def bytes_per_code(m: int, bits: int) -> int:
    """Stored PQ code size in bytes: one uint8 per subspace (``bits < 8``
    narrows the codebook, not the storage: codes are not bit-packed)."""
    del bits  # kept in the signature, as the reference's
    return max(1, m)
