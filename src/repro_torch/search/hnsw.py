"""HNSW graph search (Malkov & Yashunin 2016): the sublinear search tier.

The port of the reference's ``search/hnsw.py``. Two halves:

* **Host side, numpy, line for line.** Level sampling, the sequential
  heuristic insert (:func:`build`), the incremental insert
  (:func:`insert_batch`), :func:`reassign_entry` and the sequential heapq
  :func:`search`. The arithmetic is the reference's, op
  for op, so from the same corpus and seed the graph comes out bitwise
  equal (``levels``, ``links0``, ``links``, ``entry``). The graph is built
  on the host: a build on the device is a feature the reference lacks.
* **Device side.** :func:`search_batched` is the port of the reference's
  one-dispatch traversal (``_traverse_impl``): the entry seed, the greedy
  descent through the upper layers (an ef=1 beam) and the layer-0
  best-first beam. On a CUDA device it is one launch of a hand-written
  traversal kernel (a block a query, no host in the loop):
  ``graph_traverse_cuda`` over float32 rows, or ``graph_traverse_q_cuda``
  over the code payload when the graph carries a :class:`GraphCodes` codec
  (SQ8 or PQ codes, uint8 on the device); both run the shared traversal of
  ``kernels/csrc/graph_traverse.cuh``. On the CPU, or with an explicit
  ``hop``, it runs as PyTorch ops, one hop a step for the whole batch:
  ``graph_beam`` over float32 rows or ``graph_beam_q`` over the codes (on
  the card each a hand-written CUDA kernel); there the loop conditions are
  read on the host, one sync a hop.

Not ported here: the reference's ``impl="fused"`` route of
``candidate_distances`` through ``l2_topk`` (one launch and one sync per
hop of about a hundred candidates, chosen from JAX's backend), its host
frontier-E driver (``_search_batched_np``); ``ROADMAP.md`` lists them.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.common import NEG_INF
from ..kernels.graph_beam import graph_beam
from ..kernels.graph_beam.kernel import graph_traverse_cuda
from ..kernels.graph_beam.ref import pairwise_sum
from ..kernels.graph_beam_q import graph_beam_q
from ..kernels.graph_beam_q.kernel import graph_traverse_q_cuda
from . import quantize as qz

_MAX_LEVEL = 15


def candidate_distances(q: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Squared L2 from one query [d] to a candidate batch [c, d] (the
    reference's host form)."""
    diff = vecs - q
    return np.einsum("cd,cd->c", diff, diff)


class _Evals:
    """Mutable distance-evaluation counter threaded through the traversal."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0


@dataclass
class PackedHNSW:
    """Traversal-ready form of an :class:`HNSWGraph`: C-contiguous int32
    neighbor tables plus the per-node squared norms of the
    ``2 q.v - |v|^2 - |q|^2`` score. ``device_arrays`` uploads them (and
    the vectors) once per device and caches them."""

    nbrs0: np.ndarray    # [N, 2M] int32, -1 = pad (layer 0)
    upper: np.ndarray    # [L, N, M] int32 (layers 1..L)
    vecs_sq: np.ndarray  # [N] float32: |vecs|^2 per node
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def device_arrays(self, vecs: np.ndarray, device: torch.device
                      ) -> tuple[torch.Tensor, ...]:
        """(vecs, vecs_sq, nbrs0, upper) as tensors on ``device``."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.as_tensor(a, device=device)
                for a in (vecs, self.vecs_sq, self.nbrs0, self.upper))
        return self._dev[key]


@dataclass
class GraphCodes:
    """Quantized traversal payload riding beside the packed graph: per-node
    SQ8 or PQ codes and the codec state that scores them. Attached as
    ``graph.codec``, it makes every step of :func:`search_batched` (the
    entry seed, the descent, layer 0) gather code rows instead of float32
    rows: 68 bytes a neighbour for SQ8 and 12 for PQ8x8 at d=64, against
    260 for the float32 row and norm. The arrays are kept on the host
    (saved, fingerprinted) and uploaded once per device, codes as uint8.
    The hop's affine score form is ``kernels/graph_beam_q``'s."""

    kind: str                 # "sq8" | "pq"
    codes: np.ndarray         # [N, C] uint8 (sq8: C = d; pq: C = m)
    node_bias: np.ndarray     # [N] f32 (sq8: |decode(c)|^2; pq: zeros)
    vmin: Optional[np.ndarray] = None        # sq8 [d] f32
    step: Optional[np.ndarray] = None        # sq8 [d] f32
    codebooks: Optional[np.ndarray] = None   # pq [m, ksub, dsub] f32
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def ksub(self) -> int:
        """LUT stride: the trained PQ codebook width (may be < 2**bits on
        tiny corpora); 0 for SQ8."""
        return 0 if self.codebooks is None else int(self.codebooks.shape[1])

    @property
    def gather_bytes(self) -> int:
        """Bytes the hop streams per gathered neighbour: the uint8 code row
        and its f32 bias (the float32 hop's is ``4 d + 4``)."""
        return int(self.codes.shape[1]) + 4

    def device_arrays(self, device: torch.device
                      ) -> tuple[torch.Tensor, ...]:
        """(codes uint8, node_bias, c0, c1) on ``device``, uploaded once:
        c0, c1 = (vmin, step) for SQ8, (codebooks, None) for PQ."""
        key = str(device)
        if key not in self._dev:
            pair = ((self.vmin, self.step) if self.kind == "sq8"
                    else (self.codebooks, None))
            self._dev[key] = tuple(
                None if a is None else torch.as_tensor(a, device=device)
                for a in (self.codes, self.node_bias) + pair)
        return self._dev[key]

    def query_operands(self, q: torch.Tensor, q_sq: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-query hop operands ``(q_op [Q, Dop], q_bias [Q])`` on q's
        device, built once per search. SQ8: ``q_op = 2 q * step``,
        ``q_bias = 2 q.vmin - |q|^2``, so the hop scores ``-|q -
        decode(c)|^2``. PQ: the negated flattened ADC LUT
        (:func:`~repro_torch.search.quantize.adc_lut`) and a zero bias, so
        the hop scores ``-ADC distance``. Every reduction is a
        :func:`pairwise_sum`, never a matmul: a row's operands do not
        depend on its batch-mates, so a query answers the same alone and
        in a batch."""
        _, _, c0, c1 = self.device_arrays(q.device)
        if self.kind == "sq8":
            q_op = 2.0 * q * c1[None, :]
            q_bias = 2.0 * pairwise_sum(q * c0[None, :]) - q_sq
            return q_op, q_bias
        return (-qz.adc_lut(c0, q).reshape(q.shape[0], -1),
                torch.zeros(q.shape[0], device=q.device))


def make_graph_codes(vecs: np.ndarray, kind: str, m: int = 8, bits: int = 8,
                     iters: int = 15, seed: int = 0,
                     device: str | torch.device = "cuda",
                     init: Optional[list[np.ndarray]] = None) -> GraphCodes:
    """Train a quantized traversal payload over the (reduced) corpus the
    graph was built on, on ``device``. ``kind`` = "sq8" | "pq"; ``m``,
    ``bits``, ``iters``, ``seed`` and ``init`` (the m k-means row draws,
    see :func:`~repro_torch.search.quantize.pq_train`) train PQ and are
    ignored for SQ8. Attach the result as ``graph.codec``: the float32
    vectors stay (build and the sequential engine use them)."""
    v = torch.as_tensor(np.asarray(vecs, np.float32), device=device)
    if kind == "sq8":
        sq = qz.sq8_train(v)
        codes = qz.sq8_encode(sq, v)
        return GraphCodes(
            kind="sq8", codes=codes.cpu().numpy(),
            node_bias=qz.sq8_recon_sq_norms(sq, codes).cpu().numpy(),
            vmin=sq.vmin.cpu().numpy(), step=sq.step.cpu().numpy())
    if kind != "pq":
        raise ValueError(f"graph codec kind must be 'sq8' or 'pq', "
                         f"got {kind!r}")
    pq = qz.pq_train(v, m, bits=bits, iters=iters, seed=seed, init=init)
    return GraphCodes(kind="pq", codes=qz.pq_encode(pq, v).cpu().numpy(),
                      node_bias=np.zeros(v.shape[0], np.float32),
                      codebooks=pq.codebooks.cpu().numpy())


@dataclass
class HNSWGraph:
    """Padded-dense adjacency: ``links0`` [N, 2M] is layer 0, ``links``
    [L, N, M] are layers 1..L (-1 = empty slot; rows of nodes absent from
    a layer are all -1). ``codec``, when set, makes the batched traversal
    score its quantized payload instead of float32 rows; the sequential
    engine always scores float32."""

    vecs: np.ndarray     # [N, d] float32
    levels: np.ndarray   # [N] int32: top layer of each node
    links0: np.ndarray   # [N, 2M] int32
    links: np.ndarray    # [L, N, M] int32
    entry: int
    M: int
    packed: Optional[PackedHNSW] = field(default=None, repr=False,
                                         compare=False)
    codec: Optional[GraphCodes] = field(default=None, repr=False,
                                        compare=False)

    @property
    def ntotal(self) -> int:
        return int(self.vecs.shape[0])

    @property
    def max_level(self) -> int:
        return int(self.levels[self.entry])

    def pack(self) -> PackedHNSW:
        """Compile (and cache) the packed traversal form. Idempotent; a
        graph mutated after packing must null ``packed`` itself."""
        if self.packed is None:
            self.packed = PackedHNSW(
                nbrs0=np.ascontiguousarray(self.links0, np.int32),
                upper=np.ascontiguousarray(self.links, np.int32),
                vecs_sq=np.einsum("nd,nd->n", self.vecs,
                                  self.vecs).astype(np.float32))
        return self.packed


def sample_levels(n: int, M: int, seed: int) -> np.ndarray:
    """Geometric level draw: floor(-ln(U) * mL) with mL = 1/ln(M)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(np.finfo(np.float64).tiny, 1.0, size=n)
    lv = np.floor(-np.log(u) / np.log(max(M, 2))).astype(np.int32)
    return np.minimum(lv, _MAX_LEVEL)


def _greedy_descent(vecs, adj, q, cur, d_cur, evals, alive=None):
    """ef=1 layer traversal: hop to the closest neighbor until no
    neighbor improves. ``alive`` (bool [N]) hides tombstoned nodes."""
    while True:
        nbrs = adj[cur]
        nbrs = nbrs[nbrs >= 0]
        if alive is not None and nbrs.size:
            nbrs = nbrs[alive[nbrs]]
        if nbrs.size == 0:
            return cur, d_cur
        ds = candidate_distances(q, vecs[nbrs])
        evals.n += int(nbrs.size)
        j = int(np.argmin(ds))
        if ds[j] >= d_cur:
            return cur, d_cur
        cur, d_cur = int(nbrs[j]), float(ds[j])


def _search_layer(vecs, adj, q, eps, ef, visited, stamp, evals,
                  alive=None):
    """Best-first beam (Alg. 2): returns the ef closest visited nodes as a
    sorted [(dist, node), ...] list. ``eps`` are (dist, node) entry points
    (already counted); ``visited``/``stamp`` implement an O(1)-reset
    visited set shared across calls; ``alive`` hides tombstoned nodes."""
    cand: list[tuple[float, int]] = []   # min-heap on distance
    res: list[tuple[float, int]] = []    # max-heap via negated distance
    for d, e in eps:
        visited[e] = stamp
        heapq.heappush(cand, (d, e))
        heapq.heappush(res, (-d, e))
    while cand:
        d, c = heapq.heappop(cand)
        if d > -res[0][0] and len(res) >= ef:
            break
        nbrs = adj[c]
        nbrs = nbrs[nbrs >= 0]
        if alive is not None and nbrs.size:
            nbrs = nbrs[alive[nbrs]]
        fresh = nbrs[visited[nbrs] != stamp]
        if fresh.size == 0:
            continue
        visited[fresh] = stamp
        ds = candidate_distances(q, vecs[fresh])
        evals.n += int(fresh.size)
        worst = -res[0][0]
        full = len(res) >= ef
        for dj, nj in zip(ds.tolist(), fresh.tolist()):
            if not full or dj < worst:
                heapq.heappush(cand, (dj, nj))
                heapq.heappush(res, (-dj, nj))
                if len(res) > ef:
                    heapq.heappop(res)
                worst = -res[0][0]
                full = len(res) >= ef
    return sorted((-nd, node) for nd, node in res)


def _select_heuristic(cands, vecs, m, evals, keep_pruned=False):
    """Alg. 4 neighbor selection: scan candidates nearest-first, keep one
    only if it is closer to the query than to every kept neighbor. With
    ``keep_pruned`` the remaining slots are refilled nearest-first."""
    sel: list[int] = []
    sel_vecs: list[np.ndarray] = []
    pruned: list[int] = []
    for d_c, c in cands:
        if len(sel) >= m:
            break
        if sel:
            ds = candidate_distances(vecs[c], np.stack(sel_vecs))
            evals.n += len(sel)
            if not np.all(d_c < ds):
                pruned.append(c)
                continue
        sel.append(c)
        sel_vecs.append(vecs[c])
    if keep_pruned:
        sel.extend(pruned[: m - len(sel)])
    return sel


def _bfs_layer0(links0: np.ndarray, entry: int) -> np.ndarray:
    """Boolean reachability mask of the layer-0 graph from ``entry``."""
    seen = np.zeros(links0.shape[0], bool)
    seen[entry] = True
    stack = [entry]
    while stack:
        c = stack.pop()
        for t in links0[c][links0[c] >= 0].tolist():
            if not seen[t]:
                seen[t] = True
                stack.append(t)
    return seen


def _evict_farthest(links0, vecs, node, evals) -> None:
    """Free one slot in a full row by dropping its farthest link (both
    directions, keeping the graph symmetric)."""
    nbrs = links0[node][links0[node] >= 0]
    ds = candidate_distances(vecs[node], vecs[nbrs])
    evals.n += int(nbrs.size)
    t = int(nbrs[np.argmax(ds)])
    links0[t][links0[t] == node] = -1
    links0[node][links0[node] == t] = -1


def _repair_connectivity(vecs, links0, entry, evals) -> int:
    """Stitch every layer-0 component stranded by symmetric pruning back
    via its nearest reachable node."""
    stitched = 0
    for _ in range(links0.shape[0]):
        seen = _bfs_layer0(links0, entry)
        miss = np.flatnonzero(~seen)
        if miss.size == 0:
            return stitched
        u = int(miss[0])
        reach = np.flatnonzero(seen)
        ds = candidate_distances(vecs[u], vecs[reach])
        evals.n += int(reach.size)
        r = int(reach[np.argmin(ds)])
        for node in (u, r):
            if not np.any(links0[node] < 0):
                _evict_farthest(links0, vecs, node, evals)
        links0[u][np.flatnonzero(links0[u] < 0)[0]] = r
        links0[r][np.flatnonzero(links0[r] < 0)[0]] = u
        stitched += 1
    return stitched


def _write_row(adj, node, nbrs):
    row = adj[node]
    row[: len(nbrs)] = nbrs
    row[len(nbrs):] = -1


def _insert_node(vecs, levels, links0, links, M, m0, top, i, entry,
                 ef_construction, visited, evals) -> int:
    """Insert node ``i`` (Alg. 1 body): greedy-descend the upper layers,
    beam + heuristic-select per layer, write bidirectional links with
    overflow re-pruning. Returns the (possibly updated) entry."""
    q = vecs[i]
    l_i = int(levels[i])
    l_ep = int(levels[entry])
    cur = entry
    d_cur = float(candidate_distances(q, vecs[entry][None])[0])
    evals.n += 1
    for layer in range(l_ep, l_i, -1):
        cur, d_cur = _greedy_descent(vecs, links[layer - 1], q, cur,
                                     d_cur, evals)
    eps = [(d_cur, cur)]
    for layer in range(min(l_ep, l_i), -1, -1):
        adj = links0 if layer == 0 else links[layer - 1]
        cap = m0 if layer == 0 else M
        found = _search_layer(vecs, adj, q, eps, ef_construction,
                              visited, i * (top + 1) + layer, evals)
        sel = _select_heuristic(found, vecs, M, evals)
        _write_row(adj, i, sel)
        # bidirectional: add the back-link, re-pruning on overflow and
        # dropping the reverse edge of anything the prune evicts
        for s in sel:
            row = adj[s]
            free = np.flatnonzero(row < 0)  # prune leaves holes anywhere
            if free.size:
                row[free[0]] = i
                continue
            nbrs = row[row >= 0]
            ds = candidate_distances(vecs[s], vecs[nbrs])
            evals.n += int(nbrs.size)
            d_i = float(candidate_distances(vecs[s], q[None])[0])
            evals.n += 1
            merged = sorted([*zip(ds.tolist(), nbrs.tolist()),
                             (d_i, i)])
            kept = _select_heuristic(merged, vecs, cap, evals,
                                     keep_pruned=True)
            for t in nbrs:
                if t not in kept:
                    trow = adj[t]
                    trow[trow == s] = -1
            if i not in kept and len(kept) < cap:
                kept.append(i)  # never orphan the node being inserted
            elif i not in kept:
                irow = adj[i]
                irow[irow == s] = -1
            _write_row(adj, s, kept)
        eps = found
    if l_i > int(levels[entry]):
        entry = i
    return entry


def _compact_pads(links0, links) -> None:
    """Compact pad slots left of real links (prune leaves holes).
    Row-local stable argsort: a row with no holes is bitwise untouched."""
    for adj in (links0, *links):
        order = np.argsort(adj < 0, axis=1, kind="stable")
        adj[:] = np.take_along_axis(adj, order, axis=1)


def build(corpus, M: int = 32, ef_construction: int = 100,
          seed: int = 0) -> HNSWGraph:
    """Sequential heuristic insert of every corpus row (Alg. 1), on the
    host. ``corpus``: a numpy array or a tensor (copied to the host)."""
    if isinstance(corpus, torch.Tensor):
        corpus = corpus.detach().cpu().numpy()
    vecs = np.ascontiguousarray(np.asarray(corpus, np.float32))
    n = vecs.shape[0]
    if n == 0:
        raise ValueError("empty corpus")
    m0 = 2 * M
    levels = sample_levels(n, M, seed)
    top = int(levels.max())
    links0 = np.full((n, m0), -1, np.int32)
    links = np.full((top, n, M), -1, np.int32)
    visited = np.full(n, -1, np.int64)
    evals = _Evals()   # the helpers count; a build consumes no count
    entry = 0
    for i in range(1, n):
        entry = _insert_node(vecs, levels, links0, links, M, m0, top, i,
                             entry, ef_construction, visited, evals)
    _repair_connectivity(vecs, links0, entry, evals)
    _compact_pads(links0, links)
    return HNSWGraph(vecs=vecs, levels=levels, links0=links0, links=links,
                     entry=entry, M=M)


def insert_batch(graph: HNSWGraph, new_vecs, ef_construction: int = 100,
                 seed: int = 0, device: str | torch.device = "cuda"
                 ) -> np.ndarray:
    """Incremental insert: append ``new_vecs`` rows to a built graph with
    the same per-node machinery as :func:`build` (greedy descent, beam,
    heuristic selection, bidirectional overflow re-pruning), in place, on
    the host: the reference's code line for line, so the same stream of
    insert batches gives the reference's graph bit for bit.

    Levels for the new nodes are drawn keyed on ``(seed, current size)``;
    new upper layers are allocated when a new node out-draws the current
    top. The packed traversal cache is nulled (the :meth:`HNSWGraph.pack`
    contract): callers re-pack and re-upload before the next batched
    search. A :class:`GraphCodes` payload, when attached, is extended with
    codes for the new rows from the already-trained codec, encoded on
    ``device`` (no retrain). Returns the global ids of the inserted rows.
    """
    if isinstance(new_vecs, torch.Tensor):
        new_vecs = new_vecs.detach().cpu().numpy()
    nv = np.ascontiguousarray(np.asarray(new_vecs, np.float32))
    b = nv.shape[0]
    if nv.ndim != 2 or (b and nv.shape[1] != graph.vecs.shape[1]):
        raise ValueError(f"insert_batch: expected [b, {graph.vecs.shape[1]}]"
                         f" vectors, got {nv.shape}")
    if b == 0:
        return np.zeros(0, np.int64)
    n0 = graph.ntotal
    M, m0 = graph.M, 2 * graph.M
    new_levels = sample_levels(b, M, seed + n0)
    vecs = np.ascontiguousarray(np.concatenate([graph.vecs, nv], axis=0))
    levels = np.concatenate([graph.levels, new_levels])
    top_old = graph.links.shape[0]
    top = max(top_old, int(new_levels.max()))
    links0 = np.concatenate(
        [graph.links0, np.full((b, m0), -1, np.int32)], axis=0)
    links = np.full((top, n0 + b, M), -1, np.int32)
    if top_old:
        links[:top_old, :n0] = graph.links
    visited = np.full(n0 + b, -1, np.int64)
    evals = _Evals()
    entry = graph.entry
    for i in range(n0, n0 + b):
        entry = _insert_node(vecs, levels, links0, links, M, m0, top, i,
                             entry, ef_construction, visited, evals)
    _repair_connectivity(vecs, links0, entry, evals)
    _compact_pads(links0, links)
    graph.vecs = vecs
    graph.levels = levels
    graph.links0 = links0
    graph.links = links
    graph.entry = entry
    graph.packed = None  # pack() contract: a mutated graph re-packs
    if graph.codec is not None:
        _extend_codec(graph.codec, nv, device)
    return np.arange(n0, n0 + b, dtype=np.int64)


def _extend_codec(cdx: GraphCodes, new_vecs: np.ndarray,
                  device: str | torch.device = "cuda") -> None:
    """Encode ``new_vecs`` with the codec's already-trained state on
    ``device`` and append the code rows (and biases) in place; drops the
    device cache."""
    v = torch.as_tensor(np.asarray(new_vecs, np.float32), device=device)
    if cdx.kind == "sq8":
        sq = qz.ScalarQuantizer(vmin=torch.as_tensor(cdx.vmin, device=device),
                                step=torch.as_tensor(cdx.step, device=device))
        codes = qz.sq8_encode(sq, v)
        nb = qz.sq8_recon_sq_norms(sq, codes).cpu().numpy().astype(np.float32)
    else:
        pq = qz.ProductQuantizer(
            codebooks=torch.as_tensor(cdx.codebooks, device=device))
        codes = qz.pq_encode(pq, v)
        nb = np.zeros(v.shape[0], np.float32)
    cdx.codes = np.ascontiguousarray(
        np.concatenate([cdx.codes, codes.cpu().numpy()], axis=0))
    cdx.node_bias = np.concatenate([cdx.node_bias, nb])
    cdx._dev = {}


def reassign_entry(graph: HNSWGraph, alive: np.ndarray) -> int:
    """Point ``graph.entry`` at the highest-level alive node (ties to the
    lowest id). Returns the new entry id; raises if nothing is alive."""
    alive = np.asarray(alive, bool)
    ids = np.flatnonzero(alive)
    if ids.size == 0:
        raise ValueError("reassign_entry: no alive node to anchor at")
    graph.entry = int(ids[np.argmax(graph.levels[ids])])
    return graph.entry


def search(graph: HNSWGraph, queries: np.ndarray, k: int,
           ef_search: int = 64, alive: Optional[np.ndarray] = None
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequential beam search per query, on the host. Returns (scores
    [Q, k], ids [Q, k], evals [Q]): scores = -squared-euclidean, ids pad
    with -1 / scores with -inf when the beam holds fewer than k nodes,
    evals = distance computations per query. ``alive`` (bool [N])
    tombstones nodes; ``graph.entry`` must be alive."""
    q = np.asarray(queries, np.float32)
    nq = q.shape[0]
    if alive is not None:
        alive = np.asarray(alive, bool)
        if not alive[graph.entry]:
            raise ValueError("search: graph.entry is tombstoned — call "
                             "reassign_entry() after deleting it")
    ef = max(ef_search, k)
    scores = np.full((nq, k), -np.inf, np.float32)
    ids = np.full((nq, k), -1, np.int32)
    evals = np.zeros(nq, np.int64)
    visited = np.full(graph.ntotal, -1, np.int64)
    for qi in range(nq):
        cnt = _Evals()
        cur = graph.entry
        d_cur = float(candidate_distances(q[qi], graph.vecs[cur][None])[0])
        cnt.n += 1
        for layer in range(graph.max_level, 0, -1):
            cur, d_cur = _greedy_descent(graph.vecs, graph.links[layer - 1],
                                         q[qi], cur, d_cur, cnt, alive)
        found = _search_layer(graph.vecs, graph.links0, q[qi],
                              [(d_cur, cur)], ef, visited, qi, cnt, alive)
        for j, (d, node) in enumerate(found[:k]):
            scores[qi, j] = -d
            ids[qi, j] = node
        evals[qi] = cnt.n
    return scores, ids, evals


def search_batched(graph: HNSWGraph, queries, k: int, ef_search: int = 64,
                   alive: Optional[np.ndarray] = None,
                   device: str | torch.device = "cuda",
                   hop: Optional[Callable] = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Batched beam search over the packed adjacency, on ``device``.

    The port of the reference's jitted traversal (``_traverse_impl``):
    greedy descent through the upper layers, then a best-first beam of
    width ``ef = max(ef_search, k)`` at layer 0, the whole batch advancing
    together in exact best-first order. Every step is one ``hop`` for all
    queries: the entry seed, each descent step (an ef=1 beam; ties keep the
    current node, which is the sequential stop condition) and each layer-0
    expansion. The hop is the ``graph_beam`` op over float32 rows, or, when
    ``graph.codec`` is set, the ``graph_beam_q`` op over its codes with the
    per-query operands built once per search (on the card each is its CUDA
    kernel; a plain version with the same signature may be passed as
    ``hop`` to compare). Every step scores the same payload, so the beam's
    order is consistent. Visited state is a ``[Q, N]`` uint8 stamp matrix
    (0 unseen, 1 seen, 2 expanded), zeroed for each search.

    On a CUDA device, with no ``hop``, the whole loop is one launch of a
    traversal kernel (``graph_traverse_cuda`` over float32 rows,
    ``graph_traverse_q_cuda`` over the codec's codes): each row runs this
    loop's steps alone, with the same hop arithmetic, so its answer, evals
    and layer-0 hops are the loop's; ``hops`` is their maximum, read once
    at the end.

    Rows that have converged keep looping with every slot masked, a
    bitwise no-op, so a row's answer does not depend on its batch-mates.

    Returns ``(scores [Q, k], ids [Q, k] int32, evals [Q] int64, hops)`` as
    tensors on ``device``: scores are -squared-L2 with ``(-inf, -1)``
    padding; evals count as the reference counts them (the seed 1, the
    descent its valid neighbors of active rows, layer 0 its fresh ones);
    ``hops`` is the number of layer-0 hops. ``alive`` (bool [N])
    tombstones nodes (numpy, or a tensor, used where it lies): a dead node
    never enters a beam; the entry must be alive."""
    dev = torch.device(device)
    q = torch.as_tensor(queries, dtype=torch.float32,
                        device=dev).contiguous()
    nq = q.shape[0]
    if nq == 0:
        return (torch.zeros((0, k), device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev), 0)
    mask = None
    if alive is not None:
        # a tensor stays where it is (a mask kept on the card is not
        # uploaded again); the entry check reads one element
        mask = torch.as_tensor(
            alive if isinstance(alive, torch.Tensor)
            else np.asarray(alive, bool), dtype=torch.bool, device=dev)
        if not bool(mask[graph.entry]):
            raise ValueError("search_batched: graph.entry is tombstoned — "
                             "call reassign_entry() after deleting it")
    ef = max(ef_search, k)
    vecs, vecs_sq, nbrs0, upper = graph.pack().device_arrays(graph.vecs, dev)
    n = vecs.shape[0]
    # a fixed sum order: a query's norm is the same alone and in a batch
    q_sq = pairwise_sum(q * q)
    cdx = graph.codec
    if cdx is not None:
        codes, node_bias = cdx.device_arrays(dev)[:2]
        q_op, q_bias = cdx.query_operands(q, q_sq)
    if dev.type == "cuda" and hop is None:
        if cdx is None:
            out = graph_traverse_cuda(q, vecs, vecs_sq, q_sq, nbrs0, upper,
                                      graph.entry, ef, alive=mask)
        else:
            out = graph_traverse_q_cuda(
                q_op.contiguous(), q_bias.contiguous(), codes, node_bias,
                nbrs0, upper, graph.entry, ef, cdx.kind, cdx.ksub,
                alive=mask)
        beam_v, beam_i, evals, row_hops = out
        return _finish(beam_v, beam_i, k) + (evals, int(row_hops.max()))
    if cdx is None:
        hop = graph_beam if hop is None else hop

        def step(cand, bv, bi):
            return hop(q, vecs, cand, bv, bi, db_sq=vecs_sq, q_sq=q_sq,
                       db_mask=mask)
    else:
        hop = graph_beam_q if hop is None else hop

        def step(cand, bv, bi):
            return hop(q_op, q_bias, codes, node_bias, cand, bv, bi,
                       db_mask=mask, mode=cdx.kind, ksub=cdx.ksub)

    i32, u8 = torch.int32, torch.uint8
    rows = torch.arange(nq, device=dev)
    pad_id = torch.full((nq, 1), -1, dtype=i32, device=dev)

    # entry seed: a 1-wide merge against the lone entry candidate
    s_cur, cur = step(torch.full((nq, 1), graph.entry, dtype=i32,
                                 device=dev),
                      torch.full((nq, 1), NEG_INF, device=dev), pad_id)
    s_cur, cur = s_cur[:, 0], cur[:, 0]
    evals = torch.ones(nq, dtype=torch.int64, device=dev)

    # upper layers: batched greedy descent
    for layer in range(upper.shape[0], 0, -1):
        adj = upper[layer - 1]
        active = torch.ones(nq, dtype=torch.bool, device=dev)
        while bool(active.any()):
            ids = adj[cur.long()]                            # [Q, M]
            valid = (ids >= 0) & active[:, None]
            evals += valid.sum(dim=1)
            nv, ni = step(torch.where(valid, ids, pad_id),
                          s_cur[:, None].contiguous(),
                          cur[:, None].contiguous())
            moved = (ni[:, 0] != cur) & active
            cur = torch.where(active, ni[:, 0], cur)
            s_cur = torch.where(active, nv[:, 0], s_cur)
            active = moved

    # layer 0: batched best-first beam over per-query visited stamps
    beam_v = torch.full((nq, ef), NEG_INF, device=dev)
    beam_i = torch.full((nq, ef), -1, dtype=i32, device=dev)
    beam_v[:, 0] = s_cur
    beam_i[:, 0] = cur
    state = torch.zeros((nq, n), dtype=u8, device=dev)
    state[rows, cur.long()] = 1
    hops = 0
    while True:
        in_beam = beam_i >= 0
        safe_b = torch.where(in_beam, beam_i, 0).long()
        unexp = in_beam & (state.gather(1, safe_b) == 1)
        live = unexp.any(dim=1)
        if not bool(live.any()):
            break
        j = torch.argmax(unexp.to(u8), dim=1)  # beam sorted desc -> first
        node = beam_i.gather(1, j[:, None])[:, 0]
        col = torch.where(live, node, 0).long()[:, None]
        # one column a row: the expand stamp has no duplicate index
        state.scatter_(1, col, torch.maximum(
            state.gather(1, col), (2 * live.to(u8))[:, None]))
        nbrs = nbrs0[col[:, 0]]                               # [Q, 2M]
        valid = (nbrs >= 0) & live[:, None]
        # pad slots alias the expanded node: they never collide with a
        # real neighbor (the adjacency has no self-loops)
        safe = torch.where(valid, nbrs.long(), col)
        seen = state.gather(1, safe)
        fresh = valid & (seen == 0)
        # duplicate indices of a row carry equal values (the same stamp
        # read, the same fresh bit), so the scatter's write order cannot
        # change the result
        state.scatter_(1, safe, seen | fresh.to(u8))
        evals += fresh.sum(dim=1)
        beam_v, beam_i = step(torch.where(fresh, nbrs, pad_id), beam_v,
                              beam_i)
        hops += 1

    return _finish(beam_v, beam_i, k) + (evals, hops)


def _finish(beam_v: torch.Tensor, beam_i: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first k of the final beam, pad scores as -inf."""
    scores = beam_v[:, :k]
    ids = beam_i[:, :k]
    return (torch.where(ids >= 0, scores, torch.full_like(scores,
                                                          float("-inf"))),
            ids)
