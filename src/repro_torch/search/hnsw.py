"""HNSW graph search (Malkov & Yashunin 2016): the sublinear search tier.

The port of the reference's ``search/hnsw.py`` for f32 payloads. Two
halves:

* **Host side, numpy, line for line.** Level sampling, the sequential
  heuristic insert (:func:`build`), :func:`reassign_entry` and the
  sequential heapq :func:`search`. The arithmetic is the reference's, op
  for op, so from the same corpus and seed the graph comes out bitwise
  equal (``levels``, ``links0``, ``links``, ``entry``). The graph is built
  on the host: a build on the device is a feature the reference lacks.
* **Device side, PyTorch.** :func:`search_batched` is the port of the
  reference's one-dispatch traversal (``_traverse_impl``, f32 mode) as
  PyTorch ops on the index's device: the entry seed, the greedy descent
  through the upper layers (an ef=1 beam) and the layer-0 best-first beam
  are each one ``graph_beam`` hop per step for the whole batch (the
  hand-written CUDA kernel on the card). The loop conditions are read on
  the host, one sync per hop.

Not ported here: the reference's ``impl="fused"`` route of
``candidate_distances`` through ``l2_topk`` (one launch and one sync per
hop of about a hundred candidates, chosen from JAX's backend), its host
frontier-E driver (``_search_batched_np``), ``insert_batch`` and the
quantized payloads (``GraphCodes``); ``ROADMAP.md`` lists them.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.common import NEG_INF
from ..kernels.graph_beam import graph_beam
from ..kernels.graph_beam.ref import pairwise_sum

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
class HNSWGraph:
    """Padded-dense adjacency: ``links0`` [N, 2M] is layer 0, ``links``
    [L, N, M] are layers 1..L (-1 = empty slot; rows of nodes absent from
    a layer are all -1)."""

    vecs: np.ndarray     # [N, d] float32
    levels: np.ndarray   # [N] int32: top layer of each node
    links0: np.ndarray   # [N, 2M] int32
    links: np.ndarray    # [L, N, M] int32
    entry: int
    M: int
    packed: Optional[PackedHNSW] = field(default=None, repr=False,
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
                   hop: Callable = graph_beam
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Batched beam search over the packed adjacency, on ``device``.

    The port of the reference's jitted traversal (``_traverse_impl``, f32
    payloads): greedy descent through the upper layers, then a best-first
    beam of width ``ef = max(ef_search, k)`` at layer 0, the whole batch
    advancing together in exact best-first order. Every step is one
    ``hop`` (the ``graph_beam`` op: the CUDA kernel on the card; the plain
    version may be passed to compare) for all queries: the entry seed, each
    descent step (an ef=1 beam; ties keep the current node, which is the
    sequential stop condition) and each layer-0 expansion. Visited state
    is a ``[Q, N]`` uint8 stamp matrix (0 unseen, 1 seen, 2 expanded),
    zeroed for each search.

    Rows that have converged keep looping with every slot masked, a
    bitwise no-op, so a row's answer does not depend on its batch-mates.

    Returns ``(scores [Q, k], ids [Q, k] int32, evals [Q] int64, hops)`` as
    tensors on ``device``: scores are -squared-L2 with ``(-inf, -1)``
    padding; evals count as the reference counts them (the seed 1, the
    descent its valid neighbors of active rows, layer 0 its fresh ones);
    ``hops`` is the number of layer-0 hops. ``alive`` (bool [N])
    tombstones nodes: a dead node never enters a beam; the entry must be
    alive."""
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
        alive = np.asarray(alive, bool)
        if not alive[graph.entry]:
            raise ValueError("search_batched: graph.entry is tombstoned — "
                             "call reassign_entry() after deleting it")
        mask = torch.as_tensor(alive, device=dev)
    ef = max(ef_search, k)
    vecs, vecs_sq, nbrs0, upper = graph.pack().device_arrays(graph.vecs, dev)
    n = vecs.shape[0]
    # a fixed sum order: a query's norm is the same alone and in a batch
    q_sq = pairwise_sum(q * q)

    def step(cand, bv, bi):
        return hop(q, vecs, cand, bv, bi, db_sq=vecs_sq, q_sq=q_sq,
                   db_mask=mask)

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

    scores = beam_v[:, :k]
    ids = beam_i[:, :k]
    return (torch.where(ids >= 0, scores, torch.full_like(scores,
                                                          float("-inf"))),
            ids, evals, hops)
