"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Five paths of the paper's deployment stacks run through the port's entry
points (``repro_torch.api``). ``RAE64,Flat,Rerank4``: fit the RAE, encode
the corpus and the queries (the hand-written ``rae_encode`` kernel), scan
the reduced corpus for the stage-1 top-k (the hand-written ``l2_topk``
kernel), rerank exactly in the full space. ``RAE64,HNSW32,Rerank4``: fit,
encode, build the graph over the reduced corpus on the host, traverse it
on the card in one launch of the hand-written traversal kernel (a block a
query, built on the ``graph_beam`` hop's device code), rerank.
``RAE64,Shard8,IVF256,Rerank4``: fit, encode, partition the reduced corpus
into 8 shards of contiguous rows, build an IVF256 child per shard, fan the
probe scans out on a thread pool, merge the ``[Q, k1 * 8]`` candidates
with the hand-written ``topk_merge`` kernel, rerank. ``RAE64,PQ8x8,
Rerank4``: fit, encode, train 8 subspace codebooks, store 8-byte codes,
scan them with the hand-written ``pq_adc`` kernel, rerank.
``RAE64,HNSW32,SQ8,Rerank4`` / ``RAE64,HNSW32,PQ8x8,Rerank4``: the graph
with a code payload, a search one launch of the same traversal scoring the
codes with the hand-written ``graph_beam_q`` hop's device code.
The ``Mut`` prefix wraps any of these stacks for live inserts, tombstone
deletes and rebuilds (``api/mutable.py``: the masks reach ``l2_topk``, the
traversals and ``topk_merge``), and the paper's Table 1 baselines (PCA,
RP, MDS, Isomap, UMAP) take the RAE's place, the affine ones through the
same ``rae_encode`` kernel. Two model serving paths feed such an index
its embeddings:
two-tower-retrieval (the user tower's history bag through the hand-written
``embedding_bag`` kernel) and llama3.2-1b (prefill, and decode steps whose
attention is the hand-written ``flash_decode`` kernel over the KV cache).
Both models train (``models.registry`` train cells, ``launch/train.py``):
the gradient of every embedding table, the history bag's and the row
lookups', is the hand-written ``embedding_bag_bwd`` kernel.
Phases:

1. kernels against their plain PyTorch versions on the card (the scan at
   every k up to ``max_k()`` on ragged, unaligned, tied and integer
   inputs; the one-launch traversals, float32 and quantized, against the
   loop of plain hops; the ADC scan on tied codes and at every plan
   branch; the merge on both sides of its narrow blocks' width limit, with
   more pads than C - k and rows all pads; the bag's backward on ragged,
   tied, clipped, all-pad and bag-of-one inputs, over 10M rows and at the
   LM's tied embedding);
2. acceptance at the reference's bars on the 20k x 256 corpus: recall@10
   >= 0.9 for the Flat and IVF256 stacks, the Shard8 IVF256 stack within
   0.01 of its twin, ``RAE64,IVF256,PQ8x8,Rerank4`` >= 0.85 at <= 1/8 the
   bytes per vector of ``RAE64,Flat``; save / ``load_index`` answering
   identically;
3. full size: the paper's 768-d ``imdb_like`` corpus at 1M rows and its
   3000-step schedule, 1024 queries in batches of 256, the kernel path's
   ids against the plain path's, and each kernel's time beside its bound,
   its plain version's and the PyTorch library call's (the scan also at
   k = 2048, the top rung of ``rerank_k1``, with its launches in such a
   search);
4. the graph stack on the 20k x 256 acceptance corpus (the graph is built
   on the host, which bounds the size: see ``PERF.md``): recall@10 >= 0.9
   and distance evals < 10% of N, reload identical, the one-launch
   traversal against the plain-hop loop on all 1024 noisy queries (ids,
   scores, evals, hops equal) and each stage-1 answer alone against its
   batch row, 1024 noisy queries in batches of 256 and one at a time, the
   card's idle share; the traversal's time a batch beside its bound and
   the plain-hop loop's, and the hop kernel's time at N = 1M;
5. the sharded stack at full width: ``imdb_like`` at 1,000,003 rows (prime,
   so every shard split is ragged) and 1024 queries, one 3000-step fit
   shared by ``RAE64,IVF256,Rerank4`` (the unsharded twin) and
   ``RAE64,Shard8,IVF256,Rerank4``: recall@10 against the exact scan (the
   Shard8 stack within 0.01 of its twin), latency in batches of 256 and one
   query at a time, build time by part, peak memory, two Shard8 builds with
   one fingerprint; ``Shard1/2/8,Flat`` bitwise equal to ``FlatIndex`` on a
   prime-sized integer corpus; and the merge kernel's time at the main
   path's shape, at a lone query of it and at C = 16384, k = 2048, beside
   its bound and the launch floor (``torch.cuda._sleep(0)``);
6. the quantized tiers: ``RAE64,PQ8x8,Rerank4`` and
   ``RAE64,IVF256,PQ8x8,Rerank4`` on phase 5's corpus and fit (no cut),
   beside their twin ``RAE64,Flat,Rerank4``: recall@10, bytes per vector,
   build time by part, latency in batches of 256 and one query at a time,
   peak memory, the kernel path's ids against the plain path's; then
   ``RAE64,HNSW32,SQ8,Rerank4`` and ``RAE64,HNSW32,PQ8x8,Rerank4`` with
   phase 4's reducer on its 20k x 256 corpus (cut as phase 4 is), held to
   the graph gates of ``scripts/check_bench.py`` against phase 4's f32
   stack (gather bytes per hop at least 3x / 4x fewer, recall within
   0.01), a search one quantized traversal launch equal to the plain-hop
   loop on all 1024 noisy queries (ids, scores, evals, hops), a lone query
   == its batch row, the card's idle share; ``pq_adc``'s time at the main
   path's shape (and k = 2048) beside its bound and shared-memory lookup
   ceiling, and the quantized traversal's a batch beside its bound and the
   plain-hop loop's (the hop alone over 1M code rows too);
7. two-tower-retrieval at its published widths (no cut: 25.6 GB of float32
   tables on the card): the serve_p99 (B=512), serve_bulk (B=262,144,
   history bags of 50) and retrieval_cand (one user against 1,000,000
   candidates, top-100) cells through ``models.registry.build_cell``:
   latency, the kernel path against the plain path (bit-equal), peak
   memory, the card's idle share; and the bag kernel's time at serve_bulk;
8. llama3.2-1b at its published widths in bfloat16: prefill cut to 8 x 2048
   tokens and 8 decode steps from its cache, held to the forward over the
   same tokens (relative error < 0.06) and to the plain path; decode_32k
   cut to B=32 and long_500k (B=1, 524,288 positions), 8 steps each from a
   seeded cache: step time, tokens per second, the idle share of a step;
   and the decode kernel's time at both cells' shapes;
9. the paper's Table 1 baselines, its theory and live mutation: (a) the
   RAE (3000 steps) and PCA, RP, MDS, Isomap and UMAP (cut, see
   ``UMAP_CUT``) at m = 256 on ``imdb_like`` 10,000 x 768, P_overall top-5
   (euclidean, cosine) on the card, each affine transform's ``rae_encode``
   kernel against its plain version, Isomap's min-plus geodesics on the
   card against the CPU's, Eq. 15 and 16 on the RAE's W_e; (b)
   ``PCA64,Flat,Rerank4`` and ``PCA64,IVF256,Rerank4`` on phase 2's
   corpus; (c) ``Mut,RAE64,Flat,Rerank4`` and ``Mut,RAE64,IVF256,Rerank4``
   on phase 5's corpus and fit: 10,000 held-out rows added in 4 batches,
   each found as itself, 10,000 ids deleted and never surfacing, the
   masked scan against its plain version, one ``rebuild()`` (the Flat
   stack's answers unchanged); (d) the three ``Mut`` graph stacks (f32,
   SQ8, PQ8x8) over phase 4's graph: 1,024 inserts, 2,048 deletes with the
   entry node, the one-launch traversal equal to the plain-hop loop under
   the mask, f32 recall@10 >= 0.9 over the alive rows; (e) the drift
   monitor quiet on rows near the corpus and tripping a reducer retrain on
   rows off its manifold; (f) ``Mut,RAE64,Shard8,IVF256,Rerank4``, an
   ``add`` that rebuilds the sharded base, a delete, ``topk_merge`` under
   the mask;
10. serving and self-tuning (``repro_torch.serve``, ``repro_torch.tune``):
   (a) ``SearchEngine(max_batch=32, max_wait_ms=2, cache_size=1024)`` over
   ``RAE64,Flat|IVF256|PQ8x8,Rerank4`` on phase 5's corpus and fit (no
   cut), warmed at k = 10: 64 client threads send the 1,024 held-out
   queries inside ``no_retrace(budget=0)``, every answer equal (ids, score
   bits) to the query's lone search, fewer batches than requests; QPS,
   p50 / p99 latency, the bucket histogram, the sequential q=1 loop's QPS;
   256 repeats, every one a cache hit equal to its first answer; (b)
   ``engine.mutate`` on ``Mut,RAE64,Flat,Rerank4`` under 32 clients
   (1,000 deletes never surfacing after, 2,500 held-out rows added and
   found as themselves, cached pre-mutation answers retired) and
   ``hot_swap`` from the Flat to the IVF256 stack under 32 clients
   (nothing dropped, every reply one of the two stacks' lone answers); (c)
   ``table8_autotune.run()``'s configuration (20,000 x 128, RAE64 at 600
   steps, ``RAE64,IVF256|HNSW32,Rerank4``): ``sweep`` on 256 tune
   queries, then 512 holdout queries through an engine tuned to recall
   0.95 and 0.99 with escalation, held to ``scripts/check_bench.py``'s
   autotune bars (recall >= target - 0.01, escalation rate in (0, 0.95)),
   each escalated row alone equal to the same row in its batch; the graph
   with an SQ8 payload served by 64 clients, each answer its lone one; (d)
   HTTP on loopback over the IVF256 engine (256 ``POST /search`` from 32
   threads, ``/stats``, ``/healthz``, 400 for a NaN and a wrong-dim query,
   the cache not grown by them); (e) ``python -m
   repro_torch.launch.serve`` as a subprocess, exit 0;
11. training at published widths (``models.registry`` train cells, AdamW):
   (a) llama3.2-1b train_4k (16 x 2048, vocab 128,256, float32 master
   weights, bfloat16 compute and moments, per-layer remat) with the batch
   cut to ``LLAMA_TRAIN_BATCH`` x 4096: the gradients with the kernels
   equal the plain path's bit for bit, 4 steps with finite losses, no host
   sync in a step, step time, tokens/s, peak memory beside
   ``launch/train.py:reckon_bytes``, the idle share; (b) two-tower
   train_batch (embed 256, MLPs 1024-512-256, bags of 50) with each
   table's rows cut to 1/``TABLE_CUT`` and B = 65,536 halved until a step
   fits: gradients bit-equal to the plain path's, two steps from one state
   bit-identical (params and moments), the loss falling over 8 steps on
   one batch, step time, examples/s, peak memory, the idle share, and the
   backward kernel alone at the history bag beside its bound, its plain
   version and ``F.embedding_bag``'s backward; (c) ``python -m
   repro_torch.launch.train --scale smoke`` for both archs as
   subprocesses: 60 steps, a run crashed at step 45 and resumed from step
   40, the resumed run's final checkpoint equal to the uninterrupted
   run's, file for file.

``python3 chip_smoke.py --ab PARENT/src`` runs none of the phases: it
times ``topk_merge`` (Q = 256 and 1 at C = 320, k = 40; Q = 256 at C =
16384, k = 2048), ``pq_adc`` (k = 320 and 2048), the IVF probes at the
shapes of phases 5 and 6, a phase-4-shaped graph
search over float32 rows, an SQ8 and a PQ8x8 payload (a 256-query batch
and one query), ``l2_topk`` (k = 40 and 2048), ``rae_encode``,
``flash_decode`` and the llama decode steps with the port in
``PARENT/src`` (a ``git archive`` of the parent commit) and with this
tree's, in turns (parent, change, change, parent), each in a process of
its own, on one card.

Every launch counter is set to 0 just before phases 3 to 11 drive their
paths and read just after; a kernel of the path that did not launch fails
the run. Phase 9's, 10's and 11's launches join the ``kernels`` line
(``launches``, and ``launches_phase9`` / ``launches_phase10`` /
``launches_phase11`` for their shares; ``embedding_bag_bwd`` runs only in
phase 11). The last lines are a ``kernels`` JSON object, the card's
name and power limit, and ``{"ok": true, "device": ...}``. A phase that
fails is reported and the next one runs; if any failed, the script prints
no result and exits with code 1. Without a CUDA card it exits with code 2
before any result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): float32
# outside the tensor cores, TF32 on the tensor cores (dense), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# kernel vs plain: float32 sums in another order; ids must be equal
ENCODE_TOL = 1e-4   # |kernel - plain| <= ENCODE_TOL * max(1, max |plain|)
SCORE_TOL = 1e-4    # same rule for the scan's scores
# |kernel - plain| <= FLASH_REL * max |plain|, with no floor: decode outputs
# average V over up to 524,288 positions and are about 5e-3 there, and one
# position dropped or added moves them by about 1e-3 of that
FLASH_REL = 1e-5


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> tuple[float, bool]:
    """Mean device time of ``fn`` over ``reps`` calls, with the card held
    busy (``torch.cuda._sleep``, about 0.2 s) while the host enqueues the
    calls, so a call that costs the host more than the card still shows
    the card's time. Also returns whether the card was still asleep when
    the host had enqueued every call (if not, host time leaked in)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    held = not start.query()
    sync()
    return start.elapsed_time(end) / reps, held


def device_busy_share(fn, kernel: str, tries: int = 3
                      ) -> tuple[float, float, float]:
    """(host wall ms, share of it the card was busy, device ms of the
    kernels whose name holds ``kernel``) for one call of ``fn``, from a
    ``torch.profiler`` trace of the card's activity (kernel and copy
    intervals merged). A trace that holds none of ``kernel``'s launches
    has lost device events (seen once, in a run of every phase) and is
    taken again, up to ``tries`` calls; if the last still holds none, its
    kernel ms is 0 and the busy share is not a measurement. A busy share
    of 0 means the trace held no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        mine = sum(e.time_range.elapsed_us() for e in events
                   if kernel in e.name)
        if mine > 0:
            break
        log(f"trace {attempt + 1} of a call holds no {kernel} kernel")
    return wall * 1e3, busy_us(events) * 1e-3 / (wall * 1e3), mine * 1e-3


def busy_us(events) -> float:
    """Microseconds covered by the union of the events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, last = 0.0, float("-inf")
    for a, b in spans:
        a = max(a, last)
        if b > a:
            busy += b - a
            last = b
    return busy


def traced_device_ms(fn, reps: int) -> float:
    """The card's busy time per call of ``fn``: kernel and copy intervals
    of a ``torch.profiler`` trace of ``reps`` calls, merged, over
    ``reps``. Host time and the gaps between kernels are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    return busy_us([e for e in prof.events()
                    if e.device_type == DeviceType.CUDA]) * 1e-3 / reps


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS
          ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    return err, err / scale


def rel_to_max(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """max |got - want| and that over max |want| (over 1 where want is all
    zeros, where got must be zeros too)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    top = float(want.abs().max()) if want.numel() else 0.0
    return err, err / top if top > 0 else err


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version, on the card
# ---------------------------------------------------------------------------
def phase_kernels(g: torch.Generator) -> dict[str, float]:
    from repro_torch.kernels.l2_topk import l2_topk
    from repro_torch.kernels.l2_topk.kernel import max_k
    from repro_torch.kernels.l2_topk.ref import l2_topk_ref
    from repro_torch.kernels.rae_encode import rae_encode
    from repro_torch.kernels.rae_encode.ref import rae_encode_ref

    errs = {"rae_encode": 0.0, "l2_topk": 0.0}
    for rows, n, m in [(4096, 768, 64), (4096, 768, 384)]:
        x = torch.randn(rows, n, device="cuda", generator=g)
        w = torch.randn(n, m, device="cuda", generator=g) / n ** 0.5
        for normalize in (False, True):
            z = rae_encode(x, w, normalize=normalize)
            sync()
            err, rel = max_rel_err(z, rae_encode_ref(x, w, normalize))
            errs["rae_encode"] = max(errs["rae_encode"], err)
            log(f"phase 1: rae_encode [{rows},{n}]@[{n},{m}] "
                f"normalize={normalize}: max_abs_err {err:.3e}, over "
                f"max(1, max |plain|) {rel:.3e}")
            check(rel <= ENCODE_TOL, f"rae_encode {rows}x{n}x{m} "
                                     f"normalize={normalize}: err {err}")
    errs["rae_encode"] = max(errs["rae_encode"],
                             phase_kernels_rae_encode_variants(g))
    nq, n, d = 257, 100_003, 64     # ragged against every tile size
    q = torch.randn(nq, d, device="cuda", generator=g)
    db = torch.randn(n, d, device="cuda", generator=g)
    mask = torch.rand(n, device="cuda", generator=g) > 0.25
    for k in (1, 10, 40, 64, 2048, max_k()):
        for metric in ("euclidean", "cosine"):
            for db_mask in (None, mask):
                v, i = l2_topk(q, db, k, metric=metric, db_mask=db_mask)
                sync()
                vr, ir = l2_topk_ref(q, db, k, metric=metric,
                                     db_mask=db_mask)
                same = int((i == ir).sum())
                err, rel = max_rel_err(v, vr)
                errs["l2_topk"] = max(errs["l2_topk"], err)
                log(f"phase 1: l2_topk Q={nq} N={n} d={d} k={k} {metric} "
                    f"mask={db_mask is not None}: ids equal {same}/"
                    f"{i.numel()}, max_abs_err {err:.3e}")
                check(same == i.numel(), f"l2_topk ids k={k} {metric}")
                check(rel <= SCORE_TOL, f"l2_topk scores k={k} {metric}")
                if db_mask is not None:
                    dead = torch.nonzero(~mask).flatten().to(torch.int32)
                    check(not torch.isin(i, dead).any().item(),
                          "a tombstoned row surfaced")
    errs["l2_topk"] = max(errs["l2_topk"], phase_kernels_l2_topk_shapes(g))
    errs["graph_beam"] = max(phase_kernels_graph_beam(g),
                             phase_kernels_traversal())
    errs["topk_merge"] = phase_kernels_topk_merge(g)
    errs["pq_adc"] = phase_kernels_pq_adc(g)
    errs["graph_beam_q"] = max(phase_kernels_graph_beam_q(g),
                               phase_kernels_traversal_q())
    errs["embedding_bag"] = phase_kernels_embedding_bag(g)
    errs["embedding_bag_bwd"] = phase_kernels_embedding_bag_bwd(g)
    errs["flash_decode"] = phase_kernels_flash_decode(g)
    return errs


L2_TOPK_KS = (1, 10, 40, 64, 2048)


def phase_kernels_l2_topk_shapes(g: torch.Generator) -> float:
    """The scan at every k (its lists in shared memory up to k = 64, in
    device memory above; a pilot over every 16th row when that sample holds
    2k rows) on ragged Q and N, slices that end mid-way (d = 24, and d = 7
    with the 4-byte copies), rows off a 16-byte boundary; then every score
    equal (zero vectors, one row repeated) and a {-1, 0, 1} corpus, where
    kernel and plain version must agree bit for bit."""
    from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda, max_k
    from repro_torch.kernels.l2_topk.ref import l2_topk_scan_ref, prepare

    worst, cases = 0.0, 0
    for nq, n, d in ((1, 4999, 64), (65, 70_001, 64), (130, 3001, 24),
                     (64, 100, 7)):
        q, db, d_sq = prepare(torch.randn(nq, d, device="cuda", generator=g),
                              torch.randn(n, d, device="cuda", generator=g),
                              "euclidean", None)
        for k in L2_TOPK_KS + (max_k(),):
            v, i = l2_topk_scan_cuda(q, db, d_sq, k)
            v2, i2 = l2_topk_scan_cuda(offset_view(q), offset_view(db), d_sq,
                                       k)
            sync()
            # one query is scored inside a batch of 64 zero rows: cuBLAS
            # sums a one-row product in another order than a batch's
            qp = torch.cat([q, torch.zeros(63 if nq == 1 else 0, d,
                                           device="cuda")])
            vr, ir = (t[:nq] for t in l2_topk_scan_ref(qp, db, d_sq, k))
            err, rel = max_rel_err(v, vr)
            worst = max(worst, err)
            cases += 1
            check(torch.equal(i, ir), f"l2_topk ids Q={nq} N={n} d={d} k={k}")
            check(rel <= SCORE_TOL, f"l2_topk scores Q={nq} N={n} k={k}")
            check(torch.equal(i2, i) and torch.equal(v2, v),
                  f"l2_topk unaligned rows Q={nq} N={n} d={d} k={k}")
    nq, n, d = 70, 9001, 16
    for kind in ("zeros", "one_row", "ints"):
        if kind == "zeros":
            q, db = (torch.zeros(nq, d, device="cuda"),
                     torch.zeros(n, d, device="cuda"))
        elif kind == "one_row":
            q = torch.randn(nq, d, device="cuda", generator=g)
            db = torch.randn(1, d, device="cuda", generator=g).repeat(n, 1)
        else:
            q, db = (torch.randint(-1, 2, (m, d), device="cuda",
                                   generator=g).float() for m in (nq, n))
        q, db, d_sq = prepare(q, db, "euclidean", None)
        for k in L2_TOPK_KS + (max_k(),):
            v, i = l2_topk_scan_cuda(q, db, d_sq, k)
            sync()
            vr, ir = l2_topk_scan_ref(q, db, d_sq, k)
            cases += 1
            check(torch.equal(i, ir) and torch.equal(v, vr),
                  f"l2_topk {kind} corpus k={k}: not bit-equal")
    log(f"phase 1: l2_topk {cases} more cases (Q, N, d in (1, 4999, 64), "
        f"(65, 70001, 64), (130, 3001, 24), (64, 100, 7), aligned and "
        f"unaligned rows; every score tied and a {{-1, 0, 1}} corpus at "
        f"70 x 9001 x 16, bit-equal; k in {L2_TOPK_KS + (max_k(),)}): ids "
        f"equal, max_abs_err {worst:.3e}")
    return worst


def phase_kernels_traversal() -> float:
    """The one-launch traversal against the loop of plain hops on a
    2,000-node graph (d = 64, M = 8, built on the host), 128 noisy queries:
    ef in (10, 80, 4096), with and without tombstones, the visited bits in
    shared memory and in a device matrix; ids, scores, evals and hops
    equal, and each row's own hops equal to the per-query plain model's.
    Returns 0 (bit-equal)."""
    from repro_torch.kernels.graph_beam import kernel as gk
    from repro_torch.kernels.graph_beam.ref import (graph_beam_ref,
                                                    graph_traverse_ref,
                                                    pairwise_sum)
    from repro_torch.search import hnsw

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, 64)) * 3
    x = (centers[rng.integers(0, 8, 2000)]
         + rng.normal(size=(2000, 64))).astype(np.float32)
    graph = hnsw.build(x, M=8, ef_construction=40, seed=0)
    qn = (x[rng.integers(0, 2000, 128)]
          + 0.05 * rng.normal(size=(128, 64))).astype(np.float32)
    smem_max = gk.SMEM_VISITED_MAX_N
    cases = 0
    try:
        for ef in (10, 80, 4096):
            for tomb in (False, True):
                alive = None
                if tomb:
                    alive = rng.random(2000) > 0.3
                    alive[graph.entry] = True
                want = hnsw.search_batched(graph, qn, 10, ef_search=ef,
                                           device="cuda", alive=alive,
                                           hop=graph_beam_ref)
                for limit in (smem_max, 0):
                    gk.SMEM_VISITED_MAX_N = limit
                    got = hnsw.search_batched(graph, qn, 10, ef_search=ef,
                                              device="cuda", alive=alive)
                    sync()
                    cases += 1
                    check(all(torch.equal(a, b) for a, b in
                              zip(got[:3], want[:3])) and got[3] == want[3],
                          f"traversal kernel ef={ef} tombstones={tomb} "
                          f"visited in shared memory={limit > 0}: differs "
                          f"from the plain-hop loop")
        gk.SMEM_VISITED_MAX_N = smem_max
        vecs, vsq, nbrs0, upper = graph.pack().device_arrays(
            graph.vecs, torch.device("cuda"))
        qt = torch.as_tensor(qn[:16], device="cuda")
        kern = gk.graph_traverse_cuda(qt, vecs, vsq, pairwise_sum(qt * qt),
                                      nbrs0, upper, graph.entry, 80)
        plain = graph_traverse_ref(*(t.cpu() for t in (
            qt, vecs, vsq, pairwise_sum(qt * qt), nbrs0, upper)),
            graph.entry, 80)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(kern, plain)),
              "traversal kernel differs from the per-query plain model")
    finally:
        gk.SMEM_VISITED_MAX_N = smem_max
    log(f"phase 1: graph traversal, one launch a search, {cases} cases "
        f"(N=2000 d=64 M=8, 128 queries, ef in (10, 80, 4096), tombstones "
        f"or not, visited bits in shared or device memory) == the plain-hop "
        f"loop: ids, scores, evals, hops equal; 16 rows == the per-query "
        f"plain model, each row's hops included")
    return 0.0


def phase_kernels_traversal_q() -> float:
    """The one-launch quantized traversal against the loop of plain
    quantized hops on a 2,000-node graph (d = 64, M = 8, built on the host)
    with an SQ8 and a PQ8x8 payload, 128 noisy queries and one: ef in (10,
    80, 4096), with and without tombstones, the visited bits in shared
    memory and in a device matrix; ids, scores, evals and hops equal, and
    16 rows equal to the per-query plain model, each row's hops included.
    Returns 0 (bit-equal)."""
    from repro_torch.kernels.graph_beam import kernel as gk
    from repro_torch.kernels.graph_beam.ref import pairwise_sum
    from repro_torch.kernels.graph_beam_q.kernel import graph_traverse_q_cuda
    from repro_torch.kernels.graph_beam_q.ref import (graph_beam_q_ref,
                                                      graph_traverse_q_ref)
    from repro_torch.search import hnsw

    rng = np.random.default_rng(4)
    centers = rng.normal(size=(8, 64)) * 3
    x = (centers[rng.integers(0, 8, 2000)]
         + rng.normal(size=(2000, 64))).astype(np.float32)
    graph = hnsw.build(x, M=8, ef_construction=40, seed=0)
    qn = (x[rng.integers(0, 2000, 128)]
          + 0.05 * rng.normal(size=(128, 64))).astype(np.float32)
    smem_max = gk.SMEM_VISITED_MAX_N
    cases = 0
    dev = torch.device("cuda")
    try:
        for kind in ("sq8", "pq"):
            graph.codec = hnsw.make_graph_codes(x, kind, m=8, seed=0)
            for ef in (10, 80, 4096):
                for tomb in (False, True):
                    alive = None
                    if tomb:
                        alive = rng.random(2000) > 0.3
                        alive[graph.entry] = True
                    for q in (qn, qn[5:6]):
                        want = hnsw.search_batched(
                            graph, q, 10, ef_search=ef, device="cuda",
                            alive=alive, hop=graph_beam_q_ref)
                        for limit in (smem_max, 0):
                            gk.SMEM_VISITED_MAX_N = limit
                            got = hnsw.search_batched(
                                graph, q, 10, ef_search=ef, device="cuda",
                                alive=alive)
                            sync()
                            cases += 1
                            check(all(torch.equal(a, b) for a, b in
                                      zip(got[:3], want[:3]))
                                  and got[3] == want[3],
                                  f"quantized traversal {kind} ef={ef} "
                                  f"tombstones={tomb} Q={q.shape[0]} "
                                  f"visited in shared memory={limit > 0}: "
                                  f"differs from the plain-hop loop")
            gk.SMEM_VISITED_MAX_N = smem_max
            _, _, nbrs0, upper = graph.pack().device_arrays(graph.vecs, dev)
            codes, node_bias = graph.codec.device_arrays(dev)[:2]
            qt = torch.as_tensor(qn[:16], device="cuda")
            q_op, q_bias = graph.codec.query_operands(qt,
                                                      pairwise_sum(qt * qt))
            ops = (q_op.contiguous(), q_bias.contiguous(), codes, node_bias,
                   nbrs0, upper)
            kern = graph_traverse_q_cuda(*ops, graph.entry, 80, kind,
                                         graph.codec.ksub)
            plain = graph_traverse_q_ref(*(t.cpu() for t in ops),
                                         graph.entry, 80, kind,
                                         graph.codec.ksub)
            check(all(torch.equal(a.cpu(), b) for a, b in zip(kern, plain)),
                  f"quantized traversal kernel {kind} differs from the "
                  f"per-query plain model")
    finally:
        gk.SMEM_VISITED_MAX_N = smem_max
    log(f"phase 1: quantized graph traversal, one launch a search, {cases} "
        f"cases (N=2000 d=64 M=8, SQ8 and PQ8x8 payloads, 128 queries and "
        f"one, ef in (10, 80, 4096), tombstones or not, visited bits in "
        f"shared or device memory) == the plain-hop loop: ids, scores, "
        f"evals, hops equal; 16 rows == the per-query plain model, each "
        f"row's hops included")
    return 0.0


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """The same values, contiguous, one element past a 16-byte boundary:
    the kernels' scalar-load variants."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "an offset view")
    return view


def phase_kernels_rae_encode_variants(g: torch.Generator) -> float:
    """The encoder's in-kernel variants against the plain version: the
    tensor-map / wgmma path (m in 4, 8, 60, 64 x n in 4, 132, 768), every
    block-tile tier of the mma.sync path (m in 1, 8, 100, 512 x n in 1,
    129, 770), all over 333 rows (no multiple of a row tile), and rows one
    element off a 16-byte boundary. Within ``ENCODE_TOL``."""
    from repro_torch.kernels.rae_encode import rae_encode
    from repro_torch.kernels.rae_encode.ref import rae_encode_ref

    worst, worst_rel, cases = 0.0, 0.0, 0
    shapes = [(333, n, m) for n in (1, 129, 770) for m in (1, 8, 100, 512)]
    shapes += [(333, n, m) for n in (4, 132, 768) for m in (4, 8, 60, 64)]
    for rows, n, m in shapes + [(4096, 768, 64), (333, 128, 100)]:
        x = torch.randn(rows, n, device="cuda", generator=g)
        w = torch.randn(n, m, device="cuda", generator=g) / n ** 0.5
        views = [(x, w)] if (rows, n, m) in shapes else \
            [(offset_view(x), w), (offset_view(x), offset_view(w))]
        for xv, wv in views:
            for normalize in (False, True):
                z = rae_encode(xv, wv, normalize=normalize)
                sync()
                err, rel = max_rel_err(z, rae_encode_ref(x, w, normalize))
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                cases += 1
                check(rel <= ENCODE_TOL,
                      f"rae_encode {rows}x{n}x{m} normalize={normalize} "
                      f"aligned={xv.data_ptr() % 16 == 0}: err {err}")
    log(f"phase 1: rae_encode {cases} more cases (m in 1, 8, 100, 512 x n "
        f"in 1, 129, 770 and m in 4, 8, 60, 64 x n in 4, 132, 768, over 333 "
        f"rows; [4096,768]@[768,64] and "
        f"[333,128]@[128,100] with x, and x and w, one element off a "
        f"16-byte boundary; raw and normalized): max_abs_err {worst:.3e}, "
        f"over max(1, max |plain|) {worst_rel:.3e} (bar {ENCODE_TOL})")
    return worst


def phase_kernels_embedding_bag(g: torch.Generator) -> float:
    """The EmbeddingBag kernel against its plain version, float32 and
    bfloat16 tables, mean and sum: the reference's ragged cases
    (odd_shapes, d1), the two-tower's width (d=256, L=50) over a 1M-row
    table, and bags of length 0, past L and with ids outside [0, V).
    Both add a bag's rows in the same slot order: bit-equal."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    worst, cases = 0.0, 0
    for v, d, b, l in [(13, 5, 7, 3), (10, 1, 4, 5), (1_000_000, 256, 4096,
                                                      50)]:
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(v, d, device="cuda", generator=g).to(dtype)
            ids = torch.randint(-3, v + 3, (b, l), device="cuda",
                                generator=g, dtype=torch.int32)
            lens = torch.randint(1, l + 1, (b,), device="cuda", generator=g,
                                 dtype=torch.int32)
            lens[0], lens[-1] = 0, l + 7      # an empty bag, one past L
            for mode in ("mean", "sum"):
                got = embedding_bag(table, ids, lens, mode)
                sync()
                want = embedding_bag_ref(table, ids, lens, mode)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                cases += 1
                check(torch.equal(got, want),
                      f"embedding_bag V={v} d={d} B={b} L={l} {dtype} "
                      f"{mode}: kernel != plain (max_abs_err {err})")
    log(f"phase 1: embedding_bag {cases} cases ((V, d, B, L) in (13, 5, 7, "
        f"3), (10, 1, 4, 5), (1M, 256, 4096, 50); float32 and bfloat16; "
        f"mean and sum; lengths 0 and > L, ids outside [0, V)): bit-equal "
        f"to the plain version, max_abs_err {worst:.3e}")
    return worst


def zipf_ids(g: torch.Generator, shape: tuple, v: int) -> torch.Tensor:
    """Ids drawn with probability 1/rank over ``v`` rows (the train cells'
    token law): long runs of a few ids."""
    p = 1.0 / torch.arange(1, v + 1, device="cuda", dtype=torch.float64)
    n = int(np.prod(shape))
    return torch.multinomial(p, n, replacement=True, generator=g).to(
        torch.int32).reshape(shape)


def phase_kernels_embedding_bag_bwd(g: torch.Generator) -> float:
    """The backward kernel against its plain version: ragged bags (lengths
    past L, empty), tied ids (every slot of a bag one id, and Zipfian ids
    with runs of hundreds), ids clipped from outside [0, V), all-pad bags,
    bags of one (the row lookups), mean and sum; at the two-tower's bag
    (d = 256, L = 50) over 10M rows and at llama3.2-1b's tied embedding
    (128,256 x 2048, 8192 tokens). Both sum each row's slots in ascending
    (b, l) from zero: bit-equal."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_bwd_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_bwd_ref

    worst, cases = 0.0, 0
    shapes = [("ragged", 13, 5, 7, 3), ("d1", 10, 1, 4, 5),
              ("tied", 97, 24, 33, 37), ("clipped", 50, 96, 64, 8),
              ("all_pad", 40, 16, 9, 6), ("bag_of_one", 1000, 256, 4096, 1),
              ("two_tower_10M", 10_000_000, 256, 4096, 50),
              ("llama_tied_embed", 128_256, 2048, 8192, 1)]
    for name, v, d, b, l in shapes:
        grad = torch.randn(b, d, device="cuda", generator=g)
        ids = torch.randint(0, v, (b, l), device="cuda", generator=g,
                            dtype=torch.int32)
        lens = torch.randint(1, l + 1, (b,), device="cuda", generator=g,
                             dtype=torch.int32)
        if name == "ragged":
            lens[0], lens[-1] = 0, l + 7
        elif name == "tied":
            ids[: b // 2] = ids[: b // 2, :1]          # one id a bag
            ids[b // 2:] = zipf_ids(g, (b - b // 2, l), v)
        elif name == "clipped":
            ids = torch.randint(-v, 2 * v, (b, l), device="cuda",
                                generator=g, dtype=torch.int32)
        elif name == "all_pad":
            lens.zero_()
        elif name == "llama_tied_embed":
            ids = zipf_ids(g, (b, 1), v)
        if l == 1:
            lens.fill_(1)
        for mode in ("mean", "sum") if l > 1 else ("sum",):
            got = embedding_bag_bwd_cuda(grad, ids, lens, mode, v)
            sync()
            want = embedding_bag_bwd_ref(grad, ids, lens, mode, v)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            cases += 1
            check(torch.equal(got, want),
                  f"embedding_bag_bwd {name} V={v} d={d} B={b} L={l} {mode}:"
                  f" kernel != plain (max_abs_err {err})")
            if name == "all_pad":
                check(not bool(got.any()), "all-pad bags touched a row")
            del got, want
        free_card()
    names = ", ".join(s[0] for s in shapes)
    log(f"phase 1: embedding_bag_bwd {cases} cases ({names}; mean and sum): "
        f"bit-equal to the plain version, max_abs_err {worst:.3e}")
    return worst


def phase_kernels_flash_decode(g: torch.Generator) -> float:
    """The decode-attention kernel against its plain version, float32 and
    bfloat16 caches: the reference's ragged cases (ragged_s, cur1, dh1) and
    llama3.2-1b's heads (kh=8, g=4, dh=64) at cur_len 0, 1, ragged and S,
    past S, and over 70,001 positions (many splits); caches one element off
    a 16-byte boundary (the scalar variant), and live lengths at, around
    and inside a split's end. Float32 softmax sums in another order: within
    ``FLASH_REL`` of the largest magnitude."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    shapes = [(2, 2, 2, 8, 50, (37,)), (1, 1, 4, 8, 64, (1,)),
              (2, 1, 2, 1, 33, (20,)),
              (2, 8, 4, 64, 4096, (0, 1, 3001, 4096, 5000)),
              (1, 8, 4, 64, 70_001, (69_990,)), (1, 2, 3, 128, 300, (299,))]
    worst, worst_rel, cases = 0.0, 0.0, 0
    for b, kh, gq, dh, s, curs in shapes:
        q = torch.randn(b, kh, gq, dh, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            k = torch.randn(b, s, kh, dh, device="cuda", generator=g).to(dtype)
            v = torch.randn(b, s, kh, dh, device="cuda", generator=g).to(dtype)
            for cur in curs:
                cl = torch.tensor(cur, dtype=torch.int32, device="cuda")
                got = flash_decode(q, k, v, cl)
                sync()
                want = flash_decode_ref(q, k, v, cl)
                err, rel = rel_to_max(got, want)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                cases += 1
                check(rel <= FLASH_REL, f"flash_decode B={b} kh={kh} g={gq} "
                                        f"dh={dh} S={s} cur={cur} {dtype}: "
                                        f"err {err}")
                if cur == 0:
                    check(bool((got == 0).all()), "flash_decode at cur_len "
                                                  "0 is not zeros")
    from repro_torch.kernels.flash_decode.kernel import TILE, split_plan

    # caches one element off a 16-byte boundary (the scalar variant), and
    # live lengths that end a split, one short or past it, or mid-tile
    unaligned = [(2, 8, 4, 64, 4096, 3001), (1, 2, 3, 128, 300, 299),
                 (1, 1, 32, 128, 260, 200), (2, 2, 2, 6, 40, 33)]
    split, _ = split_plan(1, 8, 20_000, TILE)
    ends = [(1, 8, 4, 64, 20_000, cur) for cur in
            (split - 1, split, split + 1, 2 * split + 37)]
    for b, kh, gq, dh, s, cur in unaligned + ends:
        q = torch.randn(b, kh, gq, dh, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            k = torch.randn(b, s, kh, dh, device="cuda", generator=g).to(dtype)
            v = torch.randn(b, s, kh, dh, device="cuda", generator=g).to(dtype)
            if (b, kh, gq, dh, s, cur) in unaligned:
                k, v = offset_view(k), offset_view(v)
            cl = torch.tensor(cur, dtype=torch.int32, device="cuda")
            got = flash_decode(q, k, v, cl)
            sync()
            err, rel = rel_to_max(got, flash_decode_ref(q, k, v, cl))
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            cases += 1
            check(rel <= FLASH_REL, f"flash_decode B={b} kh={kh} g={gq} "
                                    f"dh={dh} S={s} cur={cur} {dtype} "
                                    f"aligned={k.data_ptr() % 16 == 0}: "
                                    f"err {err}")
    log(f"phase 1: flash_decode {cases} cases (the reference's ragged_s, "
        f"cur1, dh1; llama3.2-1b heads at cur_len 0, 1, 3001, S, > S over "
        f"S=4096 and 69,990 of 70,001; dh=128; float32 and bfloat16 "
        f"caches; caches one element off a 16-byte boundary at dh 64, 128 "
        f"and 6, g up to 32; lengths {split - 1}, {split}, {split + 1} and "
        f"{2 * split + 37} over splits of {split}): max_abs_err "
        f"{worst:.3e}, over max |plain| {worst_rel:.3e} (bar {FLASH_REL})")
    return worst


def phase_kernels_pq_adc(g: torch.Generator) -> float:
    """The ADC scan kernel against its plain version: ids equal and values
    bit-equal in every case (both sum the LUT and the m entries in one
    tree). Ragged Q and N, k > N (the op pads), d = 1, m in {1, 8, 16}
    (16: four-query tiles), ksub in {16, 256}, k up to the kernel's limit,
    N shorter than a code tile, pilots at every k whose sample holds k
    rows; integer and float inputs, and every row one code (every score
    tied, the lower row first, lists cut again and again)."""
    from repro_torch.kernels.pq_adc import pq_adc
    from repro_torch.kernels.pq_adc.kernel import MAX_K
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref

    worst, cases = 0.0, 0
    shapes = [(100_003, 8, 256, 8, 320), (100_003, 8, 256, 8, 2048),
              (100_003, 8, 256, 8, MAX_K), (100_003, 1, 16, 1, 10),
              (20_011, 16, 16, 4, 1), (20_011, 16, 256, 2, 40),
              (2_047, 8, 256, 8, 2_000), (77, 8, 256, 8, 100)]
    for (n, m, ksub, dsub, k), tied in itertools.product(shapes,
                                                         (False, True)):
        codes = torch.randint(0, ksub, (n, m), device="cuda", generator=g,
                              dtype=torch.uint8)
        if tied:
            codes[:] = codes[0]
        for integer in (True, False):
            if integer:
                q = torch.randint(-3, 4, (257, m * dsub), device="cuda",
                                  generator=g).float()
                cb = torch.randint(-3, 4, (m, ksub, dsub), device="cuda",
                                   generator=g).float()
            else:
                q = torch.randn(257, m * dsub, device="cuda", generator=g)
                cb = torch.randn(m, ksub, dsub, device="cuda", generator=g)
            for nq in (1, 257):
                v, i = pq_adc(q[:nq], cb, codes, k)
                sync()
                k_eff = min(k, n)
                vr, ir = pq_adc_ref(q[:nq], cb, codes, k_eff)
                err, _ = max_rel_err(v[:, :k_eff], vr)
                worst = max(worst, err)
                what = (f"pq_adc Q={nq} N={n} m={m} ksub={ksub} dsub={dsub} "
                        f"k={k} integer={integer} tied={tied}")
                check(torch.equal(i[:, :k_eff], ir), f"{what}: ids differ")
                check(torch.equal(v[:, :k_eff].view(torch.int32),
                                  vr.view(torch.int32)),
                      f"{what}: values not bit-equal")
                check(bool((i[:, k_eff:] == -1).all()
                           and torch.isneginf(v[:, k_eff:]).all()),
                      f"{what}: the k > N tail is not (-inf, -1)")
                cases += 1
    log(f"phase 1: pq_adc {cases} cases (Q in {{1, 257}}, (N, m, ksub, "
        f"dsub, k) in {shapes}, integer and float inputs, random and tied "
        f"codes): ids equal and values bit-equal in all")
    return worst


def phase_kernels_graph_beam_q(g: torch.Generator) -> float:
    """The quantized hop kernel against its plain version over 1M code
    rows: ids equal and scores bit-equal in every case (both sum in
    pairwise_sum's tree). SQ8 (d = 64 and d = 1) and PQ (m in {1, 8, 16},
    ksub in {16, 256}), Q in {1, 257}, W in {1, 64, 1024}, ef in {1, 80,
    4096}, about 25% masked slots, with and without db_mask."""
    from repro_torch.kernels.graph_beam_q import graph_beam_q
    from repro_torch.kernels.graph_beam_q.ref import graph_beam_q_ref

    worst, cases = 0.0, 0
    n = 1_000_003
    grid = [(w, ef) for w in (1, 64, 1024) for ef in (1, 80, 4096)]
    payloads = [("sq8", 64, 0, grid), ("pq", 8, 256, grid),
                ("sq8", 1, 0, [(64, 80)]), ("pq", 1, 16, [(64, 80)]),
                ("pq", 16, 16, [(1024, 4096), (64, 80)])]
    mask = torch.rand(n, device="cuda", generator=g) > 0.25
    for mode, c, ksub, shapes in payloads:
        hi = 256 if mode == "sq8" else ksub
        codes = torch.randint(0, hi, (n, c), device="cuda", generator=g,
                              dtype=torch.uint8)
        dop = c if mode == "sq8" else c * ksub
        for integer in (True, False):
            if integer:
                q_op = torch.randint(-3, 4, (257, dop), device="cuda",
                                     generator=g).float()
                q_bias = torch.randint(-3, 4, (257,), device="cuda",
                                       generator=g).float()
                nb = torch.randint(0, 9, (n,), device="cuda",
                                   generator=g).float()
            else:
                q_op = 0.1 * torch.randn(257, dop, device="cuda", generator=g)
                q_bias = torch.randn(257, device="cuda", generator=g)
                nb = torch.randn(n, device="cuda", generator=g).abs()
            for nq in (1, 257):
                for w, ef in shapes:
                    empty = float("-inf") if nq == 1 else -1e30
                    ids, bv, bi = beam_inputs(g, nq, n, w, ef, integer, empty)
                    for db_mask in (None, mask):
                        args = (q_op[:nq], q_bias[:nq], codes, nb, ids, bv, bi)
                        v, i = graph_beam_q(*args, db_mask=db_mask, mode=mode,
                                            ksub=ksub)
                        sync()
                        vr, ir = graph_beam_q_ref(*args, db_mask=db_mask,
                                                  mode=mode, ksub=ksub)
                        err, _ = max_rel_err(v, vr)
                        worst = max(worst, err)
                        what = (f"graph_beam_q {mode} C={c} ksub={ksub} "
                                f"Q={nq} W={w} ef={ef} integer={integer} "
                                f"mask={db_mask is not None}")
                        check(torch.equal(i, ir), f"{what}: ids differ")
                        check(torch.equal(v.view(torch.int32),
                                          vr.view(torch.int32)),
                              f"{what}: scores not bit-equal")
                        cases += 1
        del codes, nb
    log(f"phase 1: graph_beam_q N={n}, {cases} cases (sq8 d in {{64, 1}}, "
        f"pq (m, ksub) in {{(8, 256), (1, 16), (16, 16)}}, Q in {{1, 257}}, "
        f"W in {{1, 64, 1024}}, ef in {{1, 80, 4096}}, integer and float, "
        f"with and without db_mask): ids equal and scores bit-equal in all")
    return worst


def merge_inputs(g: torch.Generator, nq: int, c: int, pads: float = 0.25,
                 drained: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Gathered shard candidates: ids unique per row with a share of pads
    (-1; about 25%), integer values (dense ties), about 20% signed zeros
    (-0.0 ties +0.0) and about 5% live ids at NEG_INF; ``drained``: the
    first row all pads."""
    from repro_torch.kernels.common import NEG_INF

    ids = torch.argsort(torch.rand(nq, 4 * c, device="cuda", generator=g),
                        dim=1)[:, :c].to(torch.int32)
    ids[torch.rand(nq, c, device="cuda", generator=g) < pads] = -1
    if drained:
        ids[0] = -1
    vals = torch.randint(-3, 4, (nq, c), device="cuda", generator=g).float()
    vals[torch.rand(nq, c, device="cuda", generator=g) < 0.2] = -0.0
    vals[torch.rand(nq, c, device="cuda", generator=g) < 0.05] = NEG_INF
    return vals.contiguous(), ids.contiguous()


#: phase 1's merge cases past the parent's: C on both sides of the narrow
#: blocks' limit (1024), k = C at it, more pads than C - k; (C, k, share
#: of pads), each with its first row all pads
MERGE_BOUNDARY = ((1024, 40, 0.25), (1025, 40, 0.25), (1024, 1024, 0.25),
                  (1025, 1000, 0.6), (320, 300, 0.5))


def phase_kernels_topk_merge(g: torch.Generator) -> float:
    """The merge kernel against its plain version: ids equal and values
    bit-equal (the sign of zero included) in every case."""
    from repro_torch.kernels.topk_merge import topk_merge
    from repro_torch.kernels.topk_merge.ref import topk_merge_ref

    worst, cases = 0.0, 0
    for nq in (1, 257):
        for c, k, pads, drained in (
                [(c, k, 0.25, False) for c, k in ((1, 3), (6, 10), (96, 16),
                                                  (320, 40), (16384, 2048))]
                + [(c, k, p, True) for c, k, p in MERGE_BOUNDARY]):
            vals, ids = merge_inputs(g, nq, c, pads, drained)
            v, i = topk_merge(vals, ids, k)
            sync()
            vr, ir = topk_merge_ref(vals, ids, k)
            err, _ = max_rel_err(v, vr)
            worst = max(worst, err)
            what = f"topk_merge Q={nq} C={c} k={k} pads={pads}"
            check(torch.equal(i, ir), f"{what}: ids differ")
            check(torch.equal(v.view(torch.int32), vr.view(torch.int32)),
                  f"{what}: values not bit-equal")
            cases += 1
    log(f"phase 1: topk_merge {cases} cases (Q in {{1, 257}}, (C, k) in "
        f"{{(1, 3), (6, 10), (96, 16), (320, 40), (16384, 2048)}}, 25% pads, "
        f"integer values, signed zeros, live NEG_INF; and (C, k, pads) in "
        f"{MERGE_BOUNDARY} with the first row all pads): ids equal and "
        f"values bit-equal in all")
    return worst


def beam_inputs(g: torch.Generator, nq: int, n: int, w: int, ef: int,
                integer: bool, empty: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate ids (about 25% masked -1) and a descending beam whose
    first half holds real entries in the candidates' score range (integer
    scores there, so beam and candidates tie)."""
    ids = torch.randint(0, n, (nq, w), device="cuda", generator=g,
                        dtype=torch.int32)
    ids[torch.rand(nq, w, device="cuda", generator=g) < 0.25] = -1
    live = (ef + 1) // 2
    if integer:
        vals = -torch.randint(100, 900, (nq, live), device="cuda",
                              generator=g).float()
    else:
        vals = -128.0 + 23.0 * torch.randn(nq, live, device="cuda",
                                           generator=g)
    bv = torch.full((nq, ef), empty, device="cuda")
    bi = torch.full((nq, ef), -1, device="cuda", dtype=torch.int32)
    bv[:, :live] = torch.sort(vals, dim=1, descending=True).values
    bi[:, :live] = torch.randint(0, n, (nq, live), device="cuda",
                                 generator=g, dtype=torch.int32)
    return ids, bv, bi


def phase_kernels_graph_beam(g: torch.Generator) -> float:
    """The hop kernel against its plain version on a 1M-row corpus: ids
    equal; scores bit-equal on integer inputs, within SCORE_TOL on float
    inputs (the kernel sums in the plain version's order, so they are
    bit-equal there too, and the error is printed)."""
    from repro_torch.kernels.graph_beam import graph_beam
    from repro_torch.kernels.graph_beam.ref import graph_beam_ref

    worst = 0.0
    n = 1_000_003
    for d, shapes in ((64, [(nq, w, ef) for nq in (1, 257)
                            for w in (1, 64, 512) for ef in (1, 80, 2048)]),
                      (1, [(257, 64, 80)])):
        mask = torch.rand(n, device="cuda", generator=g) > 0.25
        for integer in (True, False):
            if integer:
                q = torch.randint(-3, 4, (257, d), device="cuda",
                                  generator=g).float()
                db = torch.randint(-3, 4, (n, d), device="cuda",
                                   generator=g).float()
            else:
                q = torch.randn(257, d, device="cuda", generator=g)
                db = torch.randn(n, d, device="cuda", generator=g)
            cases = bit_equal = 0
            for nq, w, ef in shapes:
                empty = float("-inf") if nq == 1 else -1e30
                ids, bv, bi = beam_inputs(g, nq, n, w, ef, integer, empty)
                for db_mask in (None, mask):
                    args = (q[:nq], db, ids, bv, bi)
                    v, i = graph_beam(*args, db_mask=db_mask)
                    sync()
                    vr, ir = graph_beam_ref(*args, db_mask=db_mask)
                    err, rel = max_rel_err(v, vr)
                    worst = max(worst, err)
                    what = (f"graph_beam d={d} Q={nq} W={w} ef={ef} "
                            f"integer={integer} mask={db_mask is not None}")
                    check(torch.equal(i, ir), f"{what}: ids differ")
                    if integer:
                        check(torch.equal(v, vr), f"{what}: scores differ")
                    check(rel <= SCORE_TOL, f"{what}: score err {err}")
                    cases += 1
                    bit_equal += int(torch.equal(v, vr))
            log(f"phase 1: graph_beam N={n} d={d} "
                f"{'integer' if integer else 'float'} inputs, {cases} cases "
                f"(Q in {{1, 257}}, W, ef, with and without db_mask): ids "
                f"equal in all, scores bit-equal in {bit_equal}/{cases}")
            del db
    return worst


# ---------------------------------------------------------------------------
# Phase 2: acceptance at the reference's bar (tests/test_api.py)
# ---------------------------------------------------------------------------
def acceptance_data() -> tuple[np.ndarray, np.ndarray]:
    """The 20k x 256 corpus and the 64 queries of tests/conftest.py."""
    from repro_torch.data import embedding_corpus

    corpus = embedding_corpus(20000, 256, n_clusters=16, intrinsic=64,
                              seed=0)
    rng = np.random.default_rng(1)
    picks = rng.integers(0, 20000, 64)
    noise = 0.01 * rng.standard_normal((64, 256)).astype(np.float32)
    return corpus, corpus[picks] + noise


ACCEPTANCE_SPECS = ("RAE64,Flat,Rerank4", "RAE64,IVF256,Rerank4",
                    "RAE64,Shard8,IVF256,Rerank4",
                    "RAE64,IVF256,PQ8x8,Rerank4")
#: the reference's quantized acceptance bar (tests/test_quantized.py:244)
PQ_ACCEPTANCE = 0.85


def phase_acceptance(device: str, steps: int = 1000) -> dict[str, float]:
    """Each stack on the 20k x 256 corpus. The reference's bars: recall@10
    >= 0.9 for the two specs it gates (tests/test_api.py:255: Flat and
    IVF256); for ``RAE64,IVF256,PQ8x8,Rerank4`` recall@10 >= 0.85 at <= 1/8
    the bytes per vector of ``RAE64,Flat`` (tests/test_quantized.py:244).
    The sharded stack is held to the reference's sharded gate, recall
    within 0.01 of its unsharded twin (README, scripts/check_bench.py), and
    its distance to 0.9 is printed."""
    from repro_torch import api
    from repro_torch.core import metrics

    corpus, queries = acceptance_data()
    gt = metrics.knn_indices(torch.as_tensor(queries, device=device),
                             torch.as_tensor(corpus, device=device), 10)
    recalls, failed, bpv = {}, [], {}
    for spec in ACCEPTANCE_SPECS:
        t0 = time.perf_counter()
        idx = api.index_factory(spec, reducer_kw={"steps": steps, "seed": 0},
                                device=device)
        idx.build(corpus)
        res = idx.search(queries, 10)
        recall = metrics.recall_at_k(torch.as_tensor(res.indices,
                                                     device=device), gt)
        with tempfile.TemporaryDirectory() as tmp:
            idx.save(tmp)
            res2 = api.load_index(tmp, device=device).search(queries, 10)
        same = bool(np.array_equal(res2.indices, res.indices)
                    and np.array_equal(res2.scores, res.scores))
        dt = time.perf_counter() - t0
        bpv[spec] = idx.bytes_per_vector
        log(f"phase 2: {spec} on 20000x256, {steps} steps, 64 queries: "
            f"recall@10 {recall:.4f} ({round(recall * 640)} of 640 hits), "
            f"distance_evals {res.distance_evals:.1f}, bytes_per_vector "
            f"{bpv[spec]:g}, reload identical {same}, {dt:.2f} s")
        recalls[spec] = recall
        if "PQ" in spec:
            flat = bpv[ACCEPTANCE_SPECS[0]]
            log(f"phase 2: {spec}: recall@10 {recall:.4f} (bar "
                f"{PQ_ACCEPTANCE}), bytes_per_vector {bpv[spec]:g} = "
                f"1/{flat / bpv[spec]:.2f} of RAE64,Flat's {flat:g} (bar "
                f"1/8)")
            if recall < PQ_ACCEPTANCE:
                failed.append(f"{spec}: acceptance recall@10 {recall} < "
                              f"{PQ_ACCEPTANCE}")
            if bpv[spec] > flat / 8:
                failed.append(f"{spec}: {bpv[spec]} bytes per vector > 1/8 "
                              f"of RAE64,Flat's {flat}")
        elif "Shard" in spec:
            twin = recalls[spec.replace("Shard8,", "")]
            log(f"phase 2: {spec}: recall@10 - twin's = {recall - twin:+.4f} "
                f"(gate: within 0.01); against the 0.9 bar "
                f"{recall - 0.9:+.4f}")
            if abs(recall - twin) > 0.01:
                failed.append(f"{spec}: recall@10 {recall} not within 0.01 "
                              f"of the twin's {twin}")
        elif recall < 0.9:
            failed.append(f"{spec}: acceptance recall@10 {recall} < 0.9")
        if not same:
            failed.append(f"{spec}: load_index answers differ from the "
                          f"saved index's")
    ACCEPTANCE.update(recalls)
    check(not failed, "; ".join(failed))
    return recalls


#: phase 2's recall@10 a spec, for phase 9's baseline stacks
ACCEPTANCE: dict = {}


# ---------------------------------------------------------------------------
# Phase 3: full size
# ---------------------------------------------------------------------------
def plain_path(idx, queries: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same stack with every kernel replaced by its plain version."""
    from repro_torch.kernels.l2_topk.ref import l2_topk_ref
    from repro_torch.kernels.rae_encode.ref import rae_encode_ref
    from repro_torch.search.twostage import rerank_candidates

    w_e = idx.reducer.params_["w_e"]
    zc = rae_encode_ref(idx._db_full, w_e, False)
    zq = rae_encode_ref(queries, w_e, False)
    _, cand = l2_topk_ref(zq, zc, idx.stage1_k(k))
    return rerank_candidates(queries, idx._db_full, cand, k, idx.metric)


def phase_full(n: int, n_queries: int, batch: int, steps: int,
               device: str) -> dict:
    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.data import paper_dataset
    from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda
    from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda

    t0 = time.perf_counter()
    data = paper_dataset("imdb_like", n=n + n_queries, seed=0)
    corpus, queries = data[:n], data[n:]   # held-out queries (rows shuffled)
    t_data = time.perf_counter() - t0
    idx = api.index_factory("RAE64,Flat,Rerank4",
                            reducer_kw={"steps": steps, "batch_size": 128,
                                        "seed": 0}, device=device)
    launches = {}

    # the main path, with every launch counter from 0
    rae_encode_cuda.launches = 0
    l2_topk_scan_cuda.launches = 0
    t0 = time.perf_counter()
    idx.build(corpus)
    sync()
    t_build = time.perf_counter() - t0
    launches["build"] = {"rae_encode": rae_encode_cuda.launches,
                         "l2_topk": l2_topk_scan_cuda.launches}
    results, lat = [], []
    for s in range(0, n_queries, batch):
        res = idx.search(queries[s:s + batch], 10)
        results.append(res)
        lat.append(res.latency_s)
    launches["total"] = {"rae_encode": rae_encode_cuda.launches,
                         "l2_topk": l2_topk_scan_cuda.launches}
    launches["search"] = {k: launches["total"][k] - launches["build"][k]
                          for k in launches["total"]}
    batches = len(results)
    log(f"phase 3: main-path launches: build {launches['build']}, "
        f"{batches} searches {launches['search']}")
    check(all(v > 0 for v in launches["total"].values()),
          f"a kernel of the main path never launched: {launches['total']}")
    check(launches["search"]["l2_topk"] == batches
          and launches["search"]["rae_encode"] == batches,
          "each search launches rae_encode and l2_topk once")

    ids = np.concatenate([r.indices for r in results])
    scores = np.concatenate([r.scores for r in results])
    check(ids.shape == (n_queries, 10) and np.isfinite(scores).all()
          and (ids >= 0).all() and (ids < n).all(),
          "full-size answers: shape, finite scores, ids in range")

    # one query at a time, as an unbatched client sends them
    lat1 = [idx.search(queries[i:i + 1], 10).latency_s for i in range(32)]
    # layers of one search batch, each timed on its own
    qb = torch.as_tensor(queries[:batch], device=device)
    k1 = idx.stage1_k(10)
    zq = idx.reducer.transform(qb)
    sync()
    t0 = time.perf_counter()
    zq = idx.reducer.transform(qb)
    sync()
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage1 = idx.base.search(zq, k1)
    t_scan = time.perf_counter() - t0
    from repro_torch.search.twostage import rerank_candidates
    cand = torch.as_tensor(stage1.indices, device=device)
    sync()
    t0 = time.perf_counter()
    rerank_candidates(qb, idx._db_full, cand, 10, idx.metric)
    sync()
    t_rerank = time.perf_counter() - t0

    # recall against the exact full-space scan (plain, not the main path)
    t0 = time.perf_counter()
    qt = torch.as_tensor(queries, device=device)
    gt = metrics.knn_indices(qt, idx._db_full, 10)
    recall = metrics.recall_at_k(torch.as_tensor(ids, device=device), gt)
    t_gt = time.perf_counter() - t0
    # the kernel path against the plain path, first 128 queries
    _, plain_ids = plain_path(idx, qt[:128], 10)
    same = int((torch.as_tensor(ids[:128], device=device)
                == plain_ids).sum())
    log(f"phase 3: imdb_like n={n} d=768 RAE64,Flat,Rerank4 (no cut), "
        f"{steps} steps batch 128; {n_queries} queries k=10 in batches of "
        f"{batch}: recall@10 {recall:.4f}; kernel ids == plain ids on 128 "
        f"queries: {same}/1280")
    log(f"phase 3: times: data {t_data:.2f} s, build {t_build:.2f} s "
        f"(fit + corpus encode + Flat build), search latency per batch "
        f"median {float(np.median(lat)) * 1e3:.3f} ms max "
        f"{max(lat) * 1e3:.3f} ms, single-query latency median "
        f"{float(np.median(lat1)) * 1e3:.3f} ms over 32; one batch's "
        f"layers: encode "
        f"{t_encode * 1e3:.3f} ms, scan {stage1.latency_s * 1e3:.3f} ms "
        f"(wall {t_scan * 1e3:.3f} ms), rerank {t_rerank * 1e3:.3f} ms; "
        f"exact ground truth {t_gt:.2f} s")
    check(same == 1280, "kernel path ids differ from the plain path's")
    return {"idx": idx, "qb": qb, "zq": zq, "k1": k1, "launches": launches,
            "recall": recall, "queries": queries}


def kernel_times(full: dict) -> list[dict]:
    """Each kernel at the main path's full-size shapes: its time, its plain
    version's, one PyTorch library call's, and its bound."""
    from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda
    from repro_torch.kernels.l2_topk.ref import l2_topk_scan_ref, prepare
    from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda
    from repro_torch.kernels.rae_encode.ref import rae_encode_ref

    idx = full["idx"]
    x, w = idx._db_full, idx.reducer.params_["w_e"]
    rows, n = x.shape
    m = w.shape[1]
    enc_ms = cuda_ms(lambda: rae_encode_cuda(x, w, False), reps=10)
    enc_plain = cuda_ms(lambda: rae_encode_ref(x, w, False), reps=10)
    enc_lib = cuda_ms(lambda: torch.matmul(x, w), reps=10)
    # the kernel's work: three TF32 products on the tensor cores (3xTF32);
    # the float32 product on SIMT float32, for comparison
    enc_bytes = 4.0 * (rows * n + n * m + rows * m)
    enc_bound, enc_by = bound(enc_bytes, 3 * 2.0 * rows * n * m,
                              PEAK_TF32_FLOPS)
    simt_bound, simt_by = bound(enc_bytes, 2.0 * rows * n * m)
    log(f"phase 3: rae_encode [{rows},{n}]@[{n},{m}]: kernel {enc_ms:.4f} "
        f"ms, plain {enc_plain:.4f} ms, torch.matmul {enc_lib:.4f} ms, "
        f"bound with tensor cores {enc_bound:.4f} ms ({enc_by}; 3xTF32 at "
        f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), on SIMT float32 "
        f"{simt_bound:.4f} ms ({simt_by}); kernel at "
        f"{enc_bytes / enc_ms / 1e6:.1f} GB/s")

    q, d, d_sq = prepare(full["zq"], idx.base._db, "euclidean", None)
    nq, dim = q.shape
    nrow, k = d.shape[0], full["k1"]
    scan_ms = cuda_ms(lambda: l2_topk_scan_cuda(q, d, d_sq, k), reps=10)
    scan_plain = cuda_ms(lambda: l2_topk_scan_ref(q, d, d_sq, k), reps=3)
    scan_lib = cuda_ms(lambda: torch.topk(2.0 * (q @ d.T) - d_sq, k),
                       reps=10)
    scan_bound, scan_by = bound(
        4.0 * (nq * dim + nrow * dim + nrow) + 8.0 * nq * k,
        2.0 * nq * nrow * dim + 2.0 * nq * nrow)
    log(f"phase 3: l2_topk Q={nq} N={nrow} d={dim} k={k}: kernel "
        f"{scan_ms:.4f} ms, plain {scan_plain:.4f} ms, torch.matmul + "
        f"torch.topk {scan_lib:.4f} ms, bound {scan_bound:.4f} ms "
        f"({scan_by})")
    # the top rung of rerank_k1 (KNOB_LADDER), through the API: a search
    # with SearchParams(rerank_k1=2048) launches the scan once at k = 2048
    from repro_torch.api.index import SearchParams

    top = 2048
    l2_topk_scan_cuda.launches = 0
    res = idx.search(full["queries"][:nq], 10,
                     params=SearchParams(rerank_k1=top))
    top_launches = l2_topk_scan_cuda.launches
    check(top_launches == 1 and res.indices.shape == (nq, 10),
          f"a rerank_k1={top} search launched l2_topk {top_launches} times")
    v, i = l2_topk_scan_cuda(q, d, d_sq, top)
    vr, ir = l2_topk_scan_ref(q, d, d_sq, top)
    check(torch.equal(i, ir) and max_rel_err(v, vr)[1] <= SCORE_TOL,
          f"l2_topk k={top} at full size differs from the plain version")
    top_ms = cuda_ms(lambda: l2_topk_scan_cuda(q, d, d_sq, top), reps=10)
    top_lib = cuda_ms(lambda: torch.topk(2.0 * (q @ d.T) - d_sq, top),
                      reps=10)
    top_bound, top_by = bound(
        4.0 * (nq * dim + nrow * dim + nrow) + 8.0 * nq * top,
        2.0 * nq * nrow * dim + 2.0 * nq * nrow)
    log(f"phase 3: l2_topk Q={nq} N={nrow} d={dim} k={top}: kernel "
        f"{top_ms:.4f} ms, torch.matmul + torch.topk {top_lib:.4f} ms, "
        f"bound {top_bound:.4f} ms ({top_by}); launches in a "
        f"rerank_k1={top} search: {top_launches}; ids == plain ids")
    launches = full["launches"]["total"]
    return [
        {"name": "rae_encode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rae_encode.cu",
         "replaces": "src/repro/kernels/rae_encode/kernel.py:39",
         "launches": launches["rae_encode"], "ms": enc_ms,
         "plain_ms": enc_plain, "bound_ms": enc_bound, "bound_by": enc_by,
         "library_ms": enc_lib},
        {"name": "l2_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/l2_topk.cu",
         "replaces": "src/repro/kernels/l2_topk/kernel.py:82",
         "launches": launches["l2_topk"], "ms": scan_ms,
         "plain_ms": scan_plain, "bound_ms": scan_bound, "bound_by": scan_by,
         "library_ms": scan_lib,
         "k2048": {"launches": top_launches, "ms": top_ms,
                   "bound_ms": top_bound, "bound_by": top_by,
                   "library_ms": top_lib}},
    ]


# ---------------------------------------------------------------------------
# Phase 4: the graph stack RAE64,HNSW32,Rerank4 (tests/test_graph.py bar)
# ---------------------------------------------------------------------------
def noisy_queries(corpus: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Corpus rows plus small noise: the acceptance protocol's queries."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, corpus.shape[0], n)
    return corpus[picks] + 0.01 * rng.standard_normal(
        (n, corpus.shape[1])).astype(np.float32)


def phase_graph(device: str, steps: int = 1000, batch: int = 256) -> dict:
    """Drive the graph stack; returns the main path's launch counts and
    what the traversal's timing needs (the graph, a reduced batch, k1,
    ef)."""
    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.kernels.graph_beam.kernel import (graph_beam_cuda,
                                                       graph_traverse_cuda)
    from repro_torch.kernels.graph_beam.ref import graph_beam_ref
    from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda
    from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda
    from repro_torch.search import hnsw
    from repro_torch.search.twostage import rerank_candidates

    counters = {"rae_encode": rae_encode_cuda, "l2_topk": l2_topk_scan_cuda,
                "graph_beam": graph_beam_cuda,
                "graph_traverse": graph_traverse_cuda}
    corpus, queries = acceptance_data()
    noisy = noisy_queries(corpus, 1024, seed=2)
    n = corpus.shape[0]
    idx = api.index_factory("RAE64,HNSW32,Rerank4",
                            reducer_kw={"steps": steps, "seed": 0},
                            device=device)

    # the main path, with every launch counter from 0
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    idx.reducer.fit(corpus)
    sync()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.build(corpus)               # the fitted reducer is kept
    sync()
    t_build = time.perf_counter() - t0
    res = idx.search(queries, 10)
    batches, per_batch = [], []
    for s in range(0, len(noisy), batch):
        before = graph_traverse_cuda.launches
        r = idx.search(noisy[s:s + batch], 10)
        batches.append(r)
        per_batch.append((r.latency_s, r.stats["beam_hops"],
                          graph_traverse_cuda.launches - before))
    singles = [idx.search(noisy[i:i + 1], 10) for i in range(len(noisy))]
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 4: main-path launches {launches}")
    check(launches["rae_encode"] > 0 and launches["graph_traverse"] > 0,
          f"a kernel of the graph path never launched: {launches}")
    check(all(p[2] == 1 for p in per_batch)
          and launches["graph_traverse"] == len(per_batch) + len(noisy) + 1
          and launches["graph_beam"] == 0,
          f"a graph search is not one traversal launch: {per_batch}, "
          f"{launches}")

    gt = metrics.knn_indices(torch.as_tensor(queries, device=device),
                             torch.as_tensor(corpus, device=device), 10)
    recall = metrics.recall_at_k(torch.as_tensor(res.indices,
                                                 device=device), gt)
    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        res2 = api.load_index(tmp, device=device).search(queries, 10)
    reload_same = bool(np.array_equal(res2.indices, res.indices)
                       and np.array_equal(res2.scores, res.scores))
    ids = np.concatenate([r.indices for r in batches])
    single_ids = np.concatenate([r.indices for r in singles])
    log(f"phase 4: RAE64,HNSW32,Rerank4 on {n}x256, {steps} steps, 64 "
        f"queries: recall@10 {recall:.4f}, distance_evals "
        f"{res.distance_evals:.1f} ({res.distance_evals / n:.4f} of N; "
        f"stage 1 {res.stats['stage1_distance_evals']:.1f}, beam hops "
        f"{res.stats['beam_hops']:.0f}), reload identical {reload_same}")
    check(recall >= 0.9, f"graph acceptance recall@10 {recall} < 0.9")
    check(res.distance_evals < 0.10 * n,
          f"distance_evals {res.distance_evals} >= 10% of N")
    check(reload_same, "load_index answers differ from the saved index's")
    nn = len(noisy)
    check(ids.shape == (nn, 10) and (ids >= 0).all() and (ids < n).all()
          and all(np.isfinite(r.scores).all() for r in batches),
          "graph answers: shape, finite scores, ids in range")
    same_single = int((single_ids == ids).all(axis=1).sum())
    log(f"phase 4: {nn} noisy queries: one at a time == in batches of "
        f"{batch} (ids) for {same_single}/{nn} queries")
    check(same_single >= 0.99 * nn,
          f"only {same_single}/{nn} queries answer alone as in a batch")

    # the kernel-hop traversal against the plain-hop one, same graph
    g = idx.base._g
    zq = idx.reducer.transform(torch.as_tensor(noisy, device=device))
    k1, ef = idx.stage1_k(10), max(idx.base.ef_search, idx.stage1_k(10))
    kern = hnsw.search_batched(g, zq, k1, ef_search=ef, device=device)
    plain = hnsw.search_batched(g, zq, k1, ef_search=ef, device=device,
                                hop=graph_beam_ref)
    agree = int((kern[1] == plain[1]).all(dim=1).sum())
    log(f"phase 4: kernel-hop traversal == plain-hop traversal (ids) for "
        f"{agree}/{nn} queries; scores bit-equal "
        f"{bool(torch.equal(kern[0], plain[0]))}; evals equal "
        f"{bool(torch.equal(kern[2], plain[2]))}; hops {kern[3]} / "
        f"{plain[3]}")
    check(agree >= 0.99 * nn, f"kernel and plain traversals agree for "
                              f"only {agree}/{nn} queries")
    # the one-launch traversal is the plain-hop loop, row for row
    check(all(torch.equal(a, b) for a, b in zip(kern[:3], plain[:3]))
          and kern[3] == plain[3],
          "the traversal kernel's ids, scores, evals or hops differ from "
          "the plain-hop loop's")
    # every stage-1 answer alone == the same row of the batch
    alone = 0
    for i in range(nn):
        one = hnsw.search_batched(g, zq[i:i + 1], k1, ef_search=ef,
                                  device=device)
        alone += all(torch.equal(a[0], b[i])
                     for a, b in zip(one[:3], kern[:3]))
    log(f"phase 4: stage-1 answers alone == in the {nn}-query batch (ids, "
        f"scores, evals) for {alone}/{nn} queries")
    check(alone == nn, f"only {alone}/{nn} stage-1 answers alone equal "
                       f"their batch rows")

    # layers of one batch, each timed on its own
    qb = torch.as_tensor(noisy[:batch], device=device)
    sync()
    t0 = time.perf_counter()
    zb = idx.reducer.transform(qb)
    sync()
    t_encode = time.perf_counter() - t0
    before = graph_traverse_cuda.launches
    t0 = time.perf_counter()
    s1 = idx.base.search(zb, k1)
    t_stage1 = time.perf_counter() - t0
    hop_launches = graph_traverse_cuda.launches - before
    cand = torch.as_tensor(s1.indices, device=device)
    sync()
    t0 = time.perf_counter()
    rerank_candidates(qb, idx._db_full, cand, 10, idx.metric)
    sync()
    t_rerank = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.reducer.transform(torch.as_tensor(corpus, device=device))
    sync()
    t_corpus_encode = time.perf_counter() - t0
    wall_ms, busy, hop_ms = device_busy_share(
        lambda: idx.search(noisy[:batch], 10), "graph_traverse")
    wall1_ms, busy1, _ = device_busy_share(
        lambda: idx.search(noisy[:1], 10), "graph_traverse")
    lat1 = [r.latency_s for r in singles]
    hops1 = [r.stats["beam_hops"] for r in singles]
    log(f"phase 4: build: fit {t_fit:.2f} s ({steps} steps), encode + graph "
        f"build {t_build:.2f} s (corpus encode alone {t_corpus_encode:.4f} "
        f"s, so graph build about {t_build - t_corpus_encode:.2f} s on the "
        f"host: M=32, ef_construction=100)")
    log(f"phase 4: batches of {batch}: latency ms "
        f"{[round(p[0] * 1e3, 3) for p in per_batch]}, layer-0 hops "
        f"{[int(p[1]) for p in per_batch]}, graph_beam launches "
        f"{[p[2] for p in per_batch]}, time per launch ms "
        f"{[round(p[0] * 1e3 / max(p[2], 1), 4) for p in per_batch]}")
    log(f"phase 4: one query at a time: latency median "
        f"{float(np.median(lat1)) * 1e3:.3f} ms, max {max(lat1) * 1e3:.3f} "
        f"ms, layer-0 hops median {float(np.median(hops1)):.0f}")
    log(f"phase 4: one batch's layers: encode {t_encode * 1e3:.3f} ms, "
        f"stage-1 traversal {s1.latency_s * 1e3:.3f} ms ({hop_launches} "
        f"graph_traverse launch, {s1.stats['beam_hops']:.0f} layer-0 hops "
        f"at most a row), rerank {t_rerank * 1e3:.3f} ms")
    log(f"phase 4: one {batch}-query search under torch.profiler: wall "
        f"{wall_ms:.3f} ms, card busy {busy:.4f} of it (idle share "
        f"{1.0 - busy:.4f}; 0 busy = no device event traced), "
        f"graph_traverse kernel {hop_ms:.4f} ms of device time; one query: "
        f"wall {wall1_ms:.3f} ms, idle share {1.0 - busy1:.4f}")
    # the card's time a search from a trace of 20 (tracing stretches one
    # search's wall several-fold), over the untraced median wall above
    card_b = traced_device_ms(lambda: idx.search(noisy[:batch], 10), reps=20)
    card_1 = traced_device_ms(lambda: idx.search(noisy[:1], 10), reps=20)
    wall_b = float(np.median([p[0] for p in per_batch])) * 1e3
    wall_1 = float(np.median(lat1)) * 1e3
    log(f"phase 4: the card's time a search (trace of 20): {card_b:.4f} ms "
        f"a {batch}-query batch, {card_1:.4f} ms a query; over the untraced "
        f"median wall ({wall_b:.3f} ms, {wall_1:.3f} ms): idle share "
        f"{1.0 - card_b / wall_b:.4f} a batch, {1.0 - card_1 / wall_1:.4f} "
        f"a query")
    GRAPH_TWIN.update(idx=idx, res=res, recall=recall)
    return {"launches": launches, "graph": g, "zb": zb, "k1": k1,
            "ef": ef}


#: phase 4's f32 graph stack and its 64-query answer, the twin phase 6
#: holds its quantized graphs against
GRAPH_TWIN: dict = {}


def graph_beam_time(p4: dict, g: torch.Generator) -> dict:
    """The ``graph_beam`` row: the traversal kernel (the main path's one
    launch a search) on phase 4's graph and a 256-query batch of its
    reduced queries, beside its bound (the rows its evals gather, the
    neighbour rows its hops read, the beams), and the loop of plain hops
    (its plain version) on the same batch; then, under ``hop``, the hop
    kernel alone (``hop_time``)."""
    from repro_torch.kernels.graph_beam.kernel import graph_traverse_cuda
    from repro_torch.kernels.graph_beam.ref import (graph_beam_ref,
                                                    pairwise_sum)
    from repro_torch.search import hnsw

    graph, zb, k1, ef = p4["graph"], p4["zb"], p4["k1"], p4["ef"]
    vecs, vsq, nbrs0, upper = graph.pack().device_arrays(
        graph.vecs, torch.device("cuda"))
    zb = zb.float().contiguous()
    q_sq = pairwise_sum(zb * zb)

    def traverse():
        return graph_traverse_cuda(zb, vecs, vsq, q_sq, nbrs0, upper,
                                   graph.entry, ef)

    ms, held = device_ms(traverse, reps=20)
    _, _, evals, hops = traverse()
    plain = cuda_ms(lambda: hnsw.search_batched(
        graph, zb, k1, ef_search=ef, device="cuda", hop=graph_beam_ref),
        reps=3, warmup=1)
    nq, d = zb.shape
    b_ms, b_by = bound(float(evals.sum()) * (4.0 * d + 4.0)
                       + float(hops.sum()) * 4.0 * nbrs0.shape[1]
                       + 4.0 * nq * d + 8.0 * nq * ef,
                       float(evals.sum()) * 2.0 * d)
    log(f"phase 4: graph traversal Q={nq} N={vecs.shape[0]} d={d} "
        f"W={nbrs0.shape[1]} ef={ef} (device time, card held busy while "
        f"enqueuing: {held}): kernel {ms:.4f} ms a batch (one launch; "
        f"{int(hops.max())} layer-0 hops at most a row, "
        f"{float(evals.sum()) / nq:.1f} evals a query), plain-hop loop "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "graph_beam", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/graph_beam.cu",
            "replaces": "src/repro/kernels/graph_beam/kernel.py:65",
            "launches": p4["launches"]["graph_traverse"], "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "kernel": "graph_traverse_kernel: a search, one launch",
            "hop": hop_time(p4["launches"]["graph_beam"], g)}


def hop_time(launches: int, g: torch.Generator) -> dict:
    """The hop kernel at the graph path's batch shape (Q=256, d=64, W=64 =
    2M at M=32, ef=80) over a 1M-row corpus, all slots valid: its time
    beside its bound, its plain version's and the PyTorch composite's. The
    ids rotate through 20 random sets (80 MB of rows gathered in all, more
    than the 50 MB L2), as a traversal at that size would find them."""
    from repro_torch.kernels.graph_beam.kernel import graph_beam_cuda
    from repro_torch.kernels.graph_beam.ref import (graph_beam_ref,
                                                    pairwise_sum)

    nq, n, d, w, ef = 256, 1_000_000, 64, 64, 80
    q = torch.randn(nq, d, device="cuda", generator=g)
    db = torch.randn(n, d, device="cuda", generator=g)
    db_sq, q_sq = pairwise_sum(db * db), pairwise_sum(q * q)
    id_sets = [torch.randint(0, n, (nq, w), device="cuda", generator=g,
                             dtype=torch.int32) for _ in range(20)]
    bv = torch.sort(-128.0 + 23.0 * torch.randn(nq, ef, device="cuda",
                                                 generator=g),
                    dim=1, descending=True).values
    bi = torch.randint(0, n, (nq, ef), device="cuda", generator=g,
                       dtype=torch.int32)
    turn = itertools.cycle(id_sets)

    def ids():
        return next(turn)

    def library():
        i = ids().long()
        s = (2.0 * torch.einsum("qwd,qd->qw", db[i], q) - db_sq[i]
             - q_sq[:, None])
        v, j = torch.topk(torch.cat([bv, s], dim=1), ef, dim=1)
        return v, torch.gather(torch.cat([bi, i.int()], dim=1), 1, j)

    def kernel():
        return graph_beam_cuda(q, db, db_sq, q_sq, ids(), bv, bi)

    ms, held_k = device_ms(kernel, reps=200)
    plain, held_p = device_ms(lambda: graph_beam_ref(q, db, ids(), bv, bi,
                                                     db_sq, q_sq), reps=20)
    lib, held_l = device_ms(library, reps=50)
    # back to back from the host, as the traversal launches it
    per_call = cuda_ms(kernel, reps=200)
    b_ms, b_by = bound(4.0 * nq * d + nq * w * (4.0 * d + 8.0)
                       + 4.0 * nq + 16.0 * nq * ef,
                       2.0 * nq * w * d + 3.0 * nq * w)
    log(f"phase 4: graph_beam Q={nq} N={n} d={d} W={w} ef={ef} (device "
        f"time, card held busy while enqueuing: {held_k}, {held_p}, "
        f"{held_l}): kernel {ms:.4f} ms, plain {plain:.4f} ms, gather + "
        f"einsum + torch.topk {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"one call from the host, back to back, {per_call:.4f} ms")
    return {"launches": launches, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


# ---------------------------------------------------------------------------
# Phase 5: the sharded IVF stack RAE64,Shard8,IVF256,Rerank4 at full width
# ---------------------------------------------------------------------------
def full_data(n: int, n_queries: int) -> tuple[np.ndarray, np.ndarray, float]:
    """``imdb_like`` at ``n`` rows and ``n_queries`` held-out queries (rows
    shuffled), made once for phases 5, 6 and 9; and the seconds it took.
    The draw is ``paper_dataset("imdb_like", n + n_queries, seed=0)``
    byte for byte; :data:`HOLDOUT` rows more of the same mixture, drawn
    apart (``holdout_rows``), are what phase 9 adds to a live index: rows
    of the distribution the reducer was fitted on."""
    data, _, seconds = _full_draw(n, n_queries)
    return data[:n], data[n:], seconds


#: further rows of ``full_data``'s mixture, held out of its draw
HOLDOUT = 10_000


@functools.cache
def _full_draw(n: int, n_queries: int
               ) -> tuple[np.ndarray, np.ndarray, float]:
    from repro_torch.data import paper_dataset_with_holdout

    t0 = time.perf_counter()
    data, held = paper_dataset_with_holdout("imdb_like", n + n_queries,
                                            HOLDOUT, seed=0)
    return data, held, time.perf_counter() - t0


def holdout_rows(n: int, n_queries: int) -> np.ndarray:
    """The :data:`HOLDOUT` rows drawn beside ``full_data(n, n_queries)``."""
    return _full_draw(n, n_queries)[1]


@functools.cache
def fitted_rae(n: int, n_queries: int, steps: int, device: str):
    """The RAE64 fitted once on ``full_data(n, n_queries)`` at the paper's
    schedule (``steps``, batch 128, seed 0), shared by the stacks of phases
    5 and 6 (a phase whose fit failed leaves nothing cached: the next one
    fits anew); and the seconds the fit took."""
    from repro_torch import api

    corpus = full_data(n, n_queries)[0]
    reducer = api.make_reducer("rae", 64, steps=steps, batch_size=128,
                               seed=0, device=device)
    t0 = time.perf_counter()
    reducer.fit(corpus)
    sync()
    return reducer, time.perf_counter() - t0


SHARDED_SPECS = ("RAE64,IVF256,Rerank4", "RAE64,Shard8,IVF256,Rerank4")


def drive_stack(idx, queries: np.ndarray, batch: int, n_single: int
                ) -> dict:
    """Search ``queries`` in batches of ``batch`` and the first
    ``n_single`` one at a time; the peak device memory of a batch."""
    results, lat = [], []
    for s in range(0, len(queries), batch):
        if s == 0:
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        r = idx.search(queries[s:s + batch], 10)
        if s == 0:
            peak = torch.cuda.max_memory_allocated()
        results.append(r)
        lat.append(r.latency_s)
    lat1 = [idx.search(queries[i:i + 1], 10).latency_s
            for i in range(n_single)]
    return {"ids": np.concatenate([r.indices for r in results]),
            "scores": np.concatenate([r.scores for r in results]),
            "evals": float(np.mean([r.distance_evals for r in results])),
            "lat": lat, "lat1": lat1, "batches": len(results),
            "peak_gb": peak / 1e9, "batch_gb": (peak - base) / 1e9}


def exact_contract(device: str) -> None:
    """Shard1/2/8,Flat == FlatIndex, ids and score bits, on a prime-sized
    integer corpus: every score is exact, so any difference is the
    merge's (through l2_topk in each child and topk_merge)."""
    from repro_torch import api
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda

    n, d, nq, k = 100_003, 64, 256, 40
    rng = np.random.default_rng(5)
    corpus = rng.integers(-8, 8, (n, d)).astype(np.float32)
    corpus[n // 2] = corpus[n // 3]      # planted duplicate rows: ties
    queries = rng.integers(-8, 8, (nq, d)).astype(np.float32)
    flat = api.FlatIndex(device=device).build(corpus).search(queries, k)
    ties = int((flat.scores[:, 1:] == flat.scores[:, :-1]).sum())
    for s in (1, 2, 8):
        before = topk_merge_cuda.launches
        got = api.index_factory(f"Shard{s},Flat", device=device).build(
            corpus).search(queries, k)
        same = (np.array_equal(got.indices, flat.indices)
                and np.array_equal(got.scores.view(np.int32),
                                   flat.scores.view(np.int32)))
        log(f"phase 5: Shard{s},Flat on {n}x{d} integer corpus, {nq} "
            f"queries k={k} ({ties} tied neighbours): ids and score bits "
            f"equal to FlatIndex {same}; topk_merge launches "
            f"{topk_merge_cuda.launches - before}")
        check(same, f"Shard{s},Flat differs from FlatIndex")
        check(topk_merge_cuda.launches - before == 1,
              f"Shard{s},Flat search did not merge through the kernel")


def phase_sharded(n: int, n_queries: int, batch: int, steps: int,
                  device: str) -> dict:
    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda
    from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda
    from repro_torch.kernels.topk_merge import topk_merge
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import topk_merge_ref
    from repro_torch.search.twostage import rerank_candidates

    counters = {"rae_encode": rae_encode_cuda, "l2_topk": l2_topk_scan_cuda,
                "topk_merge": topk_merge_cuda}
    corpus, queries, t_data = full_data(n, n_queries)
    reducer_kw = {"steps": steps, "batch_size": 128, "seed": 0}
    stacks = {spec: api.index_factory(spec, reducer_kw=reducer_kw,
                                      device=device)
              for spec in SHARDED_SPECS}
    twin, shard = (stacks[s] for s in SHARDED_SPECS)
    n_single = 32

    # the main path, with every launch counter from 0
    for fn in counters.values():
        fn.launches = 0
    reducer, t_fit = fitted_rae(n, n_queries, steps, device)
    for idx in stacks.values():
        idx.reducer = reducer             # one fit, shared by the stacks
    out, t_build = {}, {}
    for spec, idx in stacks.items():
        t0 = time.perf_counter()
        idx.build(corpus)
        sync()
        t_build[spec] = time.perf_counter() - t0
        before = topk_merge_cuda.launches
        out[spec] = drive_stack(idx, queries, batch, n_single)
        out[spec]["merges"] = topk_merge_cuda.launches - before
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 5: main-path launches {launches}")
    check(launches["rae_encode"] > 0 and launches["topk_merge"] > 0,
          f"a kernel of the sharded path never launched: {launches}")
    searches = out[SHARDED_SPECS[1]]["batches"] + n_single
    check(out[SHARDED_SPECS[1]]["merges"] == searches
          and out[SHARDED_SPECS[0]]["merges"] == 0,
          f"one topk_merge launch per sharded search: "
          f"{out[SHARDED_SPECS[1]]['merges']} for {searches}")

    # recall against the exact full-space scan (plain, not the main path)
    t0 = time.perf_counter()
    gt = metrics.knn_indices(torch.as_tensor(queries, device=device),
                             twin._db_full, 10)
    t_gt = time.perf_counter() - t0
    recall = {}
    for spec in SHARDED_SPECS:
        o = out[spec]
        recall[spec] = metrics.recall_at_k(torch.as_tensor(o["ids"],
                                                           device=device), gt)
        check(o["ids"].shape == (n_queries, 10) and (o["ids"] >= 0).all()
              and (o["ids"] < n).all() and np.isfinite(o["scores"]).all(),
              f"{spec}: shape, finite scores, ids in range")
        log(f"phase 5: {spec} on imdb_like {n}x768 (no cut), {steps} steps "
            f"batch 128 (shared fit); {n_queries} queries k=10: recall@10 "
            f"{recall[spec]:.4f}, distance_evals {o['evals']:.1f} a query "
            f"({o['evals'] / n:.5f} of N); search latency per {batch}-query "
            f"batch {[round(x * 1e3, 3) for x in o['lat']]} ms; one query "
            f"at a time median {float(np.median(o['lat1'])) * 1e3:.3f} ms "
            f"max {max(o['lat1']) * 1e3:.3f} ms over {n_single}; peak device "
            f"memory of a batch {o['peak_gb']:.3f} GB ({o['batch_gb']:.3f} "
            f"GB above the resident index); build {t_build[spec]:.3f} s")
    gap = abs(recall[SHARDED_SPECS[1]] - recall[SHARDED_SPECS[0]])
    log(f"phase 5: Shard8 recall - twin recall = "
        f"{recall[SHARDED_SPECS[1]] - recall[SHARDED_SPECS[0]]:+.4f} "
        f"(gate: within 0.01); exact ground truth {t_gt:.2f} s; data "
        f"{t_data:.2f} s; fit {t_fit:.2f} s")
    check(gap <= 0.01, f"Shard8 recall {recall[SHARDED_SPECS[1]]} not "
                       f"within 0.01 of the twin's {recall[SHARDED_SPECS[0]]}")

    # build time by part, and a second Shard8 build for the fingerprint
    sh = shard.base
    t0 = time.perf_counter()
    shard.reducer.transform(shard._db_full)
    sync()
    t_encode = time.perf_counter() - t0
    log(f"phase 5: Shard8 build: encode {t_encode:.4f} s, partition "
        f"{sh.build_times['partition_s']:.4f} s, child builds "
        f"{[round(x, 4) for x in sh.build_times['children_s']]} s (sum "
        f"{sum(sh.build_times['children_s']):.3f}); twin build "
        f"{t_build[SHARDED_SPECS[0]]:.3f} s (encode + one IVF256 build); "
        f"shard rows {[int(c.ntotal) for c in sh._shards]}, largest shard "
        f"{sh.bytes_per_shard / 1e6:.1f} MB")
    again = api.index_factory(SHARDED_SPECS[1], reducer_kw=reducer_kw,
                              device=device)
    again.reducer = shard.reducer
    again.build(corpus)
    fp = (shard.fingerprint(), again.fingerprint())
    log(f"phase 5: two Shard8 builds, fingerprints {fp[0]} {fp[1]}")
    check(fp[0] == fp[1], "two Shard8 builds give different fingerprints")
    del again

    # layers of one batch of the sharded stack, each timed on its own
    qb = torch.as_tensor(queries[:batch], device=device)
    k1 = shard.stage1_k(10)
    sync()
    t0 = time.perf_counter()
    zb = shard.reducer.transform(qb)
    sync()
    t_enc = time.perf_counter() - t0
    per_shard = [c.search(zb, k1).latency_s for c in sh._shards]
    t0 = time.perf_counter()
    results = sh.fan_out(zb, k1)
    t_fan = time.perf_counter() - t0
    # the same fan-out with the interpreter switching threads 50x as often:
    # how much of it is threads waiting for the GIL
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        t0 = time.perf_counter()
        sh.fan_out(zb, k1)
        t_fan_fast = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(interval)
    t0 = time.perf_counter()
    sh.candidates(results)
    t_ids = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    _, cand = sh.merge(results, k1)
    sync()
    t_merge = time.perf_counter() - t0
    cand_t = torch.as_tensor(cand, device=device)
    t0 = time.perf_counter()
    rerank_candidates(qb, shard._db_full, cand_t, 10, shard.metric)
    sync()
    t_rerank = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin_s1 = twin.base.search(twin.reducer.transform(qb), k1)
    t_twin = time.perf_counter() - t0
    wall_ms, busy, merge_ms = device_busy_share(
        lambda: shard.search(queries[:batch], 10), "topk_merge")
    log(f"phase 5: one {batch}-query Shard8 batch by layer: encode "
        f"{t_enc * 1e3:.3f} ms; each shard's probe scan alone "
        f"{[round(x * 1e3, 3) for x in per_shard]} ms (sum "
        f"{sum(per_shard) * 1e3:.3f}); fan-out on the thread pool "
        f"{t_fan * 1e3:.3f} ms ({t_fan_fast * 1e3:.3f} ms with a 0.1 ms "
        f"thread switch interval, {interval * 1e3:.1f} ms by default); "
        f"merge {t_merge * 1e3:.3f} ms (ids to global on the host "
        f"{t_ids * 1e3:.3f} ms, then host -> card, topk_merge, card -> "
        f"host); rerank "
        f"{t_rerank * 1e3:.3f} ms. Twin stage 1 (one IVF256 over 1M rows) "
        f"{t_twin * 1e3:.3f} ms")
    log(f"phase 5: one {batch}-query Shard8 search under torch.profiler: "
        f"wall {wall_ms:.3f} ms, card busy {busy:.4f} of it (idle share "
        f"{1.0 - busy:.4f}), topk_merge kernel {merge_ms:.4f} ms of device "
        f"time")
    # the merge kernel against its plain version on this batch's candidates
    vals, gids = (torch.as_tensor(a, device=device)
                  for a in sh.candidates(results))
    kv, ki = topk_merge(vals, gids, k1)
    pv, pi = topk_merge_ref(vals, gids, k1)
    check(torch.equal(ki, pi) and torch.equal(kv.view(torch.int32),
                                              pv.view(torch.int32)),
          "topk_merge kernel differs from its plain version on the "
          "sharded batch")
    check(np.array_equal(ki.cpu().numpy(), cand),
          "merge() differs from topk_merge")
    del twin_s1
    exact_contract(device)
    return {"launches": launches["topk_merge"], "vals": vals.contiguous(),
            "ids": gids.contiguous(), "k": k1}


def shard_candidates(g: torch.Generator, nq: int, k1: int, shards: int = 8
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """What ``shards`` children hand the merge for ``nq`` queries: each
    shard's k1 best as normal scores in descending order, ids unique per
    row, no pads. [nq, k1 * shards] float32 and int32, on the card."""
    c = k1 * shards
    ids = torch.argsort(torch.rand(nq, 4 * c, device="cuda", generator=g),
                        dim=1)[:, :c].to(torch.int32)
    vals = torch.randn(nq, shards, k1, device="cuda", generator=g)
    vals = vals.sort(dim=2, descending=True).values.reshape(nq, c)
    return vals.contiguous(), ids.contiguous()


#: The merge's timed shapes: the sharded search's batch (Q = 256, C = k1 x
#: 8 = 320, k = 40), a lone query of it, and KNOB_LADDER's top rung (k1 =
#: 2048 from 8 shards).
MERGE_WIDE = (256, 2048)


def merge_shapes(g: torch.Generator, main: tuple | None = None) -> dict:
    """(vals, ids, k) at the merge's timed shapes: ``main`` (a real batch's
    candidates, else ``shard_candidates`` at Q = 256, k1 = 40), its first
    row alone, and ``shard_candidates`` at ``MERGE_WIDE``."""
    vals, ids, k = main or (*shard_candidates(g, 256, 40), 40)
    wide = shard_candidates(g, *MERGE_WIDE)
    return {"main": (vals, ids, k),
            "q1": (vals[:1].contiguous(), ids[:1].contiguous(), k),
            "wide": (*wide, MERGE_WIDE[1])}


def merge_times(shapes: dict, reps: dict | None = None) -> dict:
    """The merge kernel at each shape by CUDA events, the card held busy
    while the host enqueues (``device_ms``), beside the plain version's,
    the library composite's (two stable sorts and gathers on the pinned
    pool), the bytes bound and the launch floor (``torch.cuda._sleep(0)``,
    a kernel that returns at once, timed the same way); the kernel is held
    bit for bit to its plain version at each shape first."""
    from repro_torch.kernels.topk_merge import kernel as merge_kernel
    from repro_torch.kernels.topk_merge.ref import (lexsort_desc, pin_pads,
                                                    topk_merge_ref)

    reps = reps or {"main": 500, "q1": 500, "wide": 100}
    fn = merge_kernel.topk_merge_cuda
    out = {}
    for name, (vals, ids, k) in shapes.items():
        nq, c = vals.shape
        v, i = fn(vals, ids, k)
        vr, ir = topk_merge_ref(vals, ids, k)
        check(torch.equal(i, ir) and torch.equal(v.view(torch.int32),
                                                 vr.view(torch.int32)),
              f"topk_merge at {name} differs from its plain version")
        pv, ptb = pin_pads(vals, ids, k)
        ms, held = device_ms(lambda: fn(vals, ids, k), reps=reps[name])
        plain, held_p = device_ms(lambda: topk_merge_ref(vals, ids, k),
                                  reps=20)
        lib, held_l = device_ms(lambda: lexsort_desc(pv, ptb, k), reps=20)
        out[name] = {"q": nq, "c": c, "k": k, "ms": ms, "held": held,
                     "plain_ms": plain, "plain_held": held_p,
                     "library_ms": lib, "library_held": held_l,
                     "bound_ms": bound(8.0 * nq * c + 8.0 * nq * k, 0.0)[0]}
    out["floor_ms"] = device_ms(lambda: torch.cuda._sleep(0), reps=500)[0]
    return out


def merge_select_stats(shapes: dict, rows: int = 32) -> dict:
    """Cut passes and block barriers a row of the kernel's selection at
    each shape, from its CPU model (``ref.topk_merge_select_ref`` at
    ``kernel.plan``) on the first ``rows`` rows of the same inputs, which
    it must merge bit for bit as the kernel does."""
    from repro_torch.kernels.topk_merge.kernel import plan, topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import topk_merge_select_ref

    out = {}
    for name, (vals, ids, k) in shapes.items():
        v, i = vals[:rows], ids[:rows]
        mv, mi, st = topk_merge_select_ref(v.cpu(), i.cpu(), k,
                                           plan(v.shape[1], k))
        kv, ki = topk_merge_cuda(v.contiguous(), i.contiguous(), k)
        check(torch.equal(mi, ki.cpu()) and torch.equal(
            mv.view(torch.int32), kv.cpu().view(torch.int32)),
            f"topk_merge at {name}: the CPU model differs from the kernel")
        out[name] = {"passes_mean": float(st["passes"].float().mean()),
                     "passes_max": int(st["passes"].max()),
                     "block_barriers_max": int(st["block_barriers"].max())}
    return out


def topk_merge_time(merge: dict) -> dict:
    """The merge kernel at the sharded search's shape (Q=256, C=k1*8=320,
    k=k1=40) on a real batch's candidates, a lone query of that batch, and
    the widest row (Q=256, C=16384, k=2048, ``shard_candidates``): its time
    beside its bound, the launch floor, its plain version's and the
    library composite's; the cut passes and block barriers a row from the
    kernel's CPU model. The kernels line carries the batch's numbers."""
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import (lexsort_desc, pin_pads,
                                                    topk_merge_ref)

    g = torch.Generator(device="cuda").manual_seed(7)
    shapes = merge_shapes(g, (merge["vals"], merge["ids"], merge["k"]))
    vals, ids, k = shapes["main"]
    nq, c = vals.shape
    pv, ptb = pin_pads(vals, ids, k)

    def library():
        return lexsort_desc(pv, ptb, k)

    traced = [traced_device_ms(fn, reps=20) for fn in (
        lambda: topk_merge_cuda(vals, ids, k),
        lambda: topk_merge_ref(vals, ids, k), library)]
    log(f"phase 5: topk_merge Q={nq} C={c} k={k}, the card's busy time a "
        f"call under torch.profiler (no gaps between kernels): kernel "
        f"{traced[0]:.4f} ms, plain {traced[1]:.4f} ms, two stable "
        f"torch.sort + gathers {traced[2]:.4f} ms")
    per_call = cuda_ms(lambda: topk_merge_cuda(vals, ids, k), reps=200)
    times = merge_times(shapes)
    stats = merge_select_stats(shapes)
    for name, t in times.items():
        if name == "floor_ms":
            continue
        log(f"phase 5: topk_merge {name} Q={t['q']} C={t['c']} k={t['k']} "
            f"(device time, card held busy while enqueuing: {t['held']}, "
            f"{t['plain_held']}, {t['library_held']}): kernel "
            f"{t['ms']:.4f} ms, launch floor (torch.cuda._sleep(0)) "
            f"{times['floor_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
            f"(bytes), plain {t['plain_ms']:.4f} ms, two stable torch.sort "
            f"+ gathers {t['library_ms']:.4f} ms; cut passes a row (CPU "
            f"model, first 32 rows) mean {stats[name]['passes_mean']:.2f} "
            f"max {stats[name]['passes_max']}, block barriers a row max "
            f"{stats[name]['block_barriers_max']}")
    log(f"phase 5: topk_merge main, one call from the host, back to back, "
        f"{per_call:.4f} ms")
    t = times["main"]
    # where the host leaked into an event-timed run (held False), the kernel
    # line carries the traced time, the card's own
    plain = t["plain_ms"] if t["plain_held"] else traced[1]
    lib = t["library_ms"] if t["library_held"] else traced[2]
    return {"name": "topk_merge", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_merge.cu",
            "replaces": "src/repro/kernels/topk_merge/kernel.py:71",
            "launches": merge["launches"], "ms": t["ms"], "plain_ms": plain,
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": lib}


# ---------------------------------------------------------------------------
# Phase 6: the quantized tiers (PQ at full width, SQ8 / PQ graph payloads)
# ---------------------------------------------------------------------------
QUANT_FULL_SPECS = ("RAE64,PQ8x8,Rerank4", "RAE64,IVF256,PQ8x8,Rerank4",
                    "RAE64,Flat,Rerank4")


def plain_pq_path(idx, queries: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The PQ stack with every kernel replaced by its plain version."""
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref
    from repro_torch.kernels.rae_encode.ref import rae_encode_ref
    from repro_torch.search.twostage import rerank_candidates

    zq = rae_encode_ref(queries, idx.reducer.params_["w_e"], False)
    _, cand = pq_adc_ref(zq, idx.base._pq.codebooks, idx.base._codes,
                         idx.stage1_k(k))
    return rerank_candidates(queries, idx._db_full, cand, k, idx.metric)


def phase_quantized_full(n: int, n_queries: int, batch: int, steps: int,
                         device: str) -> dict:
    """``RAE64,PQ8x8,Rerank4`` (the pq_adc kernel over 1M codes of 8 bytes)
    and ``RAE64,IVF256,PQ8x8,Rerank4`` at full width, beside their twin
    ``RAE64,Flat,Rerank4``, all three from one fitted reducer."""
    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda
    from repro_torch.kernels.pq_adc.kernel import pq_adc_cuda
    from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda
    from repro_torch.search import ivf as ivf_lib
    from repro_torch.search import quantize as qz
    from repro_torch.search.twostage import rerank_candidates

    counters = {"rae_encode": rae_encode_cuda, "l2_topk": l2_topk_scan_cuda,
                "pq_adc": pq_adc_cuda}
    corpus, queries, t_data = full_data(n, n_queries)
    reducer_kw = {"steps": steps, "batch_size": 128, "seed": 0}
    stacks = {spec: api.index_factory(spec, reducer_kw=reducer_kw,
                                      device=device)
              for spec in QUANT_FULL_SPECS}
    pq_stack, ivf_stack, twin = (stacks[s] for s in QUANT_FULL_SPECS)
    n_single = 32

    # the main path, with every launch counter from 0
    for fn in counters.values():
        fn.launches = 0
    reducer, t_fit = fitted_rae(n, n_queries, steps, device)
    out, t_build, launches = {}, {}, {}
    for spec, idx in stacks.items():
        idx.reducer = reducer             # one fit, shared by the stacks
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        idx.build(corpus)
        sync()
        t_build[spec] = time.perf_counter() - t0
        out[spec] = drive_stack(idx, queries, batch, n_single)
        launches[spec] = {k: fn.launches - before[k]
                          for k, fn in counters.items()}
    total = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 6: main-path launches {total}; by stack {launches}")
    searches = out[QUANT_FULL_SPECS[0]]["batches"] + n_single
    check(total["pq_adc"] > 0 and total["rae_encode"] > 0,
          f"a kernel of the quantized path never launched: {total}")
    check(launches[QUANT_FULL_SPECS[0]]["pq_adc"] == searches,
          f"one pq_adc launch per PQ search: "
          f"{launches[QUANT_FULL_SPECS[0]]['pq_adc']} for {searches}")

    # recall against the exact full-space scan (plain, not the main path)
    t0 = time.perf_counter()
    qt = torch.as_tensor(queries, device=device)
    gt = metrics.knn_indices(qt, twin._db_full, 10)
    t_gt = time.perf_counter() - t0
    recall = {}
    for spec in QUANT_FULL_SPECS:
        o = out[spec]
        recall[spec] = metrics.recall_at_k(torch.as_tensor(o["ids"],
                                                           device=device), gt)
        check(o["ids"].shape == (n_queries, 10) and (o["ids"] >= 0).all()
              and (o["ids"] < n).all() and np.isfinite(o["scores"]).all(),
              f"{spec}: shape, finite scores, ids in range")
    for spec in QUANT_FULL_SPECS:
        o = out[spec]
        log(f"phase 6: {spec} on imdb_like {n}x768 (no cut), {steps} steps "
            f"batch 128 (shared fit); {n_queries} queries k=10: recall@10 "
            f"{recall[spec]:.4f}, bytes_per_vector "
            f"{stacks[spec].bytes_per_vector:g}, "
            f"distance_evals {o['evals']:.1f} a query; search latency per "
            f"{batch}-query batch {[round(x * 1e3, 3) for x in o['lat']]} "
            f"ms; one query at a time median "
            f"{float(np.median(o['lat1'])) * 1e3:.3f} ms max "
            f"{max(o['lat1']) * 1e3:.3f} ms over {n_single}; peak device "
            f"memory of a batch {o['peak_gb']:.3f} GB ({o['batch_gb']:.3f} "
            f"GB above the resident index); build {t_build[spec]:.3f} s; "
            f"launches {launches[spec]}")
    twin_recall = recall[QUANT_FULL_SPECS[2]]
    log(f"phase 6: recall@10 - twin's: PQ8x8 "
        f"{recall[QUANT_FULL_SPECS[0]] - twin_recall:+.4f}, IVF256,PQ8x8 "
        f"{recall[QUANT_FULL_SPECS[1]] - twin_recall:+.4f}; exact ground "
        f"truth {t_gt:.2f} s; data {t_data:.2f} s; fit {t_fit:.2f} s")

    # build time by part: each piece run again on the reduced corpus
    sync()
    t0 = time.perf_counter()
    z = reducer.transform(pq_stack._db_full)
    sync()
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    qz.pq_encode(pq_stack.base._pq, z)
    sync()
    t_pq_encode = time.perf_counter() - t0
    ivb = ivf_stack.base
    t0 = time.perf_counter()
    coarse = ivf_lib.build(z, ivb.n_cells, kmeans_iters=ivb.kmeans_iters,
                           seed=ivb.seed)
    sync()
    t_ivf = time.perf_counter() - t0
    c, cap, d = coarse.list_vecs.shape
    t0 = time.perf_counter()
    qz.pq_encode(ivb._pq, coarse.list_vecs.reshape(c * cap, d))
    sync()
    t_list_encode = time.perf_counter() - t0
    del coarse, z
    train = (t_build[QUANT_FULL_SPECS[0]] - t_encode - t_pq_encode,
             t_build[QUANT_FULL_SPECS[1]] - t_encode - t_ivf - t_list_encode)
    log(f"phase 6: build by part: corpus encode {t_encode:.4f} s; PQ8x8: "
        f"PQ train about {train[0]:.3f} s, code encode {t_pq_encode:.4f} s; "
        f"IVF256,PQ8x8: IVF256 {t_ivf:.3f} s (nprobe {ivb.nprobe}, cap "
        f"{cap}), PQ train about {train[1]:.3f} s, list encode "
        f"({c * cap} slots) {t_list_encode:.4f} s")

    # the kernel path against the plain path, first 128 queries
    _, plain_ids = plain_pq_path(pq_stack, qt[:128], 10)
    got = torch.as_tensor(out[QUANT_FULL_SPECS[0]]["ids"][:128],
                          device=device)
    same = int((got == plain_ids).sum())
    log(f"phase 6: PQ8x8 kernel ids == plain ids on {got.shape[0]} queries: "
        f"{same}/{got.numel()}")
    check(same >= 0.99 * got.numel(), "PQ8x8 kernel path ids differ from "
                                      "the plain path's")

    # layers of one batch of the PQ stack, each timed on its own
    qb = qt[:batch]
    k1 = pq_stack.stage1_k(10)
    sync()
    t0 = time.perf_counter()
    zq = reducer.transform(qb)
    sync()
    t_enc = time.perf_counter() - t0
    layer = {}
    for spec in QUANT_FULL_SPECS[:2]:
        s1 = stacks[spec].base.search(zq, stacks[spec].stage1_k(10))
        cand = torch.as_tensor(s1.indices, device=device)
        sync()
        t0 = time.perf_counter()
        rerank_candidates(qb, stacks[spec]._db_full, cand, 10, "euclidean")
        sync()
        layer[spec] = (s1.latency_s, time.perf_counter() - t0)
    log(f"phase 6: one {batch}-query batch by layer: encode "
        f"{t_enc * 1e3:.3f} ms; PQ8x8 stage 1 (pq_adc, k1 = {k1}) "
        f"{layer[QUANT_FULL_SPECS[0]][0] * 1e3:.3f} ms, rerank "
        f"{layer[QUANT_FULL_SPECS[0]][1] * 1e3:.3f} ms; IVF256,PQ8x8 stage 1 "
        f"(probe) {layer[QUANT_FULL_SPECS[1]][0] * 1e3:.3f} ms, rerank "
        f"{layer[QUANT_FULL_SPECS[1]][1] * 1e3:.3f} ms")
    wall_ms, busy, adc_ms = device_busy_share(
        lambda: pq_stack.search(queries[:batch], 10), "pq_scan")
    log(f"phase 6: one {batch}-query PQ8x8 search under torch.profiler: "
        f"wall {wall_ms:.3f} ms, card busy {busy:.4f} of it (idle share "
        f"{1.0 - busy:.4f}), pq_adc's scan kernel {adc_ms:.4f} ms of device "
        f"time")
    return {"launches": total["pq_adc"], "q": zq.contiguous(),
            "cb": pq_stack.base._pq.codebooks, "codes": pq_stack.base._codes,
            "k": k1}


def pq_library(q: torch.Tensor, cb: torch.Tensor, codes: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The PyTorch composite of the ADC top-k (the yardstick, never the
    port's path): LUT by einsum, then chunked gather + sum + torch.topk
    and a merge."""
    nq = q.shape[0]
    n, m = codes.shape
    ksub, dsub = cb.shape[1], cb.shape[2]
    offs = (codes.long() + torch.arange(m, device=codes.device) * ksub)
    rows = 1 << 16
    qs = q.reshape(nq, m, dsub)
    lut = ((qs * qs).sum(-1)[:, :, None]
           - 2 * torch.einsum("qms,mjs->qmj", qs, cb)
           + (cb * cb).sum(-1)[None]).reshape(nq, m * ksub)
    vals, ids = [], []
    for s in range(0, n, rows):
        o = offs[s:s + rows]
        dist = lut[:, o.reshape(-1)].reshape(nq, o.shape[0], m).sum(-1)
        v, i = torch.topk(-dist, min(k, o.shape[0]), dim=1)
        vals.append(v)
        ids.append(i + s)
    v, j = torch.topk(torch.cat(vals, 1), k, dim=1)
    return v, torch.gather(torch.cat(ids, 1), 1, j)


def pq_bound(q: torch.Tensor, cb: torch.Tensor, codes: torch.Tensor,
             k: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, shared-memory lookup ceiling ms) of the
    ADC top-k: the queries, codebooks and codes read once and k pairs a
    query written, against the LUT's FLOPs and one add a lookup; the
    ceiling reads Q*N*m LUT entries from shared memory at 32 a clock on
    each SM, at the card's SM clock."""
    nq = q.shape[0]
    n, m = codes.shape
    ksub, dsub = cb.shape[1], cb.shape[2]
    b_ms, b_by = bound(4.0 * nq * m * dsub + 4.0 * m * ksub * dsub
                       + 1.0 * n * m + 8.0 * nq * k,
                       6.0 * nq * m * ksub * dsub + 1.0 * nq * n * m)
    props = torch.cuda.get_device_properties(0)
    ghz = getattr(props, "clock_rate", 1_755_000) / 1e6
    ceiling = nq * n * m / (32.0 * props.multi_processor_count * ghz * 1e9)
    return b_ms, b_by, ceiling * 1e3


def pq_adc_time(full: dict) -> dict:
    """The ADC scan kernel at the main path's shape (Q=256, N=1,000,003,
    m=8, ksub=256, k=320) on a real batch and the real codes: its time
    beside its bound and shared-memory lookup ceiling, its plain version's
    and the library composite's (``pq_library``); and at k = 2048, the top
    rung of ``rerank_k1``, beside its bound."""
    from repro_torch.kernels.pq_adc.kernel import pq_adc_cuda
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref

    q, cb, codes, k = full["q"], full["cb"], full["codes"], full["k"]
    nq = q.shape[0]
    n, m = codes.shape
    ksub = cb.shape[1]
    kv, ki = pq_adc_cuda(q, cb, codes, k)
    pv, pi = pq_adc_ref(q, cb, codes, k)
    check(torch.equal(ki, pi) and torch.equal(kv.view(torch.int32),
                                              pv.view(torch.int32)),
          "pq_adc kernel differs from its plain version on the main batch")
    ms, held_k = device_ms(lambda: pq_adc_cuda(q, cb, codes, k), reps=50)
    plain, held_p = device_ms(lambda: pq_adc_ref(q, cb, codes, k), reps=3)
    lib, held_l = device_ms(lambda: pq_library(q, cb, codes, k), reps=5)
    per_call = cuda_ms(lambda: pq_adc_cuda(q, cb, codes, k), reps=20)
    b_ms, b_by, ceiling = pq_bound(q, cb, codes, k)
    top = 2048  # the top rung of rerank_k1 (KNOB_LADDER)
    top_ms = cuda_ms(lambda: pq_adc_cuda(q, cb, codes, top), reps=10)
    top_b, top_by, _ = pq_bound(q, cb, codes, top)
    log(f"phase 6: pq_adc Q={nq} N={n} m={m} ksub={ksub} k={k} (device "
        f"time, card held busy while enqueuing: {held_k}, {held_p}, "
        f"{held_l}): kernel {ms:.4f} ms, plain {plain:.4f} ms, einsum LUT + "
        f"chunked gather + sum + torch.topk {lib:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}), shared-memory lookup ceiling {ceiling:.4f} ms; one "
        f"call from the host, back to back, {per_call:.4f} ms")
    log(f"phase 6: pq_adc Q={nq} N={n} k={top}: kernel {top_ms:.4f} ms, "
        f"bound {top_b:.4f} ms ({top_by})")
    return {"name": "pq_adc", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pq_adc.cu",
            "replaces": "src/repro/kernels/pq_adc/kernel.py:71",
            "launches": full["launches"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "lookup_ceiling_ms": ceiling,
            "k2048": {"ms": top_ms, "bound_ms": top_b, "bound_by": top_by}}


GRAPH_QUANT_SPECS = ("RAE64,HNSW32,SQ8,Rerank4", "RAE64,HNSW32,PQ8x8,Rerank4")
#: the graph gates of scripts/check_bench.py: gather bytes per hop at least
#: this many times below the f32 twin's, post-rerank recall within 0.01
GATHER_FLOORS = {"SQ8": 3.0, "PQ8x8": 4.0}


def phase_quantized_graph(device: str, steps: int = 1000, batch: int = 256,
                          n_single: int = 128) -> dict:
    """Both quantized graph stacks on the 20k x 256 corpus with phase 4's
    reducer, held against phase 4's f32 twin: a search is one launch of the
    quantized traversal (no hop kernel, no float32 kernel), equal to the
    loop of plain quantized hops. Returns the main path's traversal
    launches and, per stack, what the traversal's timing needs (the graph,
    a reduced batch, k1, ef)."""
    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.kernels.graph_beam.kernel import (graph_beam_cuda,
                                                       graph_traverse_cuda)
    from repro_torch.kernels.graph_beam_q.kernel import (
        graph_beam_q_cuda, graph_traverse_q_cuda)
    from repro_torch.kernels.graph_beam_q.ref import graph_beam_q_ref
    from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda
    from repro_torch.search import hnsw

    corpus, queries = acceptance_data()
    noisy = noisy_queries(corpus, 1024, seed=2)
    n = corpus.shape[0]
    gt = metrics.knn_indices(torch.as_tensor(queries, device=device),
                             torch.as_tensor(corpus, device=device), 10)
    if "idx" not in GRAPH_TWIN:            # phase 4 failed: its own twin
        twin = api.index_factory("RAE64,HNSW32,Rerank4",
                                 reducer_kw={"steps": steps, "seed": 0},
                                 device=device).build(corpus)
        res = twin.search(queries, 10)
        GRAPH_TWIN.update(idx=twin, res=res, recall=metrics.recall_at_k(
            torch.as_tensor(res.indices, device=device), gt))
    twin, twin_res = GRAPH_TWIN["idx"], GRAPH_TWIN["res"]
    twin_recall = GRAPH_TWIN["recall"]
    twin_bytes = twin_res.stats["gather_bytes_per_hop"]
    counters = {"rae_encode": rae_encode_cuda, "graph_beam": graph_beam_cuda,
                "graph_traverse": graph_traverse_cuda,
                "graph_beam_q": graph_beam_q_cuda,
                "graph_traverse_q": graph_traverse_q_cuda}
    stacks, t_build, runs = {}, {}, {}

    # the main path, with every launch counter from 0
    for fn in counters.values():
        fn.launches = 0
    for spec in GRAPH_QUANT_SPECS:
        idx = api.index_factory(spec, reducer_kw={"steps": steps, "seed": 0},
                                device=device)
        idx.reducer = twin.reducer         # phase 4's fit: the same graph
        t0 = time.perf_counter()
        idx.build(corpus)
        sync()
        t_build[spec] = time.perf_counter() - t0
        res = idx.search(queries, 10)
        batches, per_batch = [], []
        for s in range(0, len(noisy), batch):
            before = graph_traverse_q_cuda.launches
            r = idx.search(noisy[s:s + batch], 10)
            batches.append(r)
            per_batch.append((r.latency_s, r.stats["beam_hops"],
                              graph_traverse_q_cuda.launches - before))
        singles = [idx.search(noisy[i:i + 1], 10) for i in range(n_single)]
        stacks[spec] = idx
        runs[spec] = (res, batches, per_batch, singles)
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 6: graph main-path launches {launches}")
    check(launches["graph_traverse_q"] > 0 and launches["rae_encode"] > 0,
          f"a kernel of the quantized graph path never launched: {launches}")
    searches = len(GRAPH_QUANT_SPECS) * (1 + -(-len(noisy) // batch)
                                         + n_single)
    check(launches["graph_traverse_q"] == searches
          and all(p[2] == 1 for r in runs.values() for p in r[2])
          and launches["graph_beam_q"] == launches["graph_beam"] == 0
          and launches["graph_traverse"] == 0,
          f"a quantized graph search is not one quantized traversal launch "
          f"(with no hop and no float32 kernel): {launches}")
    timing = {}

    failed = []
    for spec in GRAPH_QUANT_SPECS:
        idx = stacks[spec]
        res, batches, per_batch, singles = runs[spec]
        codec = spec.split(",")[2]
        recall = metrics.recall_at_k(torch.as_tensor(res.indices,
                                                     device=device), gt)
        ratio = twin_bytes / res.stats["gather_bytes_per_hop"]
        with tempfile.TemporaryDirectory() as tmp:
            idx.save(tmp)
            res2 = api.load_index(tmp, device=device).search(queries, 10)
        reload_same = bool(np.array_equal(res2.indices, res.indices)
                           and np.array_equal(res2.scores, res.scores))
        ids = np.concatenate([r.indices for r in batches])
        single_ids = np.concatenate([r.indices for r in singles])
        same_single = int((single_ids == ids[:n_single]).all(axis=1).sum())
        log(f"phase 6: {spec} on {n}x256, phase 4's reducer, 64 queries: "
            f"recall@10 {recall:.4f} (f32 twin {twin_recall:.4f}, "
            f"{recall - twin_recall:+.4f}; gate -0.01), gather bytes per "
            f"hop {res.stats['gather_bytes_per_hop']:.1f} (twin "
            f"{twin_bytes:.1f}: {ratio:.2f}x fewer; gate "
            f"{GATHER_FLOORS[codec]}x), bytes_per_vector "
            f"{idx.bytes_per_vector:.1f} (twin {twin.bytes_per_vector:.1f}), "
            f"distance_evals {res.distance_evals:.1f}, beam hops "
            f"{res.stats['beam_hops']:.0f}; build {t_build[spec]:.2f} s "
            f"(encode, host graph build, codec on the card); reload "
            f"identical {reload_same}")
        log(f"phase 6: {spec}: batches of {batch}: latency ms "
            f"{[round(p[0] * 1e3, 3) for p in per_batch]}, layer-0 hops "
            f"{[int(p[1]) for p in per_batch]}, graph_traverse_q launches "
            f"{[p[2] for p in per_batch]}; one query at a time: latency "
            f"median {np.median([r.latency_s for r in singles]) * 1e3:.3f} ms"
            f" (max {max(r.latency_s for r in singles) * 1e3:.3f}) over "
            f"{n_single}, == its batch row (ids) for "
            f"{same_single}/{n_single}")
        if recall < twin_recall - 0.01:
            failed.append(f"{spec}: recall {recall} more than 0.01 below "
                          f"the f32 twin's {twin_recall}")
        if ratio < GATHER_FLOORS[codec]:
            failed.append(f"{spec}: gather bytes only {ratio:.2f}x below "
                          f"the twin's")
        if not reload_same:
            failed.append(f"{spec}: load_index answers differ")
        if same_single < 0.99 * n_single or not all(
                np.isfinite(r.scores).all() for r in batches) \
                or ids.shape != (len(noisy), 10) or (ids < 0).any():
            failed.append(f"{spec}: answers alone differ from the batch's, "
                          f"or are not finite, in range and full")

        # the one-launch traversal against the plain-hop loop, same graph
        g = idx.base._g
        zq = idx.reducer.transform(torch.as_tensor(noisy, device=device))
        k1 = idx.stage1_k(10)
        ef = max(idx.base.ef_search, k1)
        kern = hnsw.search_batched(g, zq, k1, ef_search=ef, device=device)
        plain = hnsw.search_batched(g, zq, k1, ef_search=ef, device=device,
                                    hop=graph_beam_q_ref)
        agree = int((kern[1] == plain[1]).all(dim=1).sum())
        same = (all(torch.equal(a, b) for a, b in zip(kern[:3], plain[:3]))
                and kern[3] == plain[3])
        log(f"phase 6: {spec}: one-launch traversal == plain-hop loop "
            f"(ids) for {agree}/{len(noisy)} queries; scores bit-equal "
            f"{bool(torch.equal(kern[0], plain[0]))}; evals equal "
            f"{bool(torch.equal(kern[2], plain[2]))}; hops {kern[3]} / "
            f"{plain[3]}")
        if not same:
            failed.append(f"{spec}: the traversal kernel's ids, scores, "
                          f"evals or hops differ from the plain-hop loop's")
        wall_ms, busy, trav_ms = device_busy_share(
            lambda: idx.search(noisy[:batch], 10), "graph_traverse")
        wall1_ms, busy1, _ = device_busy_share(
            lambda: idx.search(noisy[:1], 10), "graph_traverse")
        log(f"phase 6: {spec}: one {batch}-query search under "
            f"torch.profiler: wall {wall_ms:.3f} ms, card busy {busy:.4f} of "
            f"it (idle share {1.0 - busy:.4f}), graph_traverse_q kernel "
            f"{trav_ms:.4f} ms of device time; one query: wall "
            f"{wall1_ms:.3f} ms, idle share {1.0 - busy1:.4f}")
        # the card's time a search from a trace of 20, over the untraced
        # median wall (tracing stretches one search's wall several-fold)
        card_b = traced_device_ms(lambda: idx.search(noisy[:batch], 10),
                                  reps=20)
        card_1 = traced_device_ms(lambda: idx.search(noisy[:1], 10), reps=20)
        wall_b = float(np.median([p[0] for p in per_batch])) * 1e3
        wall_1 = float(np.median([r.latency_s for r in singles])) * 1e3
        log(f"phase 6: {spec}: the card's time a search (trace of 20): "
            f"{card_b:.4f} ms a {batch}-query batch, {card_1:.4f} ms a query;"
            f" over the untraced median wall ({wall_b:.3f} ms, {wall_1:.3f} "
            f"ms): idle share {1.0 - card_b / wall_b:.4f} a batch, "
            f"{1.0 - card_1 / wall_1:.4f} a query")
        timing[codec] = {"graph": g, "zb": zq[:batch].contiguous(),
                         "k1": k1, "ef": ef}
    check(not failed, "; ".join(failed))
    return {"launches": launches["graph_traverse_q"], "timing": timing}


def graph_beam_q_time(p6: dict, g: torch.Generator) -> dict:
    """The ``graph_beam_q`` row: the quantized traversal kernel (the main
    path's one launch a search) on phase 6's SQ8 graph (the kernels line)
    and PQ8x8 graph with a 256-query batch of their reduced queries, beside
    its bound (the code rows and biases its evals gather, the neighbour
    rows its hops read, the operands and beams) and the loop of plain
    quantized hops (its plain version) on the same batch; then, under
    ``hop``, the hop kernel alone over 1M code rows (``hop_q_time``)."""
    from repro_torch.kernels.graph_beam_q.kernel import graph_traverse_q_cuda
    from repro_torch.kernels.graph_beam_q.ref import graph_beam_q_ref
    from repro_torch.kernels.graph_beam.ref import pairwise_sum
    from repro_torch.search import hnsw

    entry = None
    dev = torch.device("cuda")
    for codec, t in p6["timing"].items():
        graph, zb, k1, ef = t["graph"], t["zb"].float(), t["k1"], t["ef"]
        cdx = graph.codec
        _, _, nbrs0, upper = graph.pack().device_arrays(graph.vecs, dev)
        codes, node_bias = cdx.device_arrays(dev)[:2]
        q_op, q_bias = cdx.query_operands(zb, pairwise_sum(zb * zb))
        q_op, q_bias = q_op.contiguous(), q_bias.contiguous()

        def traverse():
            return graph_traverse_q_cuda(q_op, q_bias, codes, node_bias,
                                         nbrs0, upper, graph.entry, ef,
                                         cdx.kind, cdx.ksub)

        ms, held = device_ms(traverse, reps=20)
        _, _, evals, hops = traverse()
        plain = cuda_ms(lambda: hnsw.search_batched(
            graph, zb, k1, ef_search=ef, device="cuda",
            hop=graph_beam_q_ref), reps=3, warmup=1)
        nq, c = zb.shape[0], codes.shape[1]
        b_ms, b_by = bound(float(evals.sum()) * (c + 8.0)
                           + float(hops.sum()) * 4.0 * nbrs0.shape[1]
                           + 4.0 * nq * (q_op.shape[1] + 1) + 8.0 * nq * ef,
                           float(evals.sum())
                           * (2.0 * c if cdx.kind == "sq8" else c))
        log(f"phase 6: quantized graph traversal {codec} Q={nq} "
            f"N={codes.shape[0]} C={c} W={nbrs0.shape[1]} ef={ef} (device "
            f"time, card held busy while enqueuing: {held}): kernel "
            f"{ms:.4f} ms a batch (one launch; {int(hops.max())} layer-0 hops"
            f" at most a row, {float(evals.sum()) / nq:.1f} evals a query), "
            f"plain-hop loop {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if entry is None:                  # SQ8 is the kernels line
            entry = {"name": "graph_beam_q", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/graph_beam_q.cu",
                     "replaces": "src/repro/kernels/graph_beam_q/kernel.py:78",
                     "launches": p6["launches"], "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "kernel": f"graph_traverse_kernel with the {codec} "
                               f"payload: a search, one launch"}
        else:
            entry[codec] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                            "bound_by": b_by}
    entry["hop"] = hop_q_time(g)
    return entry


def hop_q_time(g: torch.Generator) -> dict:
    """The quantized hop at the graph path's batch shape (Q=256, W=64 =
    2M at M=32, ef=80) over 1M synthetic code rows, all slots valid, for
    SQ8 at d=64 (the figure returned) and PQ8x8: time beside the bound, the
    plain version's and the PyTorch composite's (gather, einsum or LUT
    gather + sum, torch.topk). The ids rotate through 20 random sets."""
    from repro_torch.kernels.graph_beam_q.kernel import graph_beam_q_cuda
    from repro_torch.kernels.graph_beam_q.ref import graph_beam_q_ref

    nq, n, w, ef = 256, 1_000_000, 64, 80
    id_sets = [torch.randint(0, n, (nq, w), device="cuda", generator=g,
                             dtype=torch.int32) for _ in range(20)]
    bv = torch.sort(-128.0 + 23.0 * torch.randn(nq, ef, device="cuda",
                                                 generator=g),
                    dim=1, descending=True).values
    bi = torch.randint(0, n, (nq, ef), device="cuda", generator=g,
                       dtype=torch.int32)
    nb = torch.rand(n, device="cuda", generator=g) * 100.0
    q_bias = torch.randn(nq, device="cuda", generator=g)
    entry = None
    for mode, c, ksub in (("sq8", 64, 0), ("pq", 8, 256)):
        codes = torch.randint(0, 256, (n, c), device="cuda", generator=g,
                              dtype=torch.uint8)
        dop = c if mode == "sq8" else c * ksub
        q_op = torch.randn(nq, dop, device="cuda", generator=g)
        turn = itertools.cycle(id_sets)
        offs = torch.arange(c, device="cuda") * ksub

        def library():
            i = next(turn).long()
            if mode == "sq8":
                s = torch.einsum("qwc,qc->qw", codes[i].float(), q_op)
            else:
                o = (codes[i].long() + offs).reshape(nq, -1)
                s = torch.gather(q_op, 1, o).reshape(nq, w, c).sum(-1)
            s = s + q_bias[:, None] - nb[i]
            v, j = torch.topk(torch.cat([bv, s], dim=1), ef, dim=1)
            return v, torch.gather(torch.cat([bi, i.int()], dim=1), 1, j)

        def kernel():
            return graph_beam_q_cuda(q_op, q_bias, codes, nb, next(turn), bv,
                                     bi, mode, ksub)

        def plain():
            return graph_beam_q_ref(q_op, q_bias, codes, nb, next(turn), bv,
                                    bi, mode=mode, ksub=ksub)

        ms, held_k = device_ms(kernel, reps=200)
        plain_ms, held_p = device_ms(plain, reps=20)
        lib, held_l = device_ms(library, reps=50)
        per_call = cuda_ms(kernel, reps=200)
        b_ms, b_by = bound(4.0 * nq * dop + 4.0 * nq + nq * w * (c + 8.0)
                           + 16.0 * nq * ef,
                           (2.0 if mode == "sq8" else 1.0) * nq * w * c
                           + 3.0 * nq * w)
        log(f"phase 6: graph_beam_q {mode} C={c} Q={nq} N={n} W={w} ef={ef} "
            f"(device time, card held busy while enqueuing: {held_k}, "
            f"{held_p}, {held_l}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, gather + {'einsum' if mode == 'sq8' else 'LUT gather + sum'}"
            f" + torch.topk {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); one "
            f"call from the host, back to back, {per_call:.4f} ms")
        if entry is None:                  # SQ8 d=64
            entry = {"launches": 0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return entry


# ---------------------------------------------------------------------------
# Phases 7 and 8: the model serving paths that feed the index
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_kernels():
    """The model paths with ``embedding_bag``, its backward and
    ``flash_decode`` replaced by their plain versions (the comparison runs,
    never the main path)."""
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag.ref import (embedding_bag_bwd_ref,
                                                       embedding_bag_ref)
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.models.transformer import attention

    saved = (bag_ops.embedding_bag, bag_ops.embedding_bag_bwd,
             attention.flash_decode)
    bag_ops.embedding_bag = embedding_bag_ref
    bag_ops.embedding_bag_bwd = embedding_bag_bwd_ref
    attention.flash_decode = flash_decode_ref
    try:
        yield
    finally:
        (bag_ops.embedding_bag, bag_ops.embedding_bag_bwd,
         attention.flash_decode) = saved


@contextlib.contextmanager
def recorded_decode_inputs():
    """Keeps the arguments of every ``flash_decode`` call the decode path
    makes (whichever version it calls), to hold the kernel against its
    plain version on each layer's own inputs."""
    from repro_torch.models.transformer import attention

    seen, saved = [], attention.flash_decode

    def record(q, k, v, cur_len):
        seen.append((q, k, v, cur_len))
        return saved(q, k, v, cur_len)

    attention.flash_decode = record
    try:
        yield seen
    finally:
        attention.flash_decode = saved


def no_host_sync(fn):
    """``fn()`` under PyTorch's CUDA sync debug mode "error": any call in
    it that makes the host wait for the card (a blocking copy, ``.item()``,
    a stream synchronize) raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def spread(lat: list[float]) -> str:
    ms = np.asarray(lat) * 1e3
    return (f"median {float(np.median(ms)):.3f} ms, min {ms.min():.3f}, max "
            f"{ms.max():.3f} over {len(ms)}")


TWO_TOWER = "two-tower-retrieval"
TWO_TOWER_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")


def phase_two_tower(device: str, reps: int = 10) -> dict:
    """two-tower-retrieval at its published widths (no cut): the tables in
    float32 padded to 512 rows (25.6 GB), MLP 1024-512-256 in bfloat16, the
    reference's serve_p99 (B=512), serve_bulk (B=262,144, history bags of
    50 ids, lengths uniform in 1..50) and retrieval_cand (one user against
    1,000,000 candidates, top-100) cells, each through ``build_cell``'s
    step function ``reps`` times with the ``embedding_bag`` counter from 0;
    the kernel path against the plain path; latency, peak memory above the
    weights and the card's idle share."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.models.recsys import two_tower as tt
    from repro_torch.models.registry import build_cell

    free_card()
    cells = {name: build_cell(TWO_TOWER, name, device)
             for name in TWO_TOWER_CELLS}
    cfg = cells["serve_p99"].cfg
    t0 = time.perf_counter()
    params = cells["serve_p99"].init(0)
    sync()
    t_init = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"phase 7: {TWO_TOWER}: tables "
        + ", ".join(f"{t.name} {params['table_' + t.name].shape[0]}x{t.dim}"
                    for t in cfg.tables)
        + f" float32, MLP {cfg.mlp_dims} in {cfg.compute_dtype}: "
          f"{nbytes / 1e9:.3f} GB of weights drawn on the card in "
          f"{t_init:.2f} s (no cut)")
    base_mem = torch.cuda.memory_allocated()
    out = {"params": params, "launches": 0}
    for name, cell in cells.items():
        (batch,) = cell.make_inputs(0)
        b = cell.cell.global_batch
        torch.cuda.reset_peak_memory_stats()
        # the main path, with the kernel's counter from 0
        embedding_bag_cuda.launches = 0
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = cell.fn(params, batch)
            sync()
            lat.append(time.perf_counter() - t0)
        launches = embedding_bag_cuda.launches
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        out["launches"] += launches
        check(launches == reps, f"{name}: embedding_bag launched {launches} "
                                f"times in {reps} steps")
        with plain_kernels():
            plain = cell.fn(params, batch)
        u = tt.user_tower(params, batch, cfg)
        with plain_kernels():
            u_plain = tt.user_tower(params, batch, cfg)
        u_err = float((u - u_plain).abs().max())
        norm_err = float((torch.linalg.vector_norm(u, dim=-1) - 1).abs().max())
        if cell.cell.kind == "serve":
            check(res.shape == (b,) and bool(torch.isfinite(res).all())
                  and float(res.abs().max()) <= 1.0 + 1e-5,
                  f"{name}: scores of shape [{b}], finite, in [-1, 1]")
            same = bool(torch.equal(res, plain))
            what = f"scores [{b}]"
        else:
            vals, ids = res
            n_cand = cell.cell.n_candidates
            scores = tt.retrieval_scores(params, batch, cfg)
            top = torch.topk(scores, 100).values
            check(vals.shape == (100,) and ids.dtype == torch.int32
                  and bool((ids >= 0).all()) and bool((ids < n_cand).all())
                  and bool((vals[:-1] >= vals[1:]).all())
                  and torch.equal(vals, top)
                  and torch.equal(scores[ids.long()], vals),
                  f"{name}: top-100 of {n_cand} candidates: ids in range, "
                  f"values sorted, equal to torch.topk's")
            same = bool(torch.equal(ids, plain[1])
                        and torch.equal(vals, plain[0]))
            what = "top-100 ids and values"
        check(norm_err < 1e-5, f"{name}: user tower rows not unit")
        log(f"phase 7: {name} B={b}"
            + (f" x {cell.cell.n_candidates} candidates"
               if cell.cell.kind == "retrieval" else "")
            + f": latency {spread(lat)} (first call included); "
              f"embedding_bag launches {launches}; kernel path == plain path: "
              f"{what} {same}, user tower max |diff| {u_err:.3e}; peak "
              f"memory above the weights {peak:.3f} GB")
        check(same and u_err == 0.0, f"{name}: the kernel path differs from "
                                     f"the plain path")
        no_host_sync(lambda: cell.fn(params, batch))
        dev, held = device_ms(lambda: cell.fn(params, batch), reps=5)
        med = float(np.median(lat[1:])) * 1e3
        wall, busy, kern = device_busy_share(lambda: cell.fn(params, batch),
                                             "embedding_bag")
        log(f"phase 7: {name}: a step makes no host sync (sync debug mode "
            f"\"error\"); the card's time a step {dev:.3f} ms (CUDA events, "
            f"card held busy while enqueuing: {held}) of a {med:.3f} ms "
            f"step: idle {1 - dev / med:.3f}; one step under torch.profiler:"
            f" wall {wall:.3f} ms, card busy {busy:.3f} (idle "
            f"{1 - busy:.3f}), embedding_bag {kern:.3f} ms of it")
        if name == "serve_bulk":
            out["bulk_batch"] = batch
    return out


def embedding_bag_time(tt_out: dict) -> dict:
    """The bag kernel at serve_bulk's shape (B=262,144 bags of L=50 ids,
    lengths uniform in 1..50, the hist_item table of 10,000,384 x 256
    float32): its time beside its bound (the rows this batch's lengths
    read), its plain version's and ``F.embedding_bag``'s over the same live
    ids with offsets."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    table = tt_out["params"]["table_hist_item"]
    batch = tt_out["bulk_batch"]
    ids, lens = batch["hist"], batch["hist_len"]
    b, l = ids.shape
    v, d = table.shape
    live = torch.arange(l, device=ids.device)[None, :] < lens[:, None]
    flat = ids.clamp(0, v - 1)[live].long()
    offsets = (torch.cumsum(lens.long(), 0) - lens.long())

    def library():
        return F.embedding_bag(flat, table, offsets, mode="mean")

    got = embedding_bag_cuda(table, ids, lens, "mean")
    lib_err, lib_rel = max_rel_err(library(), got)
    check(lib_rel <= 1e-5, f"F.embedding_bag computes another function "
                           f"(err {lib_err})")
    ms, held_k = device_ms(lambda: embedding_bag_cuda(table, ids, lens,
                                                      "mean"), reps=20)
    plain, held_p = device_ms(lambda: embedding_bag_ref(table, ids, lens,
                                                        "mean"), reps=3)
    lib, held_l = device_ms(library, reps=20)
    rows = int(lens.clamp(0, l).sum())
    b_ms, b_by = bound(4.0 * rows * d + 4.0 * rows + 4.0 * b + 4.0 * b * d,
                       float(rows * d + b * d))
    log(f"phase 7: embedding_bag B={b} L={l} d={d} over {v} rows, {rows} "
        f"live slots (device time, card held busy while enqueuing: "
        f"{held_k}, {held_p}, {held_l}): kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, F.embedding_bag {lib:.4f} ms (|diff| {lib_err:.2e}"
        f"), bound {b_ms:.4f} ms ({b_by}; {rows} rows of {4 * d} bytes)")
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:44",
            "launches": tt_out["launches"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


LLAMA = "llama3.2-1b"
DECODE_STEPS = 8
#: the reference's decode-vs-forward bar (tests/test_transformer.py:60)
DECODE_REL = 0.06
#: kernel path vs plain path: decode logits, relative to the largest. The
#: two attention outputs differ by float32 rounding (each layer's is held
#: to FLASH_REL); cast to bfloat16 a few of them round the other way, and 16
#: layers and the head carry that to 1.01e-2 of the largest logit (PR 16's
#: chip runs 2 and 3, on the H100)
KERNEL_PATH_REL = 2e-2


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def phase_llama(device: str) -> dict:
    """llama3.2-1b at its published widths in bfloat16 (serving weights):
    the prefill cell cut from 32 x 32,768 to 8 x 2048 tokens (plain
    PyTorch attention) with its cache padded to 2048 + 8 positions and 8
    decode steps from it, the decode logits held to the prefill forward's
    over the same tokens and to the plain path's; decode_32k cut from B=128
    (137 GB of cache) to B=32 and long_500k (B=1, 524,288 positions, no
    cut), each from a seeded cache at S - 16, 8 greedy steps, the
    ``flash_decode`` counter from 0 (16 launches a step), step time, tokens
    per second and the idle share of one step."""
    from repro_torch.configs import get_shapes
    from repro_torch.data import token_batch
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode.kernel import flash_decode_cuda
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.models.registry import build_cell
    from repro_torch.models.transformer import model as tm

    free_card()
    shapes = {c.name: c for c in get_shapes(LLAMA)}
    b, s = 8, 2048
    pre = build_cell(LLAMA, shapes["prefill_32k"].replace(
        seq_len=s, global_batch=b), device)
    cfg = pre.cfg
    t0 = time.perf_counter()
    params = pre.init(0)
    sync()
    t_init = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in
                 list(params["layers"].values())
                 + [params["embed"], params["final_ln"]])
    log(f"phase 8: {LLAMA}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, dh {cfg.d_head}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} (tied): {nbytes / 1e9:.3f} GB of "
        f"{cfg.param_dtype} weights drawn on the card in {t_init:.2f} s")
    out: dict = {"launches": 0}
    toks = torch.as_tensor(token_batch(b, s + DECODE_STEPS, cfg.vocab_size,
                                       seed=0)["tokens"], device=device)
    flash_decode_cuda.launches = 0
    lat = []
    for _ in range(4):
        t0 = time.perf_counter()
        logits, embed, state = pre.fn(params, toks[:, :s],
                                      max_len=s + DECODE_STEPS)
        sync()
        lat.append(time.perf_counter() - t0)
    check(logits.shape == (b, tm.padded_vocab(cfg))
          and bool(torch.isfinite(logits).all())
          and float((torch.linalg.vector_norm(embed, dim=-1) - 1).abs().max())
          < 1e-5, "prefill: logits finite, embeddings unit rows")
    pre_ms = float(np.median(lat[1:])) * 1e3
    start = tm.DecodeState(k=state.k.clone(), v=state.v.clone(),
                           length=state.length.clone())
    step_lat, dec_logits = [], []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        lg, _, state = tm.decode_step(params, state, toks[:, s + i], cfg)
        sync()
        step_lat.append(time.perf_counter() - t0)
        dec_logits.append(lg)
    launches = flash_decode_cuda.launches
    out["launches"] += launches
    check(launches == DECODE_STEPS * cfg.n_layers,
          f"prefill cell: flash_decode launched {launches} times in "
          f"{DECODE_STEPS} steps of {cfg.n_layers} layers")
    check(int(state.length) == s + DECODE_STEPS, "decode length")
    hidden, _ = tm.forward_hidden(params, toks, cfg)
    w = tm._head_matrix(params, cfg, torch.bfloat16)
    fwd_err = [rel_err(dec_logits[i], (hidden[:, s + i] @ w).float())
               for i in range(DECODE_STEPS)]
    with plain_kernels(), recorded_decode_inputs() as seen:
        plain_lg, _, _ = tm.decode_step(params, start, toks[:, s], cfg)
    path_err = rel_err(dec_logits[0], plain_lg)
    layer_rel = []
    for q, k, v, cl in seen:     # each layer's own inputs, kernel vs plain
        layer_rel.append(rel_to_max(flash_decode(q, k, v, cl),
                                    flash_decode_ref(q, k, v, cl))[1])
    del seen, hidden, start
    log(f"phase 8: prefill B={b} S={s} (cut from 32 x 32768): "
        f"{spread(lat[1:])} ({b * s / pre_ms * 1e3:.0f} tokens/s; first "
        f"call {lat[0] * 1e3:.1f} ms); then {DECODE_STEPS} decode steps from "
        f"its cache: {spread(step_lat)} a step ({b / np.median(step_lat):.0f}"
        f" tokens/s), flash_decode launches {launches}; decode logits vs "
        f"the forward over the same tokens, max rel err "
        f"{max(fwd_err):.4f} (bar {DECODE_REL}); kernel path vs plain path "
        f"{path_err:.2e} (bar {KERNEL_PATH_REL}); flash_decode vs its plain "
        f"version on each of the {len(layer_rel)} layers' own inputs of that"
        f" step, over max |plain|: at most {max(layer_rel):.3e} (bar "
        f"{FLASH_REL})")
    check(max(fwd_err) < DECODE_REL, f"decode != forward: {fwd_err}")
    check(path_err < KERNEL_PATH_REL, f"decode kernel path != plain path: "
                                      f"{path_err}")
    check(len(layer_rel) == cfg.n_layers and max(layer_rel) <= FLASH_REL,
          f"decode layers: flash_decode != plain on the path's inputs: "
          f"{layer_rel}")
    del state, logits, embed, dec_logits
    free_card()

    for name, batch in (("decode_32k", 32), ("long_500k", 1)):
        cell_shape = shapes[name].replace(global_batch=batch)
        cell = build_cell(LLAMA, cell_shape, device)
        t0 = time.perf_counter()
        state, tok = cell.make_inputs(0)
        sync()
        t_cache = time.perf_counter() - t0
        sq = cell.cell.seq_len
        cache_gb = 2 * state.k.numel() * state.k.element_size() / 1e9
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        flash_decode_cuda.launches = 0
        step_lat = []
        for _ in range(DECODE_STEPS):
            t0 = time.perf_counter()
            lg, emb, state = cell.fn(params, state, tok)
            tok = lg[:, :cfg.vocab_size].argmax(-1)
            sync()
            step_lat.append(time.perf_counter() - t0)
        launches = flash_decode_cuda.launches
        out["launches"] += launches
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        check(launches == DECODE_STEPS * cfg.n_layers,
              f"{name}: flash_decode launched {launches} times")
        check(int(state.length) == sq - 16 + DECODE_STEPS
              and bool(torch.isfinite(lg).all()),
              f"{name}: length and finite logits")
        no_host_sync(lambda: cell.fn(params, state, tok))
        dev, held = device_ms(lambda: cell.fn(params, state, tok), reps=4)
        wall, busy, kern = device_busy_share(
            lambda: cell.fn(params, state, tok), "flash_decode")
        med = float(np.median(step_lat[1:]))
        log(f"phase 8: {name} B={batch}"
            + (" (cut from 128)" if batch != shapes[name].global_batch
               else "")
            + f" S={sq}: seeded cache of {cache_gb:.2f} GB at length "
              f"{sq - 16} made in {t_cache:.2f} s; {DECODE_STEPS} greedy "
              f"steps: {spread(step_lat)} ({batch / med:.1f} tokens/s from "
              f"the median after the first), flash_decode launches "
              f"{launches}, peak memory above weights and cache {peak:.3f} "
              f"GB; a step makes no host sync (sync debug mode \"error\"); "
              f"the card's time a step {dev:.3f} ms (CUDA events, card held "
              f"busy while enqueuing: {held}): idle {1 - dev / med / 1e3:.3f}"
              f" of the median step; "
              f"one step under torch.profiler: wall {wall:.3f} ms, card "
              f"busy {busy:.3f} (idle {1 - busy:.3f}), flash_decode "
              f"{kern:.3f} ms of it")
        out[name] = flash_decode_time(state, cfg, name)
        del state, lg, emb, tok
        free_card()
    return out


def flash_decode_time(state, cfg, name: str) -> dict:
    """The decode-attention kernel at the cell's shape, on layer 0's cache
    at the state's length: its time beside its bound (the live K and V read
    once), its plain version's and ``scaled_dot_product_attention``'s with
    ``enable_gqa`` and the length mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode.kernel import flash_decode_cuda
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    k, v, cl = state.k[0], state.v[0], state.length
    b, s, kh, dh = k.shape
    gq = cfg.n_heads // kh
    gen = torch.Generator(device=k.device).manual_seed(1)
    q = torch.randn(b, kh, gq, dh, device=k.device, generator=gen)
    live = int(cl)
    qs = q.to(k.dtype).reshape(b, kh * gq, 1, dh)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=k.device) < cl)[None, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    got = flash_decode_cuda(q, k, v, cl)
    err, rel = rel_to_max(got, flash_decode_ref(q, k, v, cl))
    check(rel <= FLASH_REL, f"{name}: flash_decode at the cell's shape: "
                            f"err {err}, over max |plain| {rel}")
    lib_err, _ = max_rel_err(library().float().reshape(got.shape), got)
    ms, held_k = device_ms(lambda: flash_decode_cuda(q, k, v, cl), reps=20)
    plain, held_p = device_ms(lambda: flash_decode_ref(q, k, v, cl), reps=3)
    lib, held_l = device_ms(library, reps=20)
    elt = k.element_size()
    b_ms, b_by = bound(2.0 * b * live * kh * dh * elt + 8.0 * b * kh * gq * dh
                       + 4.0, 4.0 * b * kh * gq * live * dh)
    live_bytes = 2.0 * b * live * kh * dh * elt
    log(f"phase 8: {name}: flash_decode B={b} kh={kh} g={gq} dh={dh} over "
        f"{live} of {s} positions, {k.dtype} (device time, card held busy "
        f"while enqueuing: {held_k}, {held_p}, {held_l}): kernel {ms:.4f} ms"
        f" ({live_bytes / ms / 1e6:.1f} GB/s of live K and V), plain "
        f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms "
        f"(|diff| {lib_err:.2e}), bound {b_ms:.4f} ms ({b_by}); kernel vs "
        f"plain max_abs_err {err:.3e}, over max |plain| {rel:.3e} (bar "
        f"{FLASH_REL})")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/kernel.py:62",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


#: The graph --ab times: phase 4's shape (20,000 x 64, M=32,
#: ef_construction 100, 256 queries, ef 80, k1 40) over clustered points.
AB_GRAPH = {"n": 20_000, "d": 64, "m": 32, "ef_construction": 100,
            "queries": 256, "ef": 80, "k1": 40}


def ab_graph(path: str) -> None:
    """Build the ``AB_GRAPH`` graph once, on the host, with this tree's
    port (the build is bitwise the reference's in both trees), and save it
    with its noisy queries for the timing processes of both trees."""
    from repro_torch.search import hnsw

    c = AB_GRAPH
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, c["d"])) * 2
    x = (centers[rng.integers(0, 16, c["n"])]
         + rng.normal(size=(c["n"], c["d"]))).astype(np.float32)
    q = (x[rng.integers(0, c["n"], c["queries"])]
         + 0.05 * rng.normal(size=(c["queries"], c["d"]))).astype(np.float32)
    g = hnsw.build(x, M=c["m"], ef_construction=c["ef_construction"], seed=0)
    sq8 = hnsw.make_graph_codes(x, "sq8", device="cuda")
    pq = hnsw.make_graph_codes(x, "pq", m=8, seed=0, device="cuda")
    np.savez(path, vecs=g.vecs, levels=g.levels, links0=g.links0,
             links=g.links, entry=g.entry, M=g.M, queries=q,
             sq8_codes=sq8.codes, sq8_node_bias=sq8.node_bias,
             sq8_vmin=sq8.vmin, sq8_step=sq8.step, pq_codes=pq.codes,
             pq_node_bias=pq.node_bias, pq_codebooks=pq.codebooks)


def graph_times(graph_path: str, payload: str = "f32") -> dict:
    """The ``AB_GRAPH`` stage-1 traversal (``search_batched``) with this
    process's port, over float32 rows or the SQ8 / PQ8x8 payload trained
    once by ``ab_graph``: wall ms of a 256-query batch (median of 5) and of
    one query (median of 64), each ending in a sync, and the card's busy
    share of a batch."""
    from repro_torch.search import hnsw

    z = np.load(graph_path)
    graph = hnsw.HNSWGraph(vecs=z["vecs"], levels=z["levels"],
                           links0=z["links0"], links=z["links"],
                           entry=int(z["entry"]), M=int(z["M"]))
    if payload == "sq8":
        graph.codec = hnsw.GraphCodes(
            kind="sq8", codes=z["sq8_codes"], node_bias=z["sq8_node_bias"],
            vmin=z["sq8_vmin"], step=z["sq8_step"])
    elif payload == "pq":
        graph.codec = hnsw.GraphCodes(
            kind="pq", codes=z["pq_codes"], node_bias=z["pq_node_bias"],
            codebooks=z["pq_codebooks"])
    qb = torch.as_tensor(z["queries"], device="cuda")
    k1, ef = AB_GRAPH["k1"], AB_GRAPH["ef"]

    def search(q):
        out = hnsw.search_batched(graph, q, k1, ef_search=ef, device="cuda")
        sync()
        return out

    def wall(q, reps):
        search(q)
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            search(q)
            lat.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(lat))

    single = [wall(qb[i:i + 1], 1) for i in range(64)]
    _, busy, _ = device_busy_share(lambda: search(qb), "graph")
    return {"batch_ms": wall(qb, 5), "single_ms": float(np.median(single)),
            "batch_idle_share": 1.0 - busy,
            "hops": search(qb)[3]}


def redesign_times(src: str, graph_path: str) -> dict:
    """The redesigned kernels and the graph search, timed with the port
    whose ``src`` directory is given (put first on the path, its kernels
    built from its own sources): ``topk_merge`` at its three timed shapes
    over seeded shard candidates (``merge_shapes``, ``merge_times``);
    ``pq_adc`` at the PQ path's shape (Q=256,
    N=1,000,003, PQ8x8, seeded codes) at k = 320 and 2048 beside the
    library composite (``pq_library``); the ``AB_GRAPH`` traversal over
    float32 rows and its SQ8 and PQ8x8 payloads (``graph_times``);
    ``l2_topk`` at the Flat path's shape (Q=256, N=1M, d=64) at k = 40 and
    2048 beside ``torch.matmul`` + ``torch.topk``; the encoder at
    [1M,768]@[768,64] with its ``torch.matmul``; decode_32k (cut to B=32)
    and long_500k as phase 8 drives them, 8 greedy steps from a seeded
    cache, each step's wall time and the card's time a step, then the
    decode kernel at the cell's shape (``flash_decode_time``). One tree a
    process; ``--ab`` runs two trees in turns."""
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import _build

    _build.build(("rae_encode", "flash_decode", "l2_topk", "graph_beam",
                  "pq_adc", "graph_beam_q", "topk_merge"))
    import repro_torch
    from repro_torch.configs import get_shapes
    from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda
    from repro_torch.models.registry import build_cell

    check(os.path.abspath(repro_torch.__file__).startswith(
        os.path.abspath(src)), f"repro_torch imported from {src}")
    from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda
    from repro_torch.kernels.pq_adc.kernel import pq_adc_cuda

    out: dict = {"src": src}
    g = torch.Generator(device="cuda").manual_seed(0)
    out["topk_merge"] = merge_times(merge_shapes(g))
    free_card()
    q = torch.randn(256, 64, device="cuda", generator=g)
    cb = torch.randn(8, 256, 8, device="cuda", generator=g)
    codes = torch.randint(0, 256, (1_000_003, 8), device="cuda",
                          generator=g, dtype=torch.uint8)
    out["pq_adc"] = {}
    for k in (320, 2048):
        out["pq_adc"][str(k)] = {
            "ms": cuda_ms(lambda: pq_adc_cuda(q, cb, codes, k), reps=10),
            "library_ms": cuda_ms(lambda: pq_library(q, cb, codes, k),
                                  reps=3)}
    del q, cb, codes
    free_card()
    q = torch.randn(256, 64, device="cuda", generator=g)
    d = torch.randn(1_000_000, 64, device="cuda", generator=g)
    d_sq = (d * d).sum(1)
    out["l2_topk"] = {}
    for k in (40, 2048):
        out["l2_topk"][str(k)] = {
            "ms": cuda_ms(lambda: l2_topk_scan_cuda(q, d, d_sq, k), reps=10),
            "library_ms": cuda_ms(
                lambda: torch.topk(2.0 * (q @ d.T) - d_sq, k), reps=10)}
    del q, d, d_sq
    free_card()
    out.update(ivf_probe_times(g))
    free_card()
    out["graph"] = graph_times(graph_path)
    out["graph_sq8"] = graph_times(graph_path, "sq8")
    out["graph_pq"] = graph_times(graph_path, "pq")
    rows, n, m = 1_000_000, 768, 64
    x = torch.randn(rows, n, device="cuda", generator=g)
    w = torch.randn(n, m, device="cuda", generator=g) / n ** 0.5
    _, rel = max_rel_err(rae_encode_cuda(x, w, False), x @ w)
    check(rel <= ENCODE_TOL, f"rae_encode at [1M,768]@[768,64]: {rel}")
    nbytes = 4.0 * (rows * n + n * m + rows * m)
    out["rae_encode"] = {
        "ms": cuda_ms(lambda: rae_encode_cuda(x, w, False), reps=20),
        "library_ms": cuda_ms(lambda: torch.matmul(x, w), reps=20),
        "bound_ms": bound(nbytes, 6.0 * rows * n * m, PEAK_TF32_FLOPS)[0],
        "simt_bound_ms": bound(nbytes, 2.0 * rows * n * m)[0],
        "rel_err": rel}
    del x, w
    free_card()
    shapes = {c.name: c for c in get_shapes(LLAMA)}
    params = None
    for name, batch in (("decode_32k", 32), ("long_500k", 1)):
        cell = build_cell(LLAMA, shapes[name].replace(global_batch=batch),
                          "cuda")
        params = cell.init(0) if params is None else params
        state, tok = cell.make_inputs(0)
        lat = []
        for _ in range(DECODE_STEPS):
            t0 = time.perf_counter()
            lg, _, state = cell.fn(params, state, tok)
            tok = lg[:, :cell.cfg.vocab_size].argmax(-1)
            sync()
            lat.append(time.perf_counter() - t0)
        card, held = device_ms(lambda: cell.fn(params, state, tok), reps=4)
        entry = flash_decode_time(state, cell.cfg, name)
        k = state.k[0]
        live = 2.0 * k.shape[0] * int(state.length) * k.shape[2] \
            * k.shape[3] * k.element_size()
        out[name] = {"step_ms": [t * 1e3 for t in lat],
                     "step_median_ms": float(np.median(lat[1:])) * 1e3,
                     "card_ms_a_step": card, "card_held_busy": held,
                     "flash_decode": entry,
                     "flash_decode_gb_s": live / entry["ms"] / 1e6}
        del state, lg, tok
        free_card()
    return out


def ivf_probe_times(g: torch.Generator) -> dict:
    """The IVF probes at the shapes of phase 5's ``IVF256`` twin (k1 = 40)
    and phase 6's ``IVF256,PQ8x8`` (k1 = 320): 256 queries probing 16 of
    256 seeded lists over 1,000,003 rows (the build's cap, 2.5x the mean
    list), d = 64, PQ8x8 codes; each a search's card time."""
    from repro_torch.search import ivf as ivf_lib
    from repro_torch.search import quantize as qz

    n, n_cells, d, nprobe = 1_000_003, 256, 64, 16
    cap = int(np.ceil(2.5 * n / n_cells))
    slot = torch.randperm(n_cells * cap, device="cuda", generator=g)
    lists = torch.where(slot < n, slot, -1).reshape(n_cells, cap).to(
        torch.int32)
    mask = lists >= 0
    index = ivf_lib.IVFIndex(
        centroids=torch.randn(n_cells, d, device="cuda", generator=g),
        lists=lists, list_mask=mask, spill=0,
        list_vecs=torch.randn(n_cells, cap, d, device="cuda", generator=g))
    q = torch.randn(256, d, device="cuda", generator=g)
    out = {"ivf_probe": {"k": 40, "ms": cuda_ms(
        lambda: ivf_lib.search(index, q, 40, nprobe=nprobe), reps=10)}}
    codes = torch.randint(0, 256, (n_cells, cap, 8), device="cuda",
                          generator=g, dtype=torch.uint8)
    cb = torch.randn(8, 256, d // 8, device="cuda", generator=g)
    out["ivf_pq_probe"] = {"k": 320, "ms": cuda_ms(
        lambda: qz.ivf_pq_search(index.centroids, lists, codes, mask, cb, q,
                                 320, nprobe), reps=10)}
    return out


def ab(parent_src: str) -> int:
    """Parent and change on one card in turns (parent, change, change,
    parent), each ``redesign_times`` in a process of its own; prints each
    run's numbers, then one JSON line of all four and the card's name and
    power limit."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    runs = []
    tmp = tempfile.mkdtemp()
    graph_path = os.path.join(tmp, "graph.npz")
    t0 = time.perf_counter()
    ab_graph(graph_path)
    log(f"--ab graph {AB_GRAPH} built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    for label, src in (("parent", parent_src), ("change", here),
                       ("change", here), ("parent", parent_src)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--times", src, "--graph", graph_path],
                              capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:
            log(f"{label}: {line}")
        if proc.returncode != 0 or not lines:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1])
        res["label"] = label
        runs.append(res)
        enc, gr = res["rae_encode"], res["graph"]
        log(f"{label} ({src}): topk_merge "
            + "; ".join(f"{n} Q={t['q']} C={t['c']} k={t['k']} "
                        f"{t['ms']:.4f} ms (held {t['held']}; plain "
                        f"{t['plain_ms']:.4f}, two stable sorts + gathers "
                        f"{t['library_ms']:.4f}, bound {t['bound_ms']:.6f})"
                        for n, t in res["topk_merge"].items()
                        if n != "floor_ms")
            + f"; launch floor {res['topk_merge']['floor_ms']:.4f} ms")
        log(f"{label} ({src}): pq_adc Q=256 N=1,000,003 PQ8x8 "
            + ", ".join(f"k={k} {v['ms']:.4f} ms (library "
                        f"{v['library_ms']:.4f})"
                        for k, v in res["pq_adc"].items())
            + "; " + "; ".join(
                f"graph {name}: batch {res[key]['batch_ms']:.3f} ms (idle "
                f"share {res[key]['batch_idle_share']:.4f}, "
                f"{res[key]['hops']} hops), one query "
                f"{res[key]['single_ms']:.3f} ms"
                for name, key in (("SQ8", "graph_sq8"),
                                  ("PQ8x8", "graph_pq"))))
        log(f"{label} ({src}): IVF probes Q=256 over 1,000,003 rows, 16 "
            f"of 256 lists: flat k=40 {res['ivf_probe']['ms']:.4f} ms, "
            f"PQ8x8 k=320 {res['ivf_pq_probe']['ms']:.4f} ms")
        log(f"{label} ({src}): l2_topk Q=256 N=1M d=64 "
            + ", ".join(f"k={k} {v['ms']:.4f} ms (matmul + topk "
                        f"{v['library_ms']:.4f})"
                        for k, v in res["l2_topk"].items())
            + f"; graph {AB_GRAPH['n']} x {AB_GRAPH['d']} M={AB_GRAPH['m']} "
            f"ef={AB_GRAPH['ef']}: batch of {AB_GRAPH['queries']} "
            f"{gr['batch_ms']:.3f} ms (idle share "
            f"{gr['batch_idle_share']:.4f}, {gr['hops']} hops), one query "
            f"{gr['single_ms']:.3f} ms")
        log(f"{label} ({src}, {time.perf_counter() - t0:.1f} s): rae_encode "
            f"{enc['ms']:.4f} ms (torch.matmul {enc['library_ms']:.4f}, "
            f"bound {enc['bound_ms']:.4f}, err {enc['rel_err']:.2e}); "
            + "; ".join(
                f"{c}: flash_decode {res[c]['flash_decode']['ms']:.4f} ms "
                f"({res[c]['flash_decode_gb_s']:.0f} GB/s; SDPA "
                f"{res[c]['flash_decode']['library_ms']:.4f}, bound "
                f"{res[c]['flash_decode']['bound_ms']:.4f}), step median "
                f"{res[c]['step_median_ms']:.3f} ms, card "
                f"{res[c]['card_ms_a_step']:.3f} ms a step"
                for c in ("decode_32k", "long_500k")))
    os.unlink(graph_path)
    os.rmdir(tmp)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"ab": runs}))
    print(smi)
    return 0


# ---------------------------------------------------------------------------
# Phase 9: the Table 1 baselines, the theory and live mutation
# ---------------------------------------------------------------------------
TABLE1_METHODS = ("rae", "pca", "rp", "mds", "isomap", "umap")
#: UMAP-lite's fit is host numpy (a dense 4096^2 ``eigh`` and 100 epochs of
#: ``np.add.at`` SGD over its edge list, 256 wide at m = 256: over a
#: minute a fit); phase 9 cuts it to this, the other five run at their
#: defaults
UMAP_CUT = {"max_train": 2048, "n_epochs": 50}
#: the methods whose transform is the ``rae_encode`` GEMM
AFFINE = ("rae", "pca", "rp", "mds", "isomap")
MUT_SPECS_1M = ("Mut,RAE64,Flat,Rerank4", "Mut,RAE64,IVF256,Rerank4")
MUT_GRAPH_SPECS = ("Mut,RAE64,HNSW32,Rerank4", "Mut,RAE64,HNSW32,SQ8,Rerank4",
                   "Mut,RAE64,HNSW32,PQ8x8,Rerank4")


@functools.cache
def card_label() -> str:
    """``nvidia-smi``'s card name and power limit, printed beside times."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class PathLaunches:
    """Launch counts of the kernels on phase 9's or phase 10's paths, summed over the
    stretches that drive them (``with launches.main():``); launches made
    to compare a kernel with its plain version fall outside them."""

    def __init__(self):
        from repro_torch.kernels.graph_beam.kernel import graph_traverse_cuda
        from repro_torch.kernels.graph_beam_q.kernel import (
            graph_traverse_q_cuda)
        from repro_torch.kernels.l2_topk.kernel import l2_topk_scan_cuda
        from repro_torch.kernels.pq_adc.kernel import pq_adc_cuda
        from repro_torch.kernels.rae_encode.kernel import rae_encode_cuda
        from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda

        # the kernels line's names: the traversals are the graph kernels'
        self.counters = {"rae_encode": rae_encode_cuda,
                         "l2_topk": l2_topk_scan_cuda,
                         "graph_beam": graph_traverse_cuda,
                         "graph_beam_q": graph_traverse_q_cuda,
                         "topk_merge": topk_merge_cuda,
                         "pq_adc": pq_adc_cuda}
        self.total = {k: 0 for k in self.counters}

    @contextlib.contextmanager
    def main(self):
        for fn in self.counters.values():
            fn.launches = 0
        yield
        for k, fn in self.counters.items():
            self.total[k] += fn.launches


def reducer_plain(r, x: torch.Tensor) -> torch.Tensor:
    """An affine reducer's transform with the plain version of the
    ``rae_encode`` GEMM, on the same operands."""
    from repro_torch.kernels.rae_encode.ref import rae_encode_ref

    if r.kind == "rae":
        z = rae_encode_ref(x, r.params_["w_e"], False)
        return z + r.params_["b_e"] if "b_e" in r.params_ else z
    impl = r._impl
    if r.kind == "pca":
        return rae_encode_ref(x - impl._on("mean_", x.device),
                              impl._on("components_", x.device), False)
    if r.kind == "rp":
        return rae_encode_ref(x, impl._on("w_", x.device), False)
    w = impl._on("w_", x.device)
    return rae_encode_ref(x, w[:-1], False) + w[-1]


def phase9_table1(device: str, launches: PathLaunches, n: int = 10_000,
                  rae_steps: int = 3000) -> dict:
    """Table 1 at the paper's size: ``imdb_like`` 10,000 x 768 split 9:1,
    m = 256, top-5, euclidean and cosine, each method fitted on the 9,000
    and held on the 1,000 (``benchmarks/table1_knn.py``'s protocol, the
    RAE at its defaults: 3000 steps, wd 1e-2, no lambda grid). Checks each
    affine transform's kernel against its plain version, Isomap's
    geodesics on the card against the CPU's min-plus, and Eq. 15 on the
    RAE's W_e."""
    from repro_torch import api
    from repro_torch.core import baselines, metrics, spectral, theory
    from repro_torch.core import rae as rae_lib
    from repro_torch.data import paper_dataset, train_test_split

    data = paper_dataset("imdb_like", n, seed=0)
    tr, te = train_test_split(data)
    x_all = torch.as_tensor(data, device=device)
    x_te = torch.as_tensor(te, device=device)
    out, fitted = {}, {}
    for name in TABLE1_METHODS:
        kw = ({"steps": rae_steps, "weight_decay": 1e-2, "seed": 0}
              if name == "rae" else UMAP_CUT if name == "umap" else {})
        r = api.make_reducer(name, 256, device=device, **kw)
        with launches.main():
            t0 = time.perf_counter()
            r.fit(tr)
            sync()
            t_fit = time.perf_counter() - t0
            t0 = time.perf_counter()
            z = r.transform(x_te)
            sync()
            t_tr = time.perf_counter() - t0
        p = {m: metrics.preservation_accuracy(x_te, z, k=5, metric=m)
             for m in ("euclidean", "cosine")}
        check(z.shape == (te.shape[0], 256) and bool(torch.isfinite(z).all())
              and all(0.0 <= v <= 1.0 for v in p.values()),
              f"{name}: reduced rows finite, P_overall in [0, 1]: {p}")
        err = None
        if name in AFFINE:
            got, want = r.transform(x_all), reducer_plain(r, x_all)
            err = max_rel_err(got, want)[1]
            check(err <= ENCODE_TOL, f"{name}: transform (rae_encode) vs "
                                     f"plain {err} > {ENCODE_TOL}")
        fitted[name] = r
        out[name] = {"fit_s": t_fit, "transform_s": t_tr, "p": p,
                     "err": err}
        log(f"phase 9: table 1 {name}: fit {t_fit:.2f} s, transform of "
            f"{te.shape[0]} rows {t_tr * 1e3:.2f} ms; P_overall top-5 "
            f"euclidean {p['euclidean']:.4f}, cosine {p['cosine']:.4f}"
            + ("" if err is None else
               f"; kernel vs plain on {n} rows {err:.2e} of max(1, max "
               f"|plain|)") + f" [{card_label()}]")
    rank = sorted(out, key=lambda k: -out[k]["p"]["euclidean"])
    log(f"phase 9: table 1 order by euclidean P_overall: {' > '.join(rank)}"
        f" (the paper's: RAE, PCA above MDS, Isomap, UMAP)")

    # Isomap's geodesics: every min-plus round on the card against the
    # CPU's on the same input rows (64 rows a round), then the whole chain
    iso = fitted["isomap"]._impl
    x = np.asarray(tr, np.float32)
    if x.shape[0] > iso.max_train:
        x = x[np.random.default_rng(0).choice(x.shape[0], iso.max_train,
                                              replace=False)]
    graph = iso.knn_graph(x)
    n = graph.shape[0]
    gd = torch.as_tensor(graph, device=device)
    t0 = time.perf_counter()
    rounds = int(np.ceil(np.log2(max(n, 2))))
    for rnd in range(rounds):
        nxt = baselines._minplus_square_chunked(gd)
        rows = torch.as_tensor(np.random.default_rng(rnd).choice(
            n, 64, replace=False))
        d_cpu = gd.cpu()
        want = torch.amin(d_cpu[rows][:, :, None] + d_cpu[None], dim=1)
        check(torch.equal(nxt[rows.to(device)].cpu(), want),
              f"isomap: min-plus round {rnd} on the card differs from the "
              f"CPU's")
        gd = nxt
    t_check = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    geo = baselines.geodesics(graph, device)
    t_geo = time.perf_counter() - t0
    check(np.array_equal(geo, gd.cpu().numpy()),
          "isomap: geodesics() differ from the checked rounds")
    log(f"phase 9: isomap geodesics n={n}: {rounds} min-plus rounds on the "
        f"card in {t_geo:.3f} s, each bit-equal to the CPU's on 64 rows "
        f"({t_check:.2f} s with the checks); unreachable pairs "
        f"{int(np.isinf(geo).sum())} [{card_label()}]")

    # Eq. 15-16 on the RAE's encoder
    w = rae_lib.encoder_matrix(fitted["rae"].params_)
    holds = bool(theory.norm_bounds_hold(w, x_all))
    st = spectral.analyze(w)
    cf = float(theory.certified_fraction(w, x_te, 5))
    dist = theory.empirical_distortion(w, x_all)
    log(f"phase 9: RAE W_e [{w.shape[0]}, {w.shape[1]}]: sigma_max "
        f"{float(st.sigma_max):.4f}, sigma_min {float(st.sigma_min):.4f}, "
        f"kappa {float(st.condition_number):.3f}, effective rank "
        f"{float(st.effective_rank):.1f}; ||Wx||/||x|| over the {n} rows "
        f"in [{float(dist['ratio_min']):.4f}, {float(dist['ratio_max']):.4f}]"
        f"; Eq. 15 bounds hold on the rows' row-space part: {holds}; "
        f"certified fraction (Eq. 16, top-5, the {te.shape[0]} test rows) "
        f"{cf:.4f}")
    check(holds, "Eq. 15: norm_bounds_hold is false on the corpus rows")
    return out


def phase9_factory(device: str, launches: PathLaunches) -> dict:
    """``PCA64,Flat,Rerank4`` and ``PCA64,IVF256,Rerank4`` on phase 2's
    20k x 256 corpus, recall@10 beside ``RAE64``'s (no gate: the
    baseline)."""
    from repro_torch import api
    from repro_torch.core import metrics

    corpus, queries = acceptance_data()
    gt = metrics.knn_indices(torch.as_tensor(queries, device=device),
                             torch.as_tensor(corpus, device=device), 10)
    out = {}
    for spec in ("PCA64,Flat,Rerank4", "PCA64,IVF256,Rerank4"):
        idx = api.index_factory(spec, device=device)
        with launches.main():
            t0 = time.perf_counter()
            idx.build(corpus)
            sync()
            t_build = time.perf_counter() - t0
            res = idx.search(queries, 10)
        check(res.indices.shape == (64, 10) and (res.indices >= 0).all()
              and np.isfinite(res.scores).all(),
              f"{spec}: answers full, finite, in range")
        out[spec] = metrics.recall_at_k(torch.as_tensor(res.indices,
                                                        device=device), gt)
        rae = ACCEPTANCE.get(spec.replace("PCA", "RAE"))
        log(f"phase 9: {spec} on 20000x256, 64 queries: recall@10 "
            f"{out[spec]:.4f} (RAE64's in phase 2: "
            f"{'not run' if rae is None else f'{rae:.4f}'}); build "
            f"{t_build:.2f} s, search {res.latency_s * 1e3:.3f} ms "
            f"[{card_label()}]")
    return out


def tie_order_ok(res) -> bool:
    """Equal scores in an answer row list their ids ascending."""
    s, i = res.scores, res.indices
    tied = (s[:, 1:] == s[:, :-1]) & (i[:, 1:] >= 0)
    return bool((i[:, 1:][tied] > i[:, :-1][tied]).all())


def rebuild_kept(before, after) -> tuple[int, int]:
    """Of the answer rows of ``before`` and ``after`` (lists of search
    results), how many are equal (ids and scores), and how many differ
    otherwise than in the order of ids at a tied score: a score that
    differs, or an id that differs where its score is not tied in its row
    (nor equal to the row's last, which may tie a row left out)."""
    sb = np.concatenate([r.scores for r in before])
    sa = np.concatenate([r.scores for r in after])
    ib = np.concatenate([r.indices for r in before])
    ia = np.concatenate([r.indices for r in after])
    tied = sb == sb[:, -1:]
    tied[:, 1:] |= sb[:, 1:] == sb[:, :-1]
    tied[:, :-1] |= sb[:, :-1] == sb[:, 1:]
    same = (ib == ia).all(axis=1) & (sb == sa).all(axis=1)
    bad = ~((sb == sa).all(axis=1) & ((ib == ia) | tied).all(axis=1))
    return int(same.sum()), int(bad.sum())


def phase9_mutation_1m(device: str, launches: PathLaunches,
                       n: int = 1_000_003, n_extra: int = 10_000,
                       steps: int = 3000) -> dict:
    """``Mut,RAE64,Flat,Rerank4`` and ``Mut,RAE64,IVF256,Rerank4`` on phase
    5's 1,000,003 x 768 corpus and fit (no cut): 10,000 further rows of
    the corpus' ``imdb_like`` mixture (``holdout_rows``) added in 4
    batches of 2,500, each found as itself at rank 1; 10,000 seeded ids
    deleted (1,000 of them new), none surfacing, the masked scan equal to
    its plain version; one ``rebuild()``, after which every answer of both
    stacks is the one before it, ids in a row's order of tied scores
    aside; phase 5's 1,024 held-out queries in batches of 256 before the
    adds, after the delete and after the rebuild."""
    from repro_torch import api
    from repro_torch.kernels.l2_topk import l2_topk
    from repro_torch.kernels.l2_topk.ref import l2_topk_ref

    nq, batch, per_add = 1024, 256, n_extra // 4
    corpus, queries, _ = full_data(n, nq)
    reducer, _ = fitted_rae(n, nq, steps, device)
    extra = holdout_rows(n, nq)[:n_extra]
    rng = np.random.default_rng(9)
    n_dead = n_extra                  # 9 of 10 old, 1 of 10 new
    dead = np.sort(np.concatenate([
        rng.choice(n, n_dead - n_dead // 10, replace=False),
        n + rng.choice(n_extra, n_dead // 10, replace=False)])
    ).astype(np.int64)
    out = {}

    def answers(idx):
        rs = [idx.search(queries[s:s + batch], 10)
              for s in range(0, nq, batch)]
        return rs, [r.latency_s for r in rs]

    for spec in MUT_SPECS_1M:
        idx = api.index_factory(spec, device=device)
        idx._inner.reducer = reducer        # phase 5's fit, shared
        t = {}
        with launches.main():
            t0 = time.perf_counter()
            idx.build(corpus)
            sync()
            t["build"] = time.perf_counter() - t0
            clean, lat_clean = answers(idx)
            t["add"] = []
            for b in range(4):
                t0 = time.perf_counter()
                ext = idx.add(extra[b * per_add:(b + 1) * per_add])
                sync()
                t["add"].append(time.perf_counter() - t0)
                check(np.array_equal(ext, np.arange(n + b * per_add,
                                                    n + (b + 1) * per_add)),
                      f"{spec}: add returned ids {ext[:3]}...")
            hits = 0
            for s in range(0, n_extra, batch):
                r = idx.search(extra[s:s + batch], 10)
                hits += int((r.indices[:, 0] == n + s + np.arange(
                    r.indices.shape[0])).sum())
            t0 = time.perf_counter()
            deleted = idx.delete(dead)
            t["delete"] = time.perf_counter() - t0
            masked, lat_masked = answers(idx)
            adversarial = idx.search(np.concatenate(
                [corpus[dead[dead < n][:batch // 2]],
                 extra[dead[dead >= n][:batch // 2] - n]]), 10)
            t0 = time.perf_counter()
            idx.rebuild()
            sync()
            t["rebuild"] = time.perf_counter() - t0
            rebuilt, lat_rebuilt = answers(idx)
        check(hits == n_extra, f"{spec}: {hits}/{n_extra} added rows found "
                               f"as themselves at rank 1")
        check(deleted == n_dead, f"{spec}: delete tombstoned {deleted}")
        bad = sum(int(np.isin(r.indices, dead).sum())
                  for r in masked + [adversarial] + rebuilt)
        check(bad == 0, f"{spec}: {bad} tombstoned ids surfaced")
        st = idx.mutation_stats()
        check(st["tombstones"] == 0 and idx.n_rebuilds == 1
              and idx.n_reducer_retrains == 0
              and idx.epoch == 4 + 1 + idx.n_rebuilds,
              f"{spec}: after rebuild: {st}, epoch {idx.epoch}")
        same, moved = rebuild_kept(masked, rebuilt)
        ties = all(tie_order_ok(r) for r in masked + rebuilt)
        check(ties, f"{spec}: a score tie not listed by ascending id")
        # the rebuild compacts (and the IVF tier re-clusters); the external
        # ids and every answer stay (C8)
        check(moved == 0, f"{spec}: rebuild changed {moved}/{nq} answers "
                          f"otherwise than in the order of tied ids")
        if "Flat" in spec:
            # the exact tier: not even the order of tied ids moves
            check(same == nq,
                  f"{spec}: rebuild changed {nq - same}/{nq} answers")
            # under a seeded mask of n_dead rows, the kernel's stage 1 ==
            # the plain scan's, on the same reduced rows
            inner = idx._inner
            zq = inner.reducer.transform(torch.as_tensor(
                queries[:batch], device=device))
            k1 = inner.stage1_k(10)
            al = torch.ones(inner.ntotal, dtype=torch.bool, device=device)
            al[torch.as_tensor(rng.choice(inner.ntotal, n_dead,
                                          replace=False), device=device)] = 0
            kv, ki = l2_topk(zq, inner.base._db, k1, db_mask=al)
            pv, pi = l2_topk_ref(zq, inner.base._db, k1, db_mask=al)
            check(torch.equal(ki, pi) and max_rel_err(kv, pv)[1] <= SCORE_TOL,
                  f"{spec}: masked l2_topk kernel != plain")
            check(not bool((~al)[ki[ki >= 0].long()].any()),
                  f"{spec}: the masked kernel returned a masked row")
        # the host copy of every row, re-concatenated on each add
        t0 = time.perf_counter()
        grown = np.concatenate([idx._corpus, extra[:per_add]])
        t_concat = time.perf_counter() - t0
        del grown
        log(f"phase 9: {spec} on imdb_like {n}x768 (phase 5's fit): build "
            f"{t['build']:.2f} s; add 4 x {per_add}: "
            f"{[round(x, 3) for x in t['add']]} s (the host copy "
            f"{idx._corpus.nbytes / 1e9:.2f} GB, one concatenation "
            f"{t_concat:.3f} s); {n_extra} added rows found as themselves "
            f"at rank 1: {hits}; delete {n_dead} ids "
            f"{t['delete'] * 1e3:.2f} ms;"
            f" rebuild {t['rebuild']:.2f} s; drift violation rate "
            f"{st.get('drift_violation_rate', 0):.4f} [{card_label()}]")
        log(f"phase 9: {spec}: {batch}-query batches: clean "
            f"{spread(lat_clean)}, under {n_dead} tombstones "
            f"{spread(lat_masked)}, after the rebuild {spread(lat_rebuilt)}; "
            f"tombstoned ids surfaced 0 (of {10 * (2 * nq + batch)} "
            f"answers); answers unchanged by the rebuild {same}/{nq}, "
            f"changed otherwise than in tied ids' order {moved}; score "
            f"ties listed by ascending id: {ties}")
        out[spec] = {"t": t, "hits": hits, "same": same,
                     "lat": (lat_clean, lat_masked, lat_rebuilt)}
        del idx, clean, masked, rebuilt
        free_card()
    return out


def mutable_graph_stack(spec: str, twin, corpus: np.ndarray, device: str):
    """``spec`` (a ``Mut`` graph stack) over a copy of phase 4's graph and
    reducer: what ``build`` makes from the same corpus, reducer and seed
    (the host graph build is deterministic and takes 60-75 s a stack), the
    code payload trained as ``HNSWIndex.build`` trains it."""
    from repro_torch import api
    from repro_torch.search import hnsw

    mut = api.index_factory(spec, device=device)
    two, g = mut._inner, twin.base._g
    base = two.base
    base._g = hnsw.HNSWGraph(vecs=g.vecs.copy(), levels=g.levels.copy(),
                             links0=g.links0.copy(), links=g.links.copy(),
                             entry=g.entry, M=g.M)
    if base.quant is not None:
        base._g.codec = hnsw.make_graph_codes(
            base._g.vecs, base.quant, m=base.pq_m, bits=base.pq_bits,
            iters=base.kmeans_iters, seed=base.seed, device=device)
    base._upload()
    two.reducer = twin.reducer
    two._db_full = twin._db_full
    return mut._adopt(corpus)


def phase9_graphs(device: str, launches: PathLaunches, n_new: int = 1024,
                  n_dead: int = 2048) -> dict:
    """The three ``Mut`` graph stacks on phase 4's 20k x 256 corpus and
    reducer (cut as phase 4 is): 1,024 rows inserted, 2,048 ids deleted
    (the entry node among them), phase 4's 1,024 noisy queries. The
    one-launch traversal is held to the plain-hop loop under the mask."""
    from repro_torch import api
    from repro_torch.core import metrics
    from repro_torch.kernels.graph_beam.ref import graph_beam_ref
    from repro_torch.kernels.graph_beam_q.ref import graph_beam_q_ref
    from repro_torch.search import hnsw

    corpus, queries = acceptance_data()
    noisy = noisy_queries(corpus, 1024, seed=2)
    new = noisy_queries(corpus, n_new, seed=4)
    n = corpus.shape[0]
    if "idx" not in GRAPH_TWIN:            # phases 4 and 6 failed
        GRAPH_TWIN["idx"] = api.index_factory(
            "RAE64,HNSW32,Rerank4", reducer_kw={"steps": 1000, "seed": 0},
            device=device).build(corpus)
    twin = GRAPH_TWIN["idx"]
    full = np.concatenate([corpus, new])
    out, recalls = {}, {}
    for spec in MUT_GRAPH_SPECS:
        mut = mutable_graph_stack(spec, twin, corpus, device)
        g = mut._graph_index()._g
        rng = np.random.default_rng(11)
        with launches.main():
            t0 = time.perf_counter()
            ext = mut.add(new)
            sync()
            t_add = time.perf_counter() - t0
            add_times = dict(mut._graph_index().add_times)
            entry0 = g.entry                 # the entry after the insert
            dead = np.sort(np.append(rng.choice(np.setdiff1d(
                np.arange(n + n_new), [entry0]), n_dead - 1,
                replace=False), entry0))
            mut.delete(dead)
            res = [mut.search(noisy[s:s + 256], 10)
                   for s in range(0, len(noisy), 256)]
        check(np.array_equal(ext, np.arange(n, n + n_new)),
              f"{spec}: add ids")
        check(g.entry != entry0 and mut._alive[g.entry],
              f"{spec}: the tombstoned entry was not reassigned")
        ids = np.concatenate([r.indices for r in res])
        check(not np.isin(ids, dead).any(),
              f"{spec}: a tombstoned id surfaced")
        check((ids >= 0).all(), f"{spec}: an answer slot padded")
        # recall@10 against the exact scan over the alive rows
        alive_rows = np.flatnonzero(mut._alive)
        gt = metrics.knn_indices(torch.as_tensor(noisy, device=device),
                                 torch.as_tensor(full[alive_rows],
                                                 device=device), 10)
        gt = torch.as_tensor(alive_rows, device=device)[gt]
        recall = metrics.recall_at_k(torch.as_tensor(ids, device=device), gt)
        recalls[spec] = recall
        # the one-launch traversal == the plain-hop loop, under the mask
        inner = mut._inner
        zq = inner.reducer.transform(torch.as_tensor(noisy, device=device))
        k1 = inner.stage1_k(10)
        ef = max(inner.base.ef_search, k1)
        mask = mut._alive_dev
        hop = graph_beam_ref if g.codec is None else graph_beam_q_ref
        kern = hnsw.search_batched(g, zq, k1, ef_search=ef, alive=mask,
                                   device=device)
        plain = hnsw.search_batched(g, zq, k1, ef_search=ef, alive=mask,
                                    device=device, hop=hop)
        same = (all(torch.equal(a, b) for a, b in zip(kern[:3], plain[:3]))
                and kern[3] == plain[3])
        check(same, f"{spec}: under the mask the traversal kernel's ids, "
                    f"scores, evals or hops differ from the plain-hop loop's")
        log(f"phase 9: {spec} on {n}x256 (phase 4's graph and reducer): "
            f"insert {n_new} rows {t_add:.2f} s (insert_batch on the host "
            f"{add_times['insert_s']:.2f} s, re-pack + upload "
            f"{add_times['upload_s'] * 1e3:.1f} ms of {g.ntotal} rows); "
            f"delete {n_dead} ids, the entry {entry0} among them (now {g.entry}"
            f"); 1024 noisy queries in batches of 256: {spread([r.latency_s for r in res])}"
            f"; recall@10 against the exact scan over the alive rows "
            f"{recall:.4f}; traversal == plain-hop loop under the mask "
            f"(ids, scores, evals, hops {kern[3]}): {same} [{card_label()}]")
        out[spec] = {"t_add": t_add, **add_times, "recall": recall}
        del mut
    f32 = recalls[MUT_GRAPH_SPECS[0]]
    check(f32 >= 0.9, f"f32 graph recall@10 after mutation {f32} < 0.9")
    return out


def phase9_shared_rae(device: str):
    """RAE64 fitted once (1000 steps) on phase 2's corpus for parts (e)
    and (f)."""
    from repro_torch import api

    corpus, _ = acceptance_data()
    r = api.make_reducer("rae", 64, steps=1000, seed=0, device=device)
    return r.fit(corpus)


def phase9_sharded(device: str, launches: PathLaunches, reducer) -> dict:
    """``Mut,RAE64,Shard8,IVF256,Rerank4`` on phase 2's corpus: an ``add``
    rebuilds the sharded base (it has no ``add``), then a delete and a
    search; ``topk_merge`` launches under the mask."""
    from repro_torch import api

    corpus, queries = acceptance_data()
    noisy = noisy_queries(corpus, 1024, seed=2)
    new = noisy_queries(corpus, 100, seed=5)
    n = corpus.shape[0]
    mut = api.index_factory("Mut,RAE64,Shard8,IVF256,Rerank4", device=device)
    mut._inner.reducer = reducer
    dead = np.random.default_rng(12).choice(n + 100, 500, replace=False)
    with launches.main():
        mut.build(corpus)
        t0 = time.perf_counter()
        ext = mut.add(new)
        sync()
        t_add = time.perf_counter() - t0
        selfq = mut.search(new, 10)
        mut.delete(dead)
        before = launches.counters["topk_merge"].launches
        res = [mut.search(noisy[s:s + 256], 10)
               for s in range(0, len(noisy), 256)]
        merges = launches.counters["topk_merge"].launches - before
    alive_new = ~np.isin(ext, dead)
    # a row past its IVF cell's cap is not listed (the reference's spill),
    # so a self-query is counted, not gated
    self_hits = int((selfq.indices[:, 0] == ext).sum())
    ids = np.concatenate([r.indices for r in res])
    check(not np.isin(ids, dead).any() and (ids >= 0).all(),
          "Shard8: a tombstoned id surfaced")
    check(merges == len(res), f"Shard8: {merges} topk_merge launches for "
                              f"{len(res)} masked searches")
    log(f"phase 9: Mut,RAE64,Shard8,IVF256,Rerank4 on {n}x256: add 100 "
        f"rows (rebuilds the sharded base) {t_add:.2f} s, {self_hits} found "
        f"as themselves at rank 1; delete 500 ids ({int((~alive_new).sum())} of them new); "
        f"1024 noisy queries in batches of 256 under the mask: "
        f"{spread([r.latency_s for r in res])}, one topk_merge launch a "
        f"search, no tombstone surfaced [{card_label()}]")
    return {"t_add": t_add}


def phase9_drift(device: str, launches: PathLaunches, reducer) -> dict:
    """``Mut,RAE64,Flat,Rerank4`` on phase 2's corpus: 128 rows near the
    corpus leave the Eq. 15 monitor quiet; 256 rows off the fitted
    manifold (seeded Gaussian rows with their part in W_e's row space
    removed, scaled to the corpus' mean norm: ||Wx||/||x|| near 0) trip
    it, and ``add`` retrains the reducer and rebuilds."""
    from repro_torch import api

    corpus, _ = acceptance_data()
    n = corpus.shape[0]
    mut = api.index_factory("Mut,RAE64,Flat,Rerank4", device=device)
    mut._inner.reducer = reducer
    near = noisy_queries(corpus, 128, seed=6)
    w = reducer.params_["w_e"].detach().cpu().numpy()       # [n, m]
    basis = np.linalg.svd(w, full_matrices=False)[0]          # row(W)
    rng = np.random.default_rng(13)
    off = rng.standard_normal((256, corpus.shape[1])).astype(np.float32)
    off -= (off @ basis) @ basis.T
    off *= (np.linalg.norm(corpus, axis=1).mean()
            / np.linalg.norm(off, axis=1, keepdims=True))
    off = off.astype(np.float32)
    with launches.main():
        mut.build(corpus)
        fp0 = mut._inner.reducer.fingerprint()
        mut.add(near)
        quiet = (mut.n_reducer_retrains, mut._drift.violation_rate)
        t0 = time.perf_counter()
        ext = mut.add(off)
        sync()
        t_retrain = time.perf_counter() - t0
        probe = np.concatenate([near, corpus[:256]])
        res = mut.search(probe, 10)
    want = np.concatenate([np.arange(n, n + 128), np.arange(256)])
    hits = int((res.indices[:, 0] == want).sum())
    check(quiet[0] == 0, f"drift: 128 rows near the corpus retrained "
                         f"(violation rate {quiet[1]})")
    check(mut.n_reducer_retrains == 1 and mut.n_rebuilds == 1
          and mut._inner.reducer.fingerprint() != fp0
          and mut._drift.observed == 0,
          f"drift: off-manifold rows did not retrain once: "
          f"{mut.mutation_stats()}")
    check(hits == len(probe), f"drift: {hits}/{len(probe)} self-queries at "
                              f"rank 1 after the retrain")
    log(f"phase 9: drift on Mut,RAE64,Flat,Rerank4 ({n}x256): 128 rows "
        f"near the corpus, violation rate {quiet[1]:.4f}, no retrain; 256 "
        f"rows off the manifold tripped it: add + retrain (1000 steps) + "
        f"rebuild {t_retrain:.2f} s, reducer retrains "
        f"{mut.n_reducer_retrains}, fingerprint changed; self-queries at "
        f"rank 1 after: {hits}/{len(probe)} (the 128 added and 256 corpus "
        f"rows); off-manifold ids {ext[0]}..{ext[-1]} [{card_label()}]")
    return {"t_retrain": t_retrain}


def phase9(device: str) -> dict:
    """Every part of phase 9; returns its kernels' launch counts."""
    launches = PathLaunches()
    t = {}
    for name, fn in (("table1", lambda: phase9_table1(device, launches)),
                     ("factory", lambda: phase9_factory(device, launches)),
                     ("mutation_1m",
                      lambda: phase9_mutation_1m(device, launches)),
                     ("graphs", lambda: phase9_graphs(device, launches))):
        t0 = time.perf_counter()
        fn()
        t[name] = time.perf_counter() - t0
        free_card()
    t0 = time.perf_counter()
    reducer = phase9_shared_rae(device)
    phase9_sharded(device, launches, reducer)
    phase9_drift(device, launches, reducer)
    t["sharded_drift"] = time.perf_counter() - t0
    log(f"phase 9: main-path launches {launches.total}; seconds by part "
        f"{ {k: round(v, 1) for k, v in t.items()} }")
    for k in ("rae_encode", "l2_topk", "graph_beam", "graph_beam_q",
              "topk_merge"):
        check(launches.total[k] > 0, f"phase 9: {k} never launched")
    return launches.total


# ---------------------------------------------------------------------------
# Phase 10: serving and self-tuning (repro_torch.serve, repro_torch.tune)
# ---------------------------------------------------------------------------
SERVE_SPECS_1M = ("RAE64,Flat,Rerank4", "RAE64,IVF256,Rerank4",
                  "RAE64,PQ8x8,Rerank4")
#: table8_autotune.run()'s default configuration (n, dim, RAE steps)
TUNE_N, TUNE_DIM, TUNE_STEPS = 20_000, 128, 600
TUNE_TARGETS = (0.95, 0.99)
#: scripts/check_bench.py's autotune bars: recall slack, escalation ceiling
TUNE_SLACK, ESCALATION_CEIL = 0.01, 0.95


def same_answer(a, b, row: int = 0) -> bool:
    """``a`` (a one-row result) equals row ``row`` of ``b``: ids, score
    bits."""
    return (np.array_equal(a.indices[0], b.indices[row])
            and a.scores[0].tobytes() == b.scores[row].tobytes())


def client_storm(engine, queries: np.ndarray, n_clients: int, k: int = 10
                 ) -> tuple[list, float]:
    """``n_clients`` threads send ``queries`` through ``search_one``, each
    its share in turn (query j from client j mod n_clients); the answers
    in query order and the wall seconds from the first send to the last
    answer."""
    import threading

    out = [None] * len(queries)
    start = threading.Barrier(n_clients + 1)

    def client(c):
        start.wait()
        for j in range(c, len(queries), n_clients):
            out[j] = engine.search_one(queries[j], k)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client hung")
    return out, time.perf_counter() - t0


def phase10_engine_1m(device: str, launches: PathLaunches,
                      n: int = 1_000_003, nq: int = 1024, steps: int = 3000
                      ) -> dict:
    """(a) ``SearchEngine(max_batch=32, max_wait_ms=2, cache_size=1024)``
    over the Flat, IVF256 and PQ8x8 stacks on phase 5's 1,000,003 x 768
    corpus and fit (no cut), warmed at k = 10: 64 client threads send the
    1,024 held-out queries (16 each) inside ``no_retrace(budget=0)``;
    every answer equal, ids and score bits, to the stack's search of the
    query alone (that sequential q=1 loop's QPS printed beside the
    engine's); then 256 of them again, each a cache hit equal to its first
    answer. (d) HTTP on loopback over the IVF256 engine."""
    from repro_torch import api
    from repro_torch.analysis.runtime import no_retrace
    from repro_torch.serve import SearchEngine

    corpus, queries, _ = full_data(n, nq)
    reducer, _ = fitted_rae(n, nq, steps, device)
    out, n_rep = {}, min(256, nq)
    for spec in SERVE_SPECS_1M:
        idx = api.index_factory(spec, device=device)
        idx.reducer = reducer               # phase 5's fit, shared
        with launches.main():
            idx.build(corpus)
            sync()
            t0 = time.perf_counter()
            lone = [idx.search(queries[i:i + 1], 10) for i in range(nq)]
            t_seq = time.perf_counter() - t0
            eng = SearchEngine(idx, max_batch=32, max_wait_ms=2.0,
                               cache_size=1024).start()
            t0 = time.perf_counter()
            eng.warmup(ks=(10,))
            t_warm = time.perf_counter() - t0
            with no_retrace(budget=0, what=f"{spec}: storm") as used:
                got, wall = client_storm(eng, queries, 64)
                cold = used()
            st = eng.stats()
            hits0 = eng.cache.hits
            again, wall2 = client_storm(eng, queries[:n_rep], 64)
            st2 = eng.stats()
        bad = sum(not same_answer(g, lo) for g, lo in zip(got, lone))
        check(bad == 0, f"{spec}: {bad}/{nq} coalesced answers differ from "
                        f"the query's lone answer (ids or score bits)")
        coalesced = sum(int(b) * c for b, c in st["batch_size_hist"].items())
        check(st["requests"] == nq and coalesced == nq,
              f"{spec}: {st['requests']} requests, histogram "
              f"{st['batch_size_hist']}")
        check(st["batches"] < nq, f"{spec}: {st['batches']} batches for "
                                  f"{nq} requests: nothing coalesced")
        check(cold == 0, f"{spec}: the storm paid {cold} cold-path events")
        hit_rate = (eng.cache.hits - hits0) / n_rep
        same2 = sum(same_answer(a, g) for a, g in zip(again, got))
        check(same2 == n_rep, f"{spec}: {n_rep - same2}/{n_rep} repeats "
                              f"differ from their first answer")
        check(hit_rate == 1.0, f"{spec}: repeat hit rate {hit_rate}")
        log(f"phase 10: {spec} on imdb_like {n}x768 (phase 5's fit) "
            f"[{card_label()}]: engine max_batch 32, max_wait 2 ms, warm-up "
            f"{t_warm:.2f} s; 64 clients x {nq // 64} queries: QPS "
            f"{nq / wall:.1f}, latency p50 {st['latency_ms']['p50']} ms, "
            f"p99 {st['latency_ms']['p99']} ms, {st['batches']} batches "
            f"(mean {st['batch_size_mean']}), batch sizes "
            f"{st['batch_size_hist']}, buckets {st['bucket_hist']}; "
            f"sequential q=1 loop QPS {nq / t_seq:.1f}; coalesced == alone "
            f"(ids, score bits): {nq - bad}/{nq}; cold-path events in the "
            f"storm {cold}; {n_rep} repeats: hit rate {hit_rate:.4f}, QPS "
            f"{n_rep / wall2:.1f}, equal to the first answers "
            f"{same2}/{n_rep}; "
            f"cache {st2['cache']}")
        out[spec] = {"qps": nq / wall, "seq_qps": nq / t_seq,
                     "p50": st["latency_ms"]["p50"],
                     "p99": st["latency_ms"]["p99"],
                     "batches": st["batches"], "hit_rate": hit_rate}
        if "IVF" in spec:
            eng.cache.clear()      # HTTP requests reach the index again
            with launches.main():
                phase10_http(eng, queries, lone)
        eng.stop()
        del idx, eng, lone, got, again
        free_card()
    return out


def phase10_http(eng, queries: np.ndarray, lone: list) -> None:
    """(d) ``start_http_server(engine, port=0)`` on loopback: 256 ``POST
    /search`` single queries from 32 threads, each the engine's answer;
    ``/stats`` and ``/healthz`` 200; a NaN query and a wrong-dim query
    400, the cache not grown by them."""
    import threading
    import urllib.error
    import urllib.request

    from repro_torch.serve import start_http_server

    server, _ = start_http_server(eng, port=0)
    port = server.server_address[1]
    url = f"http://127.0.0.1:{port}"

    def post(payload):
        req = urllib.request.Request(
            url + "/search", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, json.loads(r.read())

    try:
        n, replies = min(256, len(queries)), {}
        start = threading.Barrier(32)

        def client(c):
            start.wait()
            for j in range(c, n, 32):
                replies[j] = post({"query": queries[j].tolist(), "k": 10})

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(32)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "an HTTP client hung")
        wall = time.perf_counter() - t0
        ok = 0
        for j in range(n):
            status, body = replies.get(j, (None, {}))
            ok += int(status == 200
                      and body["indices"] == lone[j].indices[0].tolist()
                      and np.array_equal(np.asarray(body["scores"],
                                                    np.float32),
                                         lone[j].scores[0]))
        check(ok == n, f"HTTP: {n - ok}/{n} replies not the engine's answer")
        s_stats, stats = get("/stats")
        s_health, health = get("/healthz")
        check(s_stats == 200 and s_health == 200
              and health["status"] == "ok",
              f"HTTP: /stats {s_stats}, /healthz {s_health} {health}")
        size0 = eng.cache.stats()["size"]
        nan_q = queries[0].astype(float).tolist()
        nan_q[3] = float("nan")
        s_nan, b_nan = post({"query": nan_q, "k": 10})
        s_dim, b_dim = post({"query": queries[0][:-1].tolist(), "k": 10})
        size1 = eng.cache.stats()["size"]
        check(s_nan == 400 and s_dim == 400,
              f"HTTP: NaN query {s_nan} {b_nan}, wrong dim {s_dim} {b_dim}")
        check(size1 == size0, f"HTTP: the cache grew {size0} -> {size1} "
                              f"from refused requests")
        log(f"phase 10: HTTP on loopback over the IVF256 engine: {n} POST "
            f"/search from 32 threads in {wall:.2f} s ({n / wall:.1f} "
            f"requests/s), equal to the engine's answers {ok}/{n}; /stats "
            f"{s_stats} ({stats['requests']} requests, {stats['batches']} "
            f"batches), /healthz {s_health}; NaN query {s_nan} "
            f"({b_nan['error']!r}), wrong dim {s_dim} ({b_dim['error']!r}); "
            f"cache size {size0} -> {size1}")
    finally:
        server.shutdown()
        server.server_close()


def phase10_mutation(device: str, launches: PathLaunches,
                     n: int = 1_000_003, nq: int = 1024, steps: int = 3000
                     ) -> dict:
    """(b) ``engine.mutate`` on ``Mut,RAE64,Flat,Rerank4`` (phase 5's fit)
    while 32 clients run: 1,000 seeded deletes, none surfacing after; a
    2,500-row add of held-out rows, each found as itself; the cached
    pre-mutation answers retired. Then ``hot_swap`` from the Flat stack to
    the IVF256 stack under 32 clients: nothing dropped, every reply one of
    the two stacks' lone answers, one swap counted; the batches served
    during the swap's build, printed."""
    import threading

    from repro_torch import api
    from repro_torch.serve import SearchEngine

    corpus, queries, _ = full_data(n, nq)
    reducer, _ = fitted_rae(n, nq, steps, device)
    extra = holdout_rows(n, nq)[:2500]
    rng = np.random.default_rng(10)
    dead = np.sort(rng.choice(n, 1000, replace=False)).astype(np.int64)
    probe = queries[:min(256, nq // 2)]       # what the clients send
    kept = queries[nq // 2:nq // 2 + 32]      # cached before the delete

    def load(eng, stop, log_):
        """A client: the probe queries in turn until ``stop``; each
        answer with its send and reply times."""
        j = 0
        while not stop.is_set():
            t_send = time.perf_counter()
            r = eng.search_one(probe[j % len(probe)], 10)
            log_.append((t_send, time.perf_counter(), j % len(probe), r))
            j += 1

    def run_clients(eng, body, n_clients=32):
        stop, logs = threading.Event(), [[] for _ in range(n_clients)]
        threads = [threading.Thread(target=load, args=(eng, stop, logs[c]))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        try:
            result = body()
        finally:
            time.sleep(0.2)
            stop.set()
            for t in threads:
                t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "a client hung")
        return result, [x for lg in logs for x in lg]

    mut = api.index_factory("Mut,RAE64,Flat,Rerank4", device=device)
    mut._inner.reducer = reducer
    with launches.main():
        mut.build(corpus)
        eng = SearchEngine(mut, max_batch=32, max_wait_ms=2.0,
                           cache_size=1024).start().warmup(ks=(10,))
        for q in kept:
            eng.search_one(q, 10)
        hits0 = eng.cache.hits
        for q in kept:
            eng.search_one(q, 10)
        hits_kept = eng.cache.hits - hits0

        def deletes():
            t0 = time.perf_counter()
            out = eng.mutate(lambda ix: ix.delete(dead))
            return out, time.perf_counter(), time.perf_counter() - t0

        (n_del, t_deleted, dt_del), log_del = run_clients(eng, deletes)
        hits1 = eng.cache.hits
        after = [eng.search_one(q, 10) for q in kept]
        hits2 = eng.cache.hits
        self_dead = eng.search(corpus[dead[:256]], 10)

        def adds():
            t0 = time.perf_counter()
            ids = eng.mutate(lambda ix: ix.add(extra))
            return ids, time.perf_counter() - t0

        (ext, dt_add), log_add = run_clients(eng, adds)
        found, _ = client_storm(eng, extra, 32)
        st = eng.stats()
        eng.stop()
        # what every mutation makes the engine pay: the content hash
        t0 = time.perf_counter()
        mut.fingerprint()
        t_fp = time.perf_counter() - t0
    check(n_del == len(dead), f"mutate: delete tombstoned {n_del}")
    check(hits_kept == 32, f"mutate: the 32 repeats before the delete hit "
                           f"{hits_kept} times")
    check(hits2 == hits1, f"mutate: {hits2 - hits1} pre-mutation answers "
                          f"replayed after the delete")
    surfaced = sum(int(np.isin(r.indices, dead).sum()) for t_send, _, _, r
                   in log_del + log_add if t_send > t_deleted)
    surfaced += int(np.isin(self_dead.indices, dead).sum())
    surfaced += sum(int(np.isin(r.indices, dead).sum()) for r in after)
    check(surfaced == 0, f"mutate: {surfaced} deleted ids surfaced")
    check(np.array_equal(ext, np.arange(n, n + len(extra))),
          f"mutate: add returned {ext[:3]}...")
    hits = sum(int(r.indices[0, 0] == n + i) for i, r in enumerate(found))
    check(hits == len(extra), f"mutate: {hits}/{len(extra)} added rows "
                              f"found as themselves at rank 1")
    check(st["mutation"]["mutations"] == 2
          and st["mutation"]["index"]["deleted"] == len(dead),
          f"mutate: stats {st['mutation']}")
    log(f"phase 10: mutate under 32 clients on Mut,RAE64,Flat,Rerank4 "
        f"({n}x768, phase 5's fit) [{card_label()}]: delete {len(dead)} ids "
        f"{dt_del * 1e3:.1f} ms (cached pre-mutation answers retired: "
        f"{hits2 - hits1} replayed of 32), {len(log_del)} requests served "
        f"meanwhile; add {len(extra)} rows {dt_add:.2f} s, "
        f"{len(log_add)} requests served meanwhile; deleted ids surfaced "
        f"after the delete {surfaced}; added rows found as themselves "
        f"{hits}/{len(extra)}; one fingerprint {t_fp:.2f} s (the engine "
        f"re-reads it after each mutation and swap); {st['mutation']}")
    del mut, eng
    free_card()

    flat = api.index_factory("RAE64,Flat,Rerank4", device=device)
    flat.reducer = reducer
    ivf_box = {}

    def build_ivf():
        ivf = api.index_factory("RAE64,IVF256,Rerank4", device=device)
        ivf.reducer = reducer
        ivf_box["t0"] = time.perf_counter()
        ivf.build(corpus)
        sync()
        ivf_box["t1"] = time.perf_counter()
        return ivf

    with launches.main():
        flat.build(corpus)
        lone_flat = [flat.search(probe[i:i + 1], 10)
                     for i in range(len(probe))]
        eng = SearchEngine(flat, max_batch=32, max_wait_ms=2.0,
                           cache_size=0).start().warmup(ks=(10,))
        promoted, log_swap = run_clients(
            eng, lambda: eng.hot_swap(build_ivf, ks=(10,)))
        lone_ivf = [promoted.search(probe[i:i + 1], 10)
                    for i in range(len(probe))]
        st = eng.stats()
        eng.stop()
    n_sent = len(log_swap)
    torn = sum(not (same_answer(r, lone_flat[j])
                    or same_answer(r, lone_ivf[j]))
               for _, _, j, r in log_swap)
    dropped = sum(r is None for _, _, _, r in log_swap)
    check(dropped == 0 and st["requests"] == n_sent,
          f"hot_swap: {dropped} dropped, {st['requests']} of {n_sent} served")
    check(torn == 0, f"hot_swap: {torn}/{n_sent} replies are neither "
                     f"stack's lone answer")
    check(st["mutation"]["swaps"] == 1, f"hot_swap: {st['mutation']}")
    during = [t1 - t0 for t0, t1, _, _ in log_swap
              if ivf_box["t0"] <= t0 <= ivf_box["t1"]]
    outside = [t1 - t0 for t0, t1, _, _ in log_swap
               if not ivf_box["t0"] <= t0 <= ivf_box["t1"]]
    log(f"phase 10: hot_swap Flat -> IVF256 under 32 clients: {n_sent} "
        f"requests, dropped {dropped}, each one of the two stacks' lone "
        f"answers: {n_sent - torn}/{n_sent}; swaps "
        f"{st['mutation']['swaps']}; the IVF256 build on the caller's "
        f"thread {ivf_box['t1'] - ivf_box['t0']:.2f} s: request latency "
        f"during it {spread(during) if during else 'no request'}, outside "
        f"it {spread(outside)}")
    del flat, promoted, eng
    free_card()
    return {"torn": torn, "sent": n_sent}


def tune_data(n: int, device: str) -> dict:
    """``table8_autotune.run()``'s data at ``n`` rows: the corpus, 256 tune
    and 512 holdout queries (disjoint), and their exact top-10."""
    from repro_torch import api
    from repro_torch.data import synthetic

    corpus = synthetic.embedding_corpus(n, TUNE_DIM, n_clusters=64,
                                        intrinsic=32, seed=0)
    rng = np.random.default_rng(1)
    pick = rng.choice(n, 256 + 512, replace=False)
    qs = corpus[pick] + 0.05 * rng.standard_normal(
        (768, TUNE_DIM)).astype(np.float32)
    exact = api.FlatIndex(device=device).build(corpus)
    return {"corpus": corpus, "tune_q": qs[:256], "hold_q": qs[256:],
            "tune_gt": exact.search(qs[:256], 10).indices,
            "hold_gt": exact.search(qs[256:], 10).indices}


def phase10_tuned(device: str, launches: PathLaunches, n: int = TUNE_N
                  ) -> dict:
    """(c) The self-tuned engine at ``table8_autotune.run()``'s defaults:
    RAE64 (600 steps) under ``RAE64,IVF256,Rerank4`` and
    ``RAE64,HNSW32,Rerank4`` (``batched=True``); ``sweep`` on the 256 tune
    queries, then the 512 holdout queries through ``SearchEngine(
    target_recall=..., curve=..., escalation=EscalationPolicy(3, 0.02,
    recall_slack=0.01))`` in batches of 32 for targets 0.95 and 0.99,
    held to ``scripts/check_bench.py``'s autotune bars; every escalated
    row alone equal, bit for bit, to the same row in its batch. The graph
    with an SQ8 payload (``RAE64,HNSW32,SQ8,Rerank4``, over a copy of the
    same graph) serves the holdout through 64 clients, each answer its
    lone one."""
    from repro_torch import api
    from repro_torch.analysis.runtime import no_retrace
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.search import hnsw
    from repro_torch.serve import SearchEngine
    from repro_torch.tune import EscalationPolicy, sweep

    t0 = time.perf_counter()
    d = tune_data(n, device)
    reducer = api.make_reducer("rae", 64, steps=TUNE_STEPS, seed=0,
                               device=device)
    reducer.fit(d["corpus"])
    sync()
    t_fit = time.perf_counter() - t0
    hold_q, hold_gt = d["hold_q"], d["hold_gt"]
    esc = EscalationPolicy(delta=3, threshold=0.02, recall_slack=TUNE_SLACK)
    stacks = (("RAE64,IVF256,Rerank4", lambda: api.IVFFlatIndex(
                  n_cells=256, device=device)),
              ("RAE64,HNSW32,Rerank4", lambda: api.HNSWIndex(
                  m=32, batched=True, device=device)))
    out, graph = {}, None
    for spec, make_base in stacks:
        index = api.TwoStageIndex(reducer, make_base(), rerank_factor=4,
                                  device=device)
        with launches.main():
            t0 = time.perf_counter()
            index.build(d["corpus"])
            sync()
            t_build = time.perf_counter() - t0
            index.search(hold_q[:32], 10)
            dres = index.search(hold_q, 10)
            t0 = time.perf_counter()
            curve = sweep(index, d["tune_q"], d["tune_gt"], 10)
            t_sweep = time.perf_counter() - t0
        d_recall = recall_at_k(dres.indices, hold_gt)
        d_evals = dres.stats["distance_evals"]
        for target in TUNE_TARGETS:
            eng = SearchEngine(index, max_batch=32, cache_size=0,
                               target_recall=target, curve=curve,
                               escalation=esc)
            with launches.main():
                eng.warmup(ks=(10,))
                got, evals = [], 0.0
                t0 = time.perf_counter()
                with no_retrace(budget=0, what=f"{spec} tuned") as used:
                    for s in range(0, len(hold_q), 32):
                        r = eng.search(hold_q[s:s + 32], 10)
                        got.append(r.indices)
                        evals += r.stats["distance_evals"] * len(r.indices)
                    cold = used()
                wall = time.perf_counter() - t0
                snap = eng.metrics.snapshot()
                # escalated rows alone against the same rows in a batch
                n_esc = n_same = 0
                for s in range(0, len(hold_q), 32):
                    chunk = hold_q[s:s + 32]
                    res, mask = eng._escalated_search(chunk, 10)
                    for i in np.flatnonzero(mask):
                        solo, smask = eng._escalated_search(chunk[i:i + 1],
                                                            10)
                        n_esc += 1
                        n_same += int(bool(smask[0])
                                      and same_answer(solo, res, i))
            recall = recall_at_k(np.concatenate(got), hold_gt)
            rate = snap.get("escalation_rate", 0.0)
            ratio = (evals / len(hold_q)) / max(d_evals, 1e-9)
            params = eng.stats()["operating_point"]
            check(recall >= target - TUNE_SLACK,
                  f"{spec} slo {target}: holdout recall {recall:.4f}")
            check(0.0 < rate < ESCALATION_CEIL,
                  f"{spec} slo {target}: escalation rate {rate}")
            check(n_same == n_esc, f"{spec} slo {target}: {n_esc - n_same}"
                                   f"/{n_esc} escalated rows differ alone")
            check(cold == 0, f"{spec} slo {target}: {cold} cold-path events")
            log(f"phase 10: tuned {spec} on {n}x{TUNE_DIM} [{card_label()}]"
                f": fit {t_fit:.2f} s, build {t_build:.2f} s, sweep "
                f"{t_sweep:.2f} s ({len(curve.points)} Pareto points of "
                f"{[p.params.to_dict() for p in curve.points]}); defaults "
                f"recall@10 {d_recall:.4f}, evals {d_evals:.1f}; slo "
                f"{target}: holdout recall@10 {recall:.4f} (bar "
                f"{target - TUNE_SLACK:.2f}), evals {evals / len(hold_q):.1f}"
                f" (tuned / default {ratio:.4f}), escalation rate {rate} "
                f"(bar (0, {ESCALATION_CEIL})), escalated rows alone == in "
                f"batch {n_same}/{n_esc}, QPS {len(hold_q) / wall:.1f}, "
                f"cold-path events {cold}, point {params}")
            out[(spec, target)] = {"recall": recall, "rate": rate,
                                   "ratio": ratio}
        if "HNSW" in spec:
            graph = index
    # the SQ8 payload over a copy of the same graph
    sq8 = api.index_factory("RAE64,HNSW32,SQ8,Rerank4", device=device)
    base, g = sq8.base, graph.base._g
    base._g = hnsw.HNSWGraph(vecs=g.vecs.copy(), levels=g.levels.copy(),
                             links0=g.links0.copy(), links=g.links.copy(),
                             entry=g.entry, M=g.M)
    with launches.main():
        base._g.codec = hnsw.make_graph_codes(
            base._g.vecs, base.quant, m=base.pq_m, bits=base.pq_bits,
            iters=base.kmeans_iters, seed=base.seed, device=device)
        base._upload()
        sq8.reducer, sq8._db_full = reducer, graph._db_full
        lone = [sq8.search(hold_q[i:i + 1], 10) for i in range(len(hold_q))]
        eng = SearchEngine(sq8, max_batch=32, max_wait_ms=2.0,
                           cache_size=0).start().warmup(ks=(10,))
        got, wall = client_storm(eng, hold_q, 64)
        st = eng.stats()
        eng.stop()
    bad = sum(not same_answer(a, b) for a, b in zip(got, lone))
    recall = recall_at_k(np.concatenate([r.indices for r in got]), hold_gt)
    check(bad == 0, f"RAE64,HNSW32,SQ8,Rerank4: {bad}/{len(hold_q)} "
                    f"coalesced answers differ from the lone answers")
    check(st["batches"] < len(hold_q), f"SQ8 graph: nothing coalesced")
    log(f"phase 10: RAE64,HNSW32,SQ8,Rerank4 over the same graph: 64 "
        f"clients x 8 holdout queries, QPS {len(hold_q) / wall:.1f}, p50 "
        f"{st['latency_ms']['p50']} ms, p99 {st['latency_ms']['p99']} ms, "
        f"{st['batches']} batches; coalesced == alone "
        f"{len(hold_q) - bad}/{len(hold_q)}; recall@10 {recall:.4f}")
    return out


def phase10_launcher(n: int = 20_000) -> None:
    """(e) ``python -m repro_torch.launch.serve --n 20000 --dim 256
    --index-spec RAE64,IVF256,Rerank4`` as a subprocess: exit 0, its
    recall and latency line."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--n", str(n),
         "--dim", "256", "--index-spec", "RAE64,IVF256,Rerank4"],
        capture_output=True, text=True, env=env, timeout=600)
    dt = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    result = [ln for ln in lines if ln.startswith("[5/5]")]
    check(proc.returncode == 0 and bool(result),
          f"launcher exit {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"phase 10: python -m repro_torch.launch.serve --n {n} --dim 256 "
        f"--index-spec RAE64,IVF256,Rerank4: exit {proc.returncode} in "
        f"{dt:.1f} s: {result[0]} | {lines[-1].strip()}")


def phase10(device: str) -> dict:
    """Every part of phase 10; returns its kernels' launch counts."""
    launches = PathLaunches()
    t = {}
    for name, fn in (("engine_1m", lambda: phase10_engine_1m(device,
                                                             launches)),
                     ("mutation", lambda: phase10_mutation(device,
                                                           launches)),
                     ("tuned", lambda: phase10_tuned(device, launches)),
                     ("launcher", phase10_launcher)):
        t0 = time.perf_counter()
        fn()
        t[name] = time.perf_counter() - t0
        free_card()
    log(f"phase 10: main-path launches {launches.total}; seconds by part "
        f"{ {k: round(v, 1) for k, v in t.items()} }")
    for k in ("rae_encode", "l2_topk", "graph_beam", "graph_beam_q",
              "pq_adc"):
        check(launches.total[k] > 0, f"phase 10: {k} never launched")
    return launches.total


# ---------------------------------------------------------------------------
# Phase 11: training of llama3.2-1b and two-tower-retrieval
# ---------------------------------------------------------------------------
#: llama3.2-1b train_4k's batch, cut from 256 (PERF.md section 4): B = 2
#: peaked at 34.98 GB on the card, so 4 fits
LLAMA_TRAIN_BATCH = 4
#: two-tower train_batch: each table's rows cut to a quarter
TABLE_CUT = 4
TRAIN_BATCH_TT = 65_536


def grads_of(loss_fn, params, *args):
    """(loss, {path: grad}) of ``loss_fn(params, *args)`` under autograd."""
    from repro_torch.models.common import value_and_grad
    from repro_torch.pytree import flatten_with_path

    (loss, _), grads = value_and_grad(loss_fn, params, *args)
    return loss, dict(flatten_with_path(grads))


def same_grads(a: dict, b: dict) -> tuple[bool, list]:
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    return not bad, bad


def train_counters():
    from repro_torch.kernels.embedding_bag.kernel import (
        embedding_bag_bwd_cuda, embedding_bag_cuda)

    return {"embedding_bag": embedding_bag_cuda,
            "embedding_bag_bwd": embedding_bag_bwd_cuda}


def traced_step(fn):
    """``fn()`` under ``torch.profiler``: (its result, the card's busy ms in
    it, the kernel and copy intervals merged). Logs the six kernels that
    took the most card time in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = busy_us(events) * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("  card time by kernel: " + "; ".join(
        f"{name[:70]} {us * 1e-3:.1f} ms ({us * 1e-3 / busy:.3f})"
        for name, us in top))
    return out, busy


def train_steps(cell, state: dict, batch, n: int):
    """``n`` steps of the train cell on one batch, the main path, from
    ``state`` (``params``, ``opt_state``), which it replaces step by step
    (so the caller holds no other reference to the old state). The first
    step, the warm-up, runs under ``torch.profiler`` (the card's busy time)
    and the sync debug mode "error"; the others are timed on the host
    clock after a sync. Returns (losses, seconds of the timed steps, the
    traced step's busy ms, the last metrics)."""
    losses, lat, busy = [], [], 0.0

    def step():
        state["params"], state["opt_state"], m = cell.fn(
            state["params"], state["opt_state"], batch)
        return m

    for i in range(n):
        t0 = time.perf_counter()
        if i == 0:
            m, busy = traced_step(lambda: no_host_sync(step))
        else:
            m = step()
        sync()
        if i:
            lat.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return losses, lat, busy, m


def phase11_llama(device: str) -> dict:
    """(a) llama3.2-1b train_4k at its published widths (16 x 2048, 32 / 8
    heads, d_ff 8192, vocab 128,256; float32 master weights, bfloat16
    compute and moments, per-layer remat) with the batch cut to
    ``LLAMA_TRAIN_BATCH`` x 4096 tokens, through ``build_cell``: the
    gradients with the kernels equal the plain path's bit for bit (the
    embedding's backward is the only kernel here), 4 steps (a warm-up, 3
    timed), finite losses, no host sync in a step, peak memory beside the
    reckoning, the card's idle share."""
    from repro_torch.configs import get_shapes
    from repro_torch.launch.train import reckon_bytes
    from repro_torch.models.registry import build_cell
    from repro_torch.models.transformer import model as tm

    free_card()
    train = [c for c in get_shapes(LLAMA) if c.kind == "train"][0]
    cell = build_cell(LLAMA, train.replace(global_batch=LLAMA_TRAIN_BATCH),
                      device)
    cfg = cell.cfg
    b, s = cell.cell.global_batch, cell.cell.seq_len
    need = reckon_bytes(cfg, "lm", cell.cell)
    t0 = time.perf_counter()
    params = cell.init(0)
    opt_state = cell.init_opt(params)
    (batch,) = cell.make_inputs(0)
    sync()
    log(f"phase 11 (a): {LLAMA} train_4k cut to B={b} (from "
        f"{train.global_batch}) x S={s}: {cfg.n_layers} x {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}, moments {cfg.moment_dtype}, remat "
        f"{cfg.remat}; weights, moments and batch ready in "
        f"{time.perf_counter() - t0:.2f} s; reckoned peak "
        f"{need['peak'] / 1e9:.2f} GB")
    counters = train_counters()
    for c in counters.values():
        c.launches = 0
    loss_k, g_k = grads_of(tm.loss_fn, params, batch, cfg)
    sync()
    bwd_grad = counters["embedding_bag_bwd"].launches
    with plain_kernels():
        loss_p, g_p = grads_of(tm.loss_fn, params, batch, cfg)
    same, bad = same_grads(g_k, g_p)
    log(f"phase 11 (a): loss {float(loss_k):.6f} (plain path "
        f"{float(loss_p):.6f}); grads with the kernels == plain path, bit "
        f"for bit: {same} ({len(g_k)} leaves; embedding_bag_bwd launched "
        f"{bwd_grad} in the gradient)")
    check(same and bool(torch.equal(loss_k, loss_p)),
          f"llama grads: kernel path != plain path at {bad[:4]}")
    del g_k, g_p
    free_card()

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    # the main path: a warm-up, 3 timed
    state = {"params": params, "opt_state": opt_state}
    del params, opt_state
    losses, lat, dev, m = train_steps(cell, state, batch, 4)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"llama losses not finite: {losses}")
    check(launches["embedding_bag_bwd"] == 4,
          f"llama: embedding_bag_bwd launched {launches} in 4 steps")
    med = float(np.median(lat)) * 1e3
    log(f"phase 11 (a): 4 steps, losses {[round(x, 5) for x in losses]} "
        f"(lr {float(m['lr']):.3e}: warmup), step {spread(lat)} after a "
        f"warm-up, {b * s / med * 1e3:.0f} tokens/s; no host sync in a step "
        f"(sync debug mode \"error\"); peak memory {peak:.2f} GB (reckoned "
        f"{need['peak'] / 1e9:.2f}); the card busy {dev:.1f} ms in the "
        f"warm-up step (torch.profiler, kernels merged), idle "
        f"{1 - dev / med:.3f} of the median step; embedding_bag_bwd "
        f"launches a step {launches['embedding_bag_bwd'] / 4:.0f}")
    out = {"launches": launches, "step_ms": med, "peak_gb": peak,
           "tokens_s": b * s / med * 1e3, "idle": 1 - dev / med,
           "lookup": (b * s, cfg.d_model, tm.padded_vocab(cfg))}
    del state, batch, cell
    free_card()
    return out


def quarter_tables(cfg):
    import dataclasses

    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, vocab=t.vocab // TABLE_CUT)
        for t in cfg.tables))


def to_host(tree):
    from repro_torch.pytree import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def same_tree(a, b_host) -> tuple[bool, int]:
    """Leaves of ``a`` (on the card) equal to ``b_host``'s, bit for bit:
    (all equal, leaves compared)."""
    from repro_torch.pytree import flatten_with_path

    fa, fb = flatten_with_path(a), dict(flatten_with_path(b_host))
    ok = all(torch.equal(x.detach().cpu(), fb[p]) for p, x in fa)
    return ok, len(fa)


def phase11_two_tower(device: str) -> dict:
    """(b) two-tower train_batch at its published widths (embed 256, MLPs
    1024-512-256, history bags of 50), each table's rows cut to a quarter
    (float32 tables, dense gradients and float32 moments at full rows
    would be about 102 GB), B = 65,536 halved until a step fits: the
    gradients with the kernels equal the plain path's bit for bit, two
    steps from one state give the same bits (params and moments), the loss
    falls over 8 steps on one repeated batch; step time, examples/s, peak
    memory, idle share; and the backward kernel alone at the bag's shape."""
    from repro_torch.configs import get_arch, get_shapes
    from repro_torch.launch.train import reckon_bytes
    from repro_torch.models.recsys import two_tower as tt
    from repro_torch.models.registry import build_cell_with

    free_card()
    cfg = quarter_tables(get_arch(TWO_TOWER)[0])
    train = [c for c in get_shapes(TWO_TOWER) if c.kind == "train"][0]
    b = TRAIN_BATCH_TT
    cell = build_cell_with(cfg, "recsys", TWO_TOWER,
                           train.replace(global_batch=b), device)
    t0 = time.perf_counter()
    params = cell.init(0)
    opt_state = cell.init_opt(params)
    sync()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"phase 11 (b): {TWO_TOWER} train_batch, tables "
        + ", ".join(f"{t.name} {params['table_' + t.name].shape[0]}x{t.dim}"
                    for t in cfg.tables)
        + f" (rows cut to 1/{TABLE_CUT}), MLP {cfg.mlp_dims}: "
          f"{nbytes / 1e9:.3f} GB of float32 weights, as much again in "
          f"each moment; ready in {time.perf_counter() - t0:.2f} s")
    while True:                 # the largest batch whose step fits
        cell = build_cell_with(cfg, "recsys", TWO_TOWER,
                               train.replace(global_batch=b), device)
        (batch,) = cell.make_inputs(0)
        fits = True
        try:
            cell.fn(params, opt_state, batch)
            sync()
        except torch.OutOfMemoryError:
            fits = False
        free_card()
        if fits:
            break
        log(f"phase 11 (b): a step at B={b} runs out of memory; halving")
        b //= 2
        check(b >= 1024, "no two-tower batch fits")
    need = reckon_bytes(cfg, "recsys", cell.cell)
    counters = train_counters()
    for c in counters.values():
        c.launches = 0
    loss_k, g_k = grads_of(tt.loss_fn, params, batch, cfg)
    sync()
    bwd_grad = counters["embedding_bag_bwd"].launches
    with plain_kernels():
        loss_p, g_p = grads_of(tt.loss_fn, params, batch, cfg)
    same, bad = same_grads(g_k, g_p)
    log(f"phase 11 (b): B={b} (from {train.global_batch}); loss "
        f"{float(loss_k):.6f} (plain {float(loss_p):.6f}); grads with the "
        f"kernels == plain path, bit for bit: {same} ({len(g_k)} leaves; "
        f"embedding_bag_bwd launched {bwd_grad} in the gradient)")
    check(same and bool(torch.equal(loss_k, loss_p)),
          f"two-tower grads: kernel path != plain path at {bad[:4]}")
    del g_k, g_p
    free_card()

    # two steps from the same state: the same bits
    p1, s1, _ = cell.fn(params, opt_state, batch)
    first = to_host((p1, s1.m, s1.v))
    del p1, s1
    free_card()
    p2, s2, _ = cell.fn(params, opt_state, batch)
    det, n_leaves = same_tree((p2, s2.m, s2.v), first)
    del p2, s2, first
    free_card()
    log(f"phase 11 (b): two steps from one state give the same bits "
        f"(params and moments, {n_leaves} leaves): {det}")
    check(det, "two-tower: two steps from one state differ")

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    # the main path: 8 steps on one batch
    state = {"params": params, "opt_state": opt_state}
    del params, opt_state
    losses, lat, dev, _ = train_steps(cell, state, batch, 8)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"two-tower losses over 8 steps: {losses}")
    check(launches == {"embedding_bag": 8, "embedding_bag_bwd": 24},
          f"two-tower: launches {launches} in 8 steps")
    med = float(np.median(lat)) * 1e3
    log(f"phase 11 (b): 8 steps on one batch, losses "
        f"{[round(x, 5) for x in losses]}; step {spread(lat)} after a "
        f"warm-up, {b / med * 1e3:.0f} examples/s; no host sync in a step; "
        f"peak memory {peak:.2f} GB (reckoned {need['peak'] / 1e9:.2f}); "
        f"the card busy {dev:.2f} ms in the warm-up step (torch.profiler), "
        f"idle {1 - dev / med:.3f} of the median step; launches a step: "
        f"embedding_bag 1, embedding_bag_bwd 3")
    entry = embedding_bag_bwd_time(state["params"]["table_hist_item"],
                                   batch)
    out = {"launches": launches, "step_ms": med, "peak_gb": peak,
           "batch": b, "examples_s": b / med * 1e3, "idle": 1 - dev / med,
           "entry": entry}
    del state, batch, cell
    free_card()
    return out


def embedding_bag_bwd_time(table: torch.Tensor, batch: dict) -> dict:
    """The backward kernel at the two-tower train step's history bag (B
    bags of L = 50, the hist_item table's rows, d = 256, mean): the kernel
    alone (the slots sorted and the output zeroed beforehand), the whole
    wrapper (zero fill, sort, kernel), its plain version, and the library's
    gradient of ``F.embedding_bag`` over the same live ids with offsets
    (autograd's backward alone), beside the bound: the grad rows, ids and
    lengths read once, each touched row written once (bytes); the zero fill
    of [V, d] counted apart."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.embedding_bag.ref import (embedding_bag_bwd_ref,
                                                       sorted_slots)

    ids, lens = batch["hist"], batch["hist_len"]
    v, d = table.shape
    b, l = ids.shape
    grad = torch.randn(b, d, device=table.device,
                       generator=torch.Generator("cuda").manual_seed(11))
    keys, slots = sorted_slots(ids, lens, v)
    out = torch.zeros((v, d), device=table.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = bag_kernel._lib()

    def kernel_alone():
        check(lib.embedding_bag_bwd_launch(
            grad.data_ptr(), lens.data_ptr(), keys.data_ptr(),
            slots.data_ptr(), out.data_ptr(), b * l, l, v, d, 1,
            stream) == 0, "embedding_bag_bwd launch failed")

    kernel_alone()
    check(torch.equal(out, bag_kernel.embedding_bag_bwd_cuda(
        grad, ids, lens, "mean", v)), "kernel alone != wrapper")
    live = torch.arange(l, device=ids.device)[None, :] < lens[:, None]
    flat = ids.clamp(0, v - 1)[live].long()
    offsets = torch.cumsum(lens.long(), 0) - lens.long()
    tbl = table.detach().requires_grad_(True)
    fwd = F.embedding_bag(flat, tbl, offsets, mode="mean")

    def library():
        return torch.autograd.grad(fwd, tbl, grad, retain_graph=True)[0]

    lib_err, _ = max_rel_err(library(), out)
    check(lib_err <= 1e-5 * max(1.0, float(out.abs().max())),
          f"F.embedding_bag's gradient is another function (err {lib_err})")
    ms, held_k = device_ms(kernel_alone, reps=20)
    wrapper, held_w = device_ms(lambda: bag_kernel.embedding_bag_bwd_cuda(
        grad, ids, lens, "mean", v), reps=10)
    plain, held_p = device_ms(lambda: embedding_bag_bwd_ref(
        grad, ids, lens, "mean", v), reps=3)
    lib_ms, held_l = device_ms(library, reps=10)
    zero_ms, _ = device_ms(lambda: torch.zeros((v, d), device=table.device),
                           reps=10)
    n_live = int(live.sum())
    touched = int(torch.unique(keys[:n_live]).numel())
    b_ms, b_by = bound(4.0 * b * d + 4.0 * b * l + 4.0 * b
                       + 4.0 * touched * d, float(n_live * d * 2))
    fill_ms, _ = bound(4.0 * v * d, 0.0)
    log(f"phase 11 (b): embedding_bag_bwd B={b} L={l} d={d} over {v} rows, "
        f"{n_live} live slots, {touched} rows touched (device time, card "
        f"held busy while enqueuing: {held_k}, {held_w}, {held_p}, "
        f"{held_l}): kernel {ms:.4f} ms, wrapper (zero fill + sort + "
        f"kernel) {wrapper:.4f} ms, zero fill alone {zero_ms:.4f} ms, plain "
        f"{plain:.4f} ms, F.embedding_bag's backward {lib_ms:.4f} ms (|diff| "
        f"{lib_err:.2e}); bound {b_ms:.4f} ms ({b_by}), the zero fill's "
        f"{fill_ms:.4f} ms apart")
    del out, tbl, fwd
    return {"name": "embedding_bag_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:44",
            "replaces_note": "no Pallas kernel: the gradient of the bag, "
                             "XLA's scatter-add in the reference",
            "ms": ms, "wrapper_ms": wrapper, "zero_fill_ms": zero_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "zero_fill_bound_ms": fill_ms, "library_ms": lib_ms}


def phase11_launcher(device: str, steps: int = 60, save_every: int = 20,
                     fail_at: int = 45) -> None:
    """(c) ``python -m repro_torch.launch.train --scale smoke`` for both
    archs as subprocesses on the card: an uninterrupted run of ``steps``
    steps, a run crashed at ``fail_at`` (the supervisor's injected
    failure), and its resumption from the last checkpoint; the resumed
    run's final checkpoint equals the uninterrupted run's, file for
    file."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    # four runs share the host's cores at once: one compute thread each
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def start(arch: str, ckdir: str, fail: bool):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--scale", "smoke", "--steps", str(steps),
               "--save-every", str(save_every), "--checkpoint-dir", ckdir,
               "--device", device]
        if fail:
            cmd += ["--fail-at-step", str(fail_at)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    def finish(proc) -> tuple[int, str, str]:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        return proc.returncode, out, err

    archs = (TWO_TOWER, LLAMA)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {a: (os.path.join(tmp, f"{i}-whole"),
                    os.path.join(tmp, f"{i}-crash"))
                for i, a in enumerate(archs)}
        procs = {(a, kind): start(a, dirs[a][kind == "crash"],
                                  kind == "crash")
                 for a in archs for kind in ("whole", "crash")}
        done = {k: finish(p) for k, p in procs.items()}
        resumed = {a: finish(start(a, dirs[a][1], False)) for a in archs}
        for a in archs:
            rc_w, out_w, err_w = done[(a, "whole")]
            rc_c, out_c, err_c = done[(a, "crash")]
            rc_r, out_r, err_r = resumed[a]
            check(rc_w == 0, f"{a} uninterrupted run: exit {rc_w}: "
                             f"{err_w[-2000:]}")
            check(rc_c == 3 and f"injected failure at step {fail_at}"
                  in out_c, f"{a} crash run: exit {rc_c}: {err_c[-2000:]}")
            check(rc_r == 0 and f"at step {fail_at // save_every * save_every}"
                  in out_r, f"{a} resumed run: exit {rc_r}: {err_r[-2000:]}")
            final = f"step_{steps:08d}"
            a_dir = os.path.join(dirs[a][0], final)
            b_dir = os.path.join(dirs[a][1], final)
            names = sorted(os.listdir(a_dir))
            same = names == sorted(os.listdir(b_dir)) and all(
                open(os.path.join(a_dir, n), "rb").read()
                == open(os.path.join(b_dir, n), "rb").read() for n in names)
            log(f"phase 11 (c): python -m repro_torch.launch.train --arch "
                f"{a} --scale smoke --steps {steps} --save-every "
                f"{save_every}: exit {rc_w}; crashed at {fail_at}: exit "
                f"{rc_c}; resumed: exit {rc_r} ({out_r.splitlines()[0]}); "
                f"final checkpoint == the uninterrupted run's, file for file "
                f"({len(names)} files): {same} | "
                f"{out_w.strip().splitlines()[-1]}")
            check(same, f"{a}: the resumed run's state differs")
    log(f"phase 11 (c): 6 launcher runs in {time.perf_counter() - t0:.1f} s")


def phase11(device: str) -> dict:
    """Every part of phase 11; returns its kernels' main-path launch
    counts and the backward kernel's entry of the ``kernels`` line."""
    t = {}
    t0 = time.perf_counter()
    lm = phase11_llama(device)
    t["llama"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tt_out = phase11_two_tower(device)
    t["two_tower"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase11_launcher(device)
    t["launcher"] = time.perf_counter() - t0
    launches = {k: lm["launches"][k] + tt_out["launches"][k]
                for k in lm["launches"]}
    log(f"phase 11: main-path launches {launches}; seconds by part "
        f"{ {k: round(v, 1) for k, v in t.items()} }")
    for k in ("embedding_bag", "embedding_bag_bwd"):
        check(launches[k] > 0, f"phase 11: {k} never launched")
    return {"launches": launches, "entry": tt_out["entry"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {', '.join(sorted({p.name for p in libs.values()}))} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, in parallel)")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    g = torch.Generator(device="cuda").manual_seed(0)

    failures: list[str] = []

    def run(name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            result = fn(*args)
        except Exception as e:  # report, then go on with the next phase
            traceback.print_exc()
            failures.append(f"{name}: {e}")
            log(f"{name}: FAILED after {time.perf_counter() - t0:.2f} s")
            return None
        log(f"{name}: ok in {time.perf_counter() - t0:.2f} s")
        return result

    def full_flat():
        full = phase_full(n=1_000_000, n_queries=1024, batch=256,
                          steps=3000, device="cuda")
        return kernel_times(full)

    def graph():
        return graph_beam_time(phase_graph("cuda"), g)

    def sharded():
        merge = phase_sharded(n=1_000_003, n_queries=1024, batch=256,
                              steps=3000, device="cuda")
        return topk_merge_time(merge)

    def quantized():
        full = phase_quantized_full(n=1_000_003, n_queries=1024, batch=256,
                                    steps=3000, device="cuda")
        entry = pq_adc_time(full)
        del full
        return [entry, graph_beam_q_time(phase_quantized_graph("cuda"), g)]

    def two_tower():
        out = phase_two_tower("cuda")
        entry = embedding_bag_time(out)
        del out
        free_card()
        return entry

    def llama():
        out = phase_llama("cuda")
        entry = out["long_500k"]     # the kernels line: long_500k's shape
        entry["launches"] = out["launches"]
        return entry

    errs = run("phase 1", phase_kernels, g)
    run("phase 2", phase_acceptance, "cuda")
    kernels = run("phase 3", full_flat) or []
    kernels.append(run("phase 4", graph))
    kernels.append(run("phase 5", sharded))
    kernels.extend(run("phase 6", quantized) or [])
    kernels.append(run("phase 7", two_tower))
    kernels.append(run("phase 8", llama))
    p9 = run("phase 9", phase9, "cuda")
    p10 = run("phase 10", phase10, "cuda")
    p11 = run("phase 11", phase11, "cuda")
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    entry = p11["entry"]
    entry["launches"] = 0          # its launches are all phase 11's
    kernels.append(entry)
    for entry in kernels:
        entry["max_abs_err"] = errs[entry["name"]]
        # phase 9's paths (baselines, theory, mutation), phase 10's
        # (serving, tuning) and phase 11's (training) launch these too
        entry["launches_phase9"] = p9.get(entry["name"], 0)
        entry["launches_phase10"] = p10.get(entry["name"], 0)
        entry["launches_phase11"] = p11["launches"].get(entry["name"], 0)
        entry["launches"] += (entry["launches_phase9"]
                              + entry["launches_phase10"]
                              + entry["launches_phase11"])
    log(f"all phases ok in {time.perf_counter() - t_all:.2f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cli() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", metavar="PARENT_SRC",
                    help="time topk_merge, pq_adc, the graph traversals "
                         "(float32, SQ8, PQ8x8), l2_topk, rae_encode, "
                         "flash_decode and the decode steps with the "
                         "parent tree's src "
                         "directory and this one's, in turns, and run "
                         "nothing else")
    ap.add_argument("--times", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--graph", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return main()              # refuses without a card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.times:
        print(json.dumps(redesign_times(args.times, args.graph)))
        return 0
    if args.ab:
        return ab(args.ab)
    return main()


if __name__ == "__main__":
    sys.exit(cli())
