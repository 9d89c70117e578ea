"""Binding of the hand-written CUDA PQ ADC scan (``csrc/pq_adc.cu``).

Replaces the TPU kernel ``pq_adc_pallas``
(``src/repro/kernels/pq_adc/kernel.py``); the source file says how it is
laid out and what bounds it. The wrapper checks what the kernel takes,
plans a scan block's geometry (:func:`plan`), the pilots and the main pass
(:func:`schedule`) and each pass's chunks of rows so that its items fill
whole waves of the blocks the card holds (:func:`plan_chunks`), allocates
outputs and scratch (the LUTs, the survivor lists, the chunk lists),
launches on PyTorch's current stream and raises if a launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: Largest k the kernel takes (``kMaxK`` of the source): the merge pass
#: sorts a query's k pairs in one block's shared memory (4096 at most).
MAX_K = 4032
#: The scan's query tiles, widest first, and its code tiles in rows,
#: longest first (``pq_adc_pass`` takes these).
QUERY_TILES = (16, 4, 1)
ROW_TILES = (2048, 1024, 512)
#: Most chunks a pass splits its rows into (``kMaxChunks``).
MAX_CHUNKS = 1024
#: Warps of a scan block (``kScanThreads / 32``).
SCAN_WARPS = 16
#: Margin for the scan kernel's static shared memory (thresholds and
#: counts: under 2 KB).
STATIC_SMEM = 2048
#: The pilots scan every PILOT_STEP-th row (and every PILOT_STEP**2-th),
#: when that sample holds at least k rows.
PILOT_STEP = 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pq_adc")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pq_adc_lut.argtypes = [p, p, i, i, i, i, i, p, p]
    lib.pq_adc_lut.restype = i
    lib.pq_adc_pass.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, ll, i, i,
                                i, p, p, p, p, p, p, p, p, p, p]
    lib.pq_adc_pass.restype = i
    lib.pq_adc_blocks_per_sm.argtypes = [i, i, ll]
    lib.pq_adc_blocks_per_sm.restype = i
    lib.pq_adc_max_k.argtypes = []
    lib.pq_adc_max_k.restype = i
    if lib.pq_adc_max_k() != MAX_K:
        raise RuntimeError("pq_adc: the library's MAX_K differs from the "
                           "wrapper's")
    return lib


def list_cut(k: int) -> int:
    """A survivor list is cut back to k pairs when it holds more than this
    after a tile: 2k + 32 (at least 128, a multiple of 32), so a cut drops
    at least k + 32."""
    return max(128, -(-(2 * k + 32) // 32) * 32)


def lut_floats(bq: int, m: int, ksub: int) -> int:
    """Floats of one query tile's interleaved LUT [m][ksub][bq], padded to
    16 bytes."""
    return -(-(bq * m * ksub) // 4) * 4


def scan_smem(bq: int, tile: int, m: int, ksub: int) -> int:
    """Dynamic shared memory of a scan block: its query tile's LUTs, two
    code tiles of ``tile`` rows, and a radix histogram (256 ints) for each
    of its 16 warps."""
    return (4 * lut_floats(bq, m, ksub) + 2 * (-(-(tile * m) // 16) * 16)
            + 4 * 256 * SCAN_WARPS)


def plan(k: int, m: int, ksub: int, smem_limit: int
         ) -> tuple[int, int, int, int, int]:
    """(query tile bq, code tile rows, list cap, cut point, shared memory)
    of a scan block: the widest query tile in :data:`QUERY_TILES` and then
    the longest code tile in :data:`ROW_TILES` whose shared memory fits
    ``smem_limit``; cap = cut + tile, the room a list in device memory
    needs for one more tile. Raises when none fits."""
    cut = list_cut(k)
    for bq in QUERY_TILES:
        for tile in ROW_TILES:
            smem = scan_smem(bq, tile, m, ksub)
            if smem <= smem_limit:
                return bq, tile, cut + tile, cut, smem
    raise ValueError(f"pq_adc kernel: one query's LUT (m*ksub = {m * ksub} "
                     f"floats) and two code tiles need more than the "
                     f"{smem_limit} bytes of shared memory the card gives a "
                     f"block")


@functools.lru_cache(maxsize=256)
def plan_chunks(n_queries: int, n_rows: int, tile: int, bq: int,
                slots: int) -> tuple[int, int, int]:
    """(rows per chunk, chunks, blocks) of one pass: items are (query tile,
    chunk) pairs walked by ``min(items, slots)`` persistent blocks
    (``slots`` = the blocks the card holds at once). The chunk count
    minimises the waves of items times a chunk's tiles, the pass's length
    in tile-times of one block, fewest chunks on ties: at Q = 256 (16
    query tiles), 1M rows in 489 tiles and 132 slots, 33 chunks make 528
    items, 4 whole waves of 15 tiles."""
    q_tiles = -(-max(n_queries, 1) // bq)
    tiles = max(1, -(-n_rows // tile))
    best = None
    for c in range(1, min(tiles, MAX_CHUNKS) + 1):
        per = -(-tiles // c)
        chunks = -(-tiles // per)
        cost = -(-(q_tiles * chunks) // slots) * per
        if best is None or cost < best[0]:
            best = (cost, per, chunks)
    _, per, chunks = best
    return per * tile, chunks, min(q_tiles * chunks, slots)


def schedule(n_rows: int, k: int) -> list[tuple[int, int]]:
    """The passes of one call, as (scan rows, row step): pilots over every
    ``PILOT_STEP ** j``-th row, coarsest first, for each j whose sample
    holds k rows or more (at most 2), then the main pass over every row.
    Each pass seeds its lists' thresholds with the k-th pair of the pass
    before it: the k-th best of a subset of the rows it scans, so a lower
    bound of their k-th best, and nothing it drops could be in the answer.
    With a seed about ``PILOT_STEP`` * k pairs a query survive the main
    pass; without one, a list passes every score of its first tile, and
    the first pass is the smallest sample that can seed."""
    out = [(n_rows, 1)]
    step = PILOT_STEP
    while len(out) < 3 and -(-n_rows // step) >= k:
        out.insert(0, (-(-n_rows // step), step))
        step *= PILOT_STEP
    return out


def pq_adc_cuda(q: torch.Tensor, codebooks: torch.Tensor,
                codes: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best (-ADC distance, row) pairs per query, ordered by (score
    desc, row asc). q [Q, m * dsub] float32, codebooks [m, ksub, dsub]
    float32, codes [N, m] uint8: contiguous, on one CUDA device; 1 <= k <=
    min(N, MAX_K). Returns (vals [Q, k] float32, ids [Q, k] int32)."""
    dev = q.device
    tensors = (q, codebooks, codes)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"pq_adc_cuda needs all tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype != torch.float32 or codebooks.dtype != torch.float32 \
            or codes.dtype != torch.uint8:
        raise ValueError(f"pq_adc_cuda takes float32 queries and codebooks "
                         f"and uint8 codes, got {q.dtype}, "
                         f"{codebooks.dtype}, {codes.dtype}")
    if (q.dim() != 2 or codebooks.dim() != 3 or codes.dim() != 2
            or codes.shape[1] != codebooks.shape[0]
            or q.shape[1] != codebooks.shape[0] * codebooks.shape[2]):
        raise ValueError(f"pq_adc_cuda shapes: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pq_adc_cuda takes contiguous tensors")
    nq = q.shape[0]
    m, ksub, dsub = codebooks.shape
    n = codes.shape[0]
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"pq_adc kernel supports 1 <= k <= min(N, "
                         f"{MAX_K}) (the merge pass sorts a query's k pairs "
                         f"in shared memory), got k={k}, N={n}")
    if n >= 2 ** 31 or nq >= 2 ** 31 or 16 * m * ksub >= 2 ** 31:
        raise ValueError(f"pq_adc_cuda shapes out of range: Q={nq}, N={n}, "
                         f"m={m}, ksub={ksub}")
    lib = _lib()
    props = torch.cuda.get_device_properties(dev)
    bq, tile, cap, cut, smem = plan(
        k, m, ksub, props.shared_memory_per_block_optin - STATIC_SMEM)
    per_sm = lib.pq_adc_blocks_per_sm(bq, m, smem)
    if per_sm < 1:
        raise RuntimeError(f"pq_adc kernel: no scan block fits an SM "
                           f"(occupancy {per_sm})")
    slots = props.multi_processor_count * per_sm
    q_tiles = -(-nq // bq)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lut = torch.empty(q_tiles * lut_floats(bq, m, ksub), device=dev,
                      dtype=torch.float32)
    err = lib.pq_adc_lut(q.data_ptr(), codebooks.data_ptr(), nq, m, ksub,
                         dsub, bq, lut.data_ptr(), stream)
    seed = None
    for n_scan, step in schedule(n, k):
        if err != 0:
            break
        chunk, chunks, grid = plan_chunks(nq, n_scan, tile, bq, slots)
        lists = q_tiles * bq * chunks
        part_v = torch.empty(lists * k, device=dev, dtype=torch.float32)
        part_i = torch.empty(lists * k, device=dev, dtype=torch.int32)
        counts = torch.empty(lists, device=dev, dtype=torch.int32)
        list_v = torch.empty(grid * bq * cap, device=dev, dtype=torch.float32)
        list_i = torch.empty(grid * bq * cap, device=dev, dtype=torch.int32)
        vals = torch.empty((nq, k), device=dev, dtype=torch.float32)
        ids = torch.empty((nq, k), device=dev, dtype=torch.int32)
        err = lib.pq_adc_pass(
            lut.data_ptr(), codes.data_ptr(), nq, n_scan, step, m, ksub, k,
            bq, tile, cap, cut, smem, chunk, chunks, grid,
            None if seed is None else seed[0].data_ptr(),
            None if seed is None else seed[1].data_ptr(), list_v.data_ptr(),
            list_i.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            counts.data_ptr(), vals.data_ptr(), ids.data_ptr(), stream)
        seed = vals, ids
    if err != 0:
        raise RuntimeError(f"pq_adc kernel launch failed (cuda error {err})")
    if nq:
        _build.count_launch(pq_adc_cuda)
    return seed


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
pq_adc_cuda.launches = 0
