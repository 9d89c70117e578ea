"""Binding of the hand-written CUDA PQ ADC scan (``csrc/pq_adc.cu``).

Replaces the TPU kernel ``pq_adc_pallas``
(``src/repro/kernels/pq_adc/kernel.py``); the source file says how it is
laid out and what bounds it. The wrapper checks what the kernel takes,
splits the codes into chunks so that about two pass-1 blocks run per SM,
allocates outputs and scratch (the LUTs, the chunk lists), launches on
PyTorch's current stream and raises if a launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_BLOCKS_PER_SM = 2    # pass-1 blocks hold 64-200 KB of shared memory
_SMEM_MARGIN = 1024   # the scan kernel's static shared memory, rounded up


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pq_adc")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pq_adc_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, ll, p, p,
                                  p, p, p, p]
    lib.pq_adc_launch.restype = i
    lib.pq_adc_plan.argtypes = [i, i, i, ll, ctypes.POINTER(i),
                                ctypes.POINTER(i), ctypes.POINTER(i),
                                ctypes.POINTER(ll)]
    lib.pq_adc_plan.restype = i
    lib.pq_adc_max_k.argtypes = []
    lib.pq_adc_max_k.restype = i
    return lib


#: Largest k the kernel takes (``pq_adc_max_k`` of the source): a query's
#: candidate buffer of 4096 pairs in shared memory holds k pairs and one
#: 64-row code tile.
MAX_K = 4032


def plan_chunks(n_queries: int, n_rows: int, k: int, query_tile: int,
                n_sms: int) -> tuple[int, int]:
    """(rows per chunk, chunks) for pass 1: about two (query tile, chunk)
    blocks per SM, each chunk at least 2k rows and a multiple of 256."""
    q_tiles = -(-n_queries // query_tile)
    want = max(1, -(-(_BLOCKS_PER_SM * n_sms) // q_tiles))
    chunk = max(-(-max(n_rows, 1) // want), 2 * k, 256)
    chunk = -(-chunk // 256) * 256
    return chunk, max(1, -(-n_rows // chunk))


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
                         f"{MAX_K}) (a shared-memory buffer of 4096 pairs "
                         f"per query holds k pairs and one 64-row tile), "
                         f"got k={k}, N={n}")
    if n >= 2 ** 31 or nq >= 2 ** 31 or m * ksub >= 2 ** 31:
        raise ValueError(f"pq_adc_cuda shapes out of range: Q={nq}, N={n}, "
                         f"m={m}, ksub={ksub}")
    lib = _lib()
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin - _SMEM_MARGIN
    bq, bn, cap = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    if lib.pq_adc_plan(k, m, ksub, limit, ctypes.byref(bq), ctypes.byref(bn),
                       ctypes.byref(cap), ctypes.byref(smem)) != 0:
        raise ValueError(f"pq_adc kernel: one query's LUT (m*ksub = "
                         f"{m * ksub} floats) and candidate buffer for k={k} "
                         f"need more than the {limit} bytes of shared "
                         f"memory the card gives a block")
    chunk, chunks = plan_chunks(nq, n, k, bq.value,
                                props.multi_processor_count)
    vals = torch.empty((nq, k), device=dev, dtype=torch.float32)
    ids = torch.empty((nq, k), device=dev, dtype=torch.int32)
    lut = torch.empty((nq, m * ksub), device=dev, dtype=torch.float32)
    part_v = part_i = None
    if chunks > 1:
        part_v = torch.empty((nq, chunks, k), device=dev, dtype=torch.float32)
        part_i = torch.empty((nq, chunks, k), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pq_adc_launch(
        q.data_ptr(), codebooks.data_ptr(), codes.data_ptr(), nq, n, m, ksub,
        dsub, k, chunk, chunks, limit, lut.data_ptr(),
        None if part_v is None else part_v.data_ptr(),
        None if part_i is None else part_i.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pq_adc kernel launch failed (cuda error {err})")
    if nq:
        _build.count_launch(pq_adc_cuda)
    return vals, ids


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
pq_adc_cuda.launches = 0
