"""Binding of the hand-written CUDA traversal hop (``csrc/graph_beam.cu``).

Replaces the TPU kernel ``graph_beam_pallas``
(``src/repro/kernels/graph_beam/kernel.py``); the source file says how it
is laid out and what bounds it. The wrapper checks what the kernel takes,
allocates the merged beam, launches on PyTorch's current stream and raises
if the launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("graph_beam")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_beam_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                      i, i, i, i, i, p]
    lib.graph_beam_launch.restype = i
    lib.graph_beam_smem.argtypes = [i, i, i]
    lib.graph_beam_smem.restype = ctypes.c_longlong
    return lib


#: Widest candidate row and beam the kernel takes (``kMaxW``/``kMaxEf`` of
#: the source): the W scores are ranked and the beam's values staged in one
#: block's shared memory.
MAX_W = 1024
MAX_EF = 4096


def graph_beam_cuda(q: torch.Tensor, db: torch.Tensor, db_sq: torch.Tensor,
                    q_sq: torch.Tensor, nbr_ids: torch.Tensor,
                    beam_v: torch.Tensor, beam_i: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One hop: q [Q, d], db [N, d], db_sq [N], q_sq [Q] float32; nbr_ids
    [Q, W] int32 (-1 = masked); beam_v/beam_i [Q, ef] float32/int32 sorted
    descending. All contiguous on one CUDA device. Returns the merged
    (vals [Q, ef], ids [Q, ef])."""
    dev = q.device
    tensors = (q, db, db_sq, q_sq, nbr_ids, beam_v, beam_i)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"graph_beam_cuda needs all tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in (q, db, db_sq, q_sq, beam_v)) \
            or nbr_ids.dtype != torch.int32 or beam_i.dtype != torch.int32:
        raise ValueError("graph_beam_cuda takes float32 vectors, norms and "
                         "beam values, int32 ids")
    nq = q.shape[0]
    if (q.dim() != 2 or db.dim() != 2 or db.shape[1] != q.shape[1]
            or db_sq.shape != (db.shape[0],) or q_sq.shape != (nq,)
            or nbr_ids.dim() != 2 or nbr_ids.shape[0] != nq
            or beam_v.dim() != 2 or beam_v.shape[0] != nq
            or beam_i.shape != beam_v.shape):
        raise ValueError(f"graph_beam_cuda shapes: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("graph_beam_cuda takes contiguous tensors")
    d, n = q.shape[1], db.shape[0]
    w, ef = nbr_ids.shape[1], beam_v.shape[1]
    if not 1 <= w <= MAX_W:
        raise ValueError(f"graph_beam kernel supports 1 <= W <= {MAX_W} "
                         f"candidate slots (ranked in shared memory), got "
                         f"W={w}")
    if not 1 <= ef <= MAX_EF:
        raise ValueError(f"graph_beam kernel supports 1 <= ef <= {MAX_EF} "
                         f"(the beam is staged in shared memory), got "
                         f"ef={ef}")
    if d < 1 or n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError(f"graph_beam_cuda shapes out of range: Q={nq}, "
                         f"N={n}, d={d}")
    lib = _lib()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if lib.graph_beam_smem(d, w, ef) > limit:
        raise ValueError(f"graph_beam kernel: d={d}, W={w}, ef={ef} need "
                         f"{lib.graph_beam_smem(d, w, ef)} bytes of shared "
                         f"memory, the card gives a block {limit}")
    vals = torch.empty((nq, ef), device=dev, dtype=torch.float32)
    ids = torch.empty((nq, ef), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.graph_beam_launch(
        q.data_ptr(), db.data_ptr(), db_sq.data_ptr(), q_sq.data_ptr(),
        nbr_ids.data_ptr(), beam_v.data_ptr(), beam_i.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), nq, n, d, w, ef, stream)
    if err != 0:
        raise RuntimeError(f"graph_beam kernel launch failed (cuda error "
                           f"{err})")
    if nq:
        _build.count_launch(graph_beam_cuda)
    return vals, ids


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
graph_beam_cuda.launches = 0
