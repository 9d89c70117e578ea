"""Binding of the hand-written CUDA traversal hop and of the whole
traversal built on it (``csrc/graph_beam.cu``).

The hop replaces the TPU kernel ``graph_beam_pallas``
(``src/repro/kernels/graph_beam/kernel.py``); the traversal replaces the
reference's one-dispatch ``_traverse_impl`` around it. The source file says
how they are laid out and what bounds them. The wrappers check what the
kernels take, allocate the outputs, launch on PyTorch's current stream and
raise if a launch was refused.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

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
    lib.graph_traverse_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                          i, i, i, p, p, p, p, p, p]
    lib.graph_traverse_launch.restype = i
    lib.graph_traverse_smem.argtypes = [i, i, i, i, i]
    lib.graph_traverse_smem.restype = ctypes.c_longlong
    return lib


#: Widest candidate row and beam the kernel takes (``kMaxW``/``kMaxEf`` of
#: the source): the W scores are ranked and the beam's values staged in one
#: block's shared memory.
MAX_W = 1024
MAX_EF = 4096
#: Largest graph whose visited bits stay in a block's shared memory (64
#: KB); a larger one keeps them in a zeroed [Q, N/32] matrix on the card.
SMEM_VISITED_MAX_N = 1 << 19


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


def check_graph(name: str, dev: torch.device, n: int, nbrs0: torch.Tensor,
                upper: torch.Tensor, entry: int, ef: int,
                alive: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The checks a traversal launch makes of its graph (shared by the
    float32 and the quantized traversal): nbrs0 [N, W0] and upper [L, N, M]
    int32 contiguous on ``dev``, rows of 1..MAX_W slots, 1 <= ef <= MAX_EF,
    the entry a node. Returns ``alive`` as uint8 (or None)."""
    tensors = [nbrs0, upper]
    if alive is not None:
        alive = alive.to(torch.uint8)
        tensors.append(alive)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs all tensors on one CUDA device, got "
                         f"{dev} and {[str(t.device) for t in tensors]}")
    if nbrs0.dtype != torch.int32 or upper.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 adjacency")
    if (nbrs0.dim() != 2 or nbrs0.shape[0] != n or upper.dim() != 3
            or upper.shape[1:2] != (n,)
            or (alive is not None and alive.shape != (n,))):
        raise ValueError(f"{name} graph shapes: "
                         f"{[tuple(t.shape) for t in tensors]} for N={n}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    w0, levels, m = nbrs0.shape[1], upper.shape[0], upper.shape[2]
    if not (1 <= w0 <= MAX_W and m <= MAX_W and (levels == 0 or m >= 1)):
        raise ValueError(f"graph_traverse kernel supports neighbour rows "
                         f"of 1..{MAX_W} slots (ranked in shared memory), "
                         f"got W0={w0}, M={m}")
    if not 1 <= ef <= MAX_EF:
        raise ValueError(f"graph_traverse kernel supports 1 <= ef <= "
                         f"{MAX_EF} (the beam is kept in shared memory), "
                         f"got ef={ef}")
    if not 0 <= entry < n or n >= 2 ** 31:
        raise ValueError(f"{name} out of range: N={n}, entry={entry}")
    return alive


def visited_bits(name: str, smem, dop: int, w0: int, m: int, ef: int,
                 nq: int, n: int, dev: torch.device
                 ) -> Optional[torch.Tensor]:
    """Where a traversal keeps its visited bits: None (shared memory, up
    to ``SMEM_VISITED_MAX_N`` nodes when they fit beside the beam) or a
    zeroed [Q, N/32] matrix on the card. ``smem(dop, w0, m, ef, words)``
    is the library's shared-memory count; raises when even the matrix
    layout does not fit a block."""
    words = -(-n // 32)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    vis = None
    if n > SMEM_VISITED_MAX_N or smem(dop, w0, m, ef, words) > limit:
        vis = torch.zeros((nq, words), device=dev, dtype=torch.int32)
    need = smem(dop, w0, m, ef, 0 if vis is not None else words)
    if need > limit:
        raise ValueError(f"{name}: operand of {dop} floats, W0={w0}, M={m}, "
                         f"ef={ef} need {need} bytes of shared memory, the "
                         f"card gives a block {limit}")
    return vis


def graph_traverse_cuda(q: torch.Tensor, db: torch.Tensor,
                        db_sq: torch.Tensor, q_sq: torch.Tensor,
                        nbrs0: torch.Tensor, upper: torch.Tensor, entry: int,
                        ef: int, alive: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """The whole traversal in one launch, one block a query: q [Q, d], db
    [N, d], db_sq [N], q_sq [Q] float32; nbrs0 [N, W0] and upper [L, N, M]
    int32 (-1 = empty slot); ``entry`` the entry node; ``alive`` (bool or
    uint8 [N], or None) tombstones nodes. All contiguous on one CUDA
    device. Returns (beam_v [Q, ef] float32, beam_i [Q, ef] int32, evals
    [Q] int64, hops [Q] int32), as :func:`.ref.graph_traverse_ref`."""
    dev = q.device
    tensors = [q, db, db_sq, q_sq]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"graph_traverse_cuda needs all tensors on one "
                         f"CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("graph_traverse_cuda takes float32 vectors and "
                         "norms, int32 adjacency")
    nq, n = q.shape[0], db.shape[0]
    if (q.dim() != 2 or db.dim() != 2 or db.shape[1] != q.shape[1]
            or db_sq.shape != (n,) or q_sq.shape != (nq,)):
        raise ValueError(f"graph_traverse_cuda shapes: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("graph_traverse_cuda takes contiguous tensors")
    d = q.shape[1]
    if d < 1 or nq >= 2 ** 31:
        raise ValueError(f"graph_traverse_cuda out of range: Q={nq}, d={d}")
    alive = check_graph("graph_traverse_cuda", dev, n, nbrs0, upper, entry,
                        ef, alive)
    lib = _lib()
    w0, levels, m = nbrs0.shape[1], upper.shape[0], upper.shape[2]
    vis = visited_bits("graph_traverse kernel", lib.graph_traverse_smem, d,
                       w0, m, ef, nq, n, dev)
    vals = torch.empty((nq, ef), device=dev, dtype=torch.float32)
    ids = torch.empty((nq, ef), device=dev, dtype=torch.int32)
    evals = torch.empty(nq, device=dev, dtype=torch.int64)
    hops = torch.empty(nq, device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.graph_traverse_launch(
        q.data_ptr(), db.data_ptr(), db_sq.data_ptr(), q_sq.data_ptr(),
        nbrs0.data_ptr(), upper.data_ptr() if upper.numel() else None,
        None if alive is None else alive.data_ptr(), nq, n, d, w0, m, levels,
        entry, ef, None if vis is None else vis.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), evals.data_ptr(), hops.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"graph_traverse kernel launch failed (cuda "
                           f"error {err})")
    if nq:
        _build.count_launch(graph_traverse_cuda)
    return vals, ids, evals, hops


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
graph_traverse_cuda.launches = 0
