"""Binding of the hand-written CUDA quantized hop and of the whole
quantized traversal built on it (``csrc/graph_beam_q.cu``, on the shared
traversal of ``csrc/graph_traverse.cuh``).

The hop replaces the TPU kernel ``graph_beam_q_pallas``
(``src/repro/kernels/graph_beam_q/kernel.py``); the traversal replaces the
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
from ..graph_beam.kernel import check_graph, visited_bits
from .ref import check_mode, check_operand


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("graph_beam_q")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_beam_q_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i, p]
    lib.graph_beam_q_launch.restype = i
    lib.graph_beam_q_smem.argtypes = [i, i, i]
    lib.graph_beam_q_smem.restype = ctypes.c_longlong
    lib.graph_traverse_q_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                            i, i, i, i, i, i, i, p, p, p, p,
                                            p, p]
    lib.graph_traverse_q_launch.restype = i
    lib.graph_traverse_q_smem.argtypes = [i, i, i, i, i]
    lib.graph_traverse_q_smem.restype = ctypes.c_longlong
    return lib


#: Widest candidate row and beam the kernel takes (``kMaxW``/``kMaxEf`` of
#: the source), as for the f32 hop.
MAX_W = 1024
MAX_EF = 4096


def _check_operands(name: str, q_op: torch.Tensor, q_bias: torch.Tensor,
                    codes: torch.Tensor, node_bias: torch.Tensor, mode: str,
                    ksub: int) -> None:
    """Device, types, shapes and contiguity of the hop's and the
    traversal's per-query operands and code payload."""
    check_mode(mode, ksub)
    dev = q_op.device
    tensors = (q_op, q_bias, codes, node_bias)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs all tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in (q_op, q_bias, node_bias)) \
            or codes.dtype != torch.uint8:
        raise ValueError(f"{name} takes float32 operands and biases, uint8 "
                         f"codes")
    nq = q_op.shape[0]
    if (q_op.dim() != 2 or codes.dim() != 2 or q_bias.shape != (nq,)
            or node_bias.shape != (codes.shape[0],)):
        raise ValueError(f"{name} shapes: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    dop, (n, c) = q_op.shape[1], codes.shape
    check_operand(mode, ksub, dop, c)
    if c < 1 or n >= 2 ** 31 or nq >= 2 ** 31 or dop >= 2 ** 31:
        raise ValueError(f"{name} shapes out of range: Q={nq}, N={n}, C={c}, "
                         f"Dop={dop}")


def graph_beam_q_cuda(q_op: torch.Tensor, q_bias: torch.Tensor,
                      codes: torch.Tensor, node_bias: torch.Tensor,
                      nbr_ids: torch.Tensor, beam_v: torch.Tensor,
                      beam_i: torch.Tensor, mode: str, ksub: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One quantized hop: q_op [Q, Dop], q_bias [Q], node_bias [N] float32;
    codes [N, C] uint8; nbr_ids [Q, W] int32 (-1 = masked); beam_v/beam_i
    [Q, ef] float32/int32 sorted descending; ``mode`` "sq8" (Dop = C) or
    "pq" (Dop = C * ksub). All contiguous on one CUDA device. Returns the
    merged (vals [Q, ef], ids [Q, ef])."""
    _check_operands("graph_beam_q_cuda", q_op, q_bias, codes, node_bias,
                    mode, ksub)
    dev, nq = q_op.device, q_op.shape[0]
    beams = (nbr_ids, beam_v, beam_i)
    if any(t.device != dev for t in beams):
        raise ValueError(f"graph_beam_q_cuda needs all tensors on one CUDA "
                         f"device, got {[str(t.device) for t in beams]}")
    if beam_v.dtype != torch.float32 or nbr_ids.dtype != torch.int32 \
            or beam_i.dtype != torch.int32:
        raise ValueError("graph_beam_q_cuda takes float32 beam values, "
                         "int32 ids")
    if (nbr_ids.dim() != 2 or nbr_ids.shape[0] != nq or beam_v.dim() != 2
            or beam_v.shape[0] != nq or beam_i.shape != beam_v.shape):
        raise ValueError(f"graph_beam_q_cuda shapes: "
                         f"{[tuple(t.shape) for t in beams]}")
    if not all(t.is_contiguous() for t in beams):
        raise ValueError("graph_beam_q_cuda takes contiguous tensors")
    dop, (n, c) = q_op.shape[1], codes.shape
    w, ef = nbr_ids.shape[1], beam_v.shape[1]
    if not 1 <= w <= MAX_W:
        raise ValueError(f"graph_beam_q kernel supports 1 <= W <= {MAX_W} "
                         f"candidate slots (ranked in shared memory), got "
                         f"W={w}")
    if not 1 <= ef <= MAX_EF:
        raise ValueError(f"graph_beam_q kernel supports 1 <= ef <= "
                         f"{MAX_EF} (the beam is staged in shared memory), "
                         f"got ef={ef}")
    lib = _lib()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    need = lib.graph_beam_q_smem(dop, w, ef)
    if need > limit:
        raise ValueError(f"graph_beam_q kernel: Dop={dop}, W={w}, ef={ef} "
                         f"need {need} bytes of shared memory, the card "
                         f"gives a block {limit}")
    vals = torch.empty((nq, ef), device=dev, dtype=torch.float32)
    ids = torch.empty((nq, ef), device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.graph_beam_q_launch(
        q_op.data_ptr(), q_bias.data_ptr(), codes.data_ptr(),
        node_bias.data_ptr(), nbr_ids.data_ptr(), beam_v.data_ptr(),
        beam_i.data_ptr(), vals.data_ptr(), ids.data_ptr(), nq, n, c, dop,
        ksub if mode == "pq" else 0, w, ef, 0 if mode == "sq8" else 1,
        stream)
    if err != 0:
        raise RuntimeError(f"graph_beam_q kernel launch failed (cuda error "
                           f"{err})")
    if nq:
        _build.count_launch(graph_beam_q_cuda)
    return vals, ids


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
graph_beam_q_cuda.launches = 0


def graph_traverse_q_cuda(q_op: torch.Tensor, q_bias: torch.Tensor,
                          codes: torch.Tensor, node_bias: torch.Tensor,
                          nbrs0: torch.Tensor, upper: torch.Tensor,
                          entry: int, ef: int, mode: str, ksub: int = 0,
                          alive: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """The whole quantized traversal in one launch, one block a query: the
    hop's operands (q_op [Q, Dop], q_bias [Q], codes [N, C] uint8,
    node_bias [N], ``mode``, ``ksub``, as :func:`graph_beam_q_cuda`) over
    the graph nbrs0 [N, W0] and upper [L, N, M] int32 (-1 = empty slot)
    from ``entry``; ``alive`` (bool or uint8 [N], or None) tombstones
    nodes. All contiguous on one CUDA device. Returns (beam_v [Q, ef]
    float32, beam_i [Q, ef] int32, evals [Q] int64, hops [Q] int32), as
    :func:`.ref.graph_traverse_q_ref`."""
    _check_operands("graph_traverse_q_cuda", q_op, q_bias, codes, node_bias,
                    mode, ksub)
    dev, nq = q_op.device, q_op.shape[0]
    dop, (n, c) = q_op.shape[1], codes.shape
    alive = check_graph("graph_traverse_q_cuda", dev, n, nbrs0, upper, entry,
                        ef, alive)
    lib = _lib()
    w0, levels, m = nbrs0.shape[1], upper.shape[0], upper.shape[2]
    vis = visited_bits("graph_traverse_q kernel", lib.graph_traverse_q_smem,
                       dop, w0, m, ef, nq, n, dev)
    vals = torch.empty((nq, ef), device=dev, dtype=torch.float32)
    ids = torch.empty((nq, ef), device=dev, dtype=torch.int32)
    evals = torch.empty(nq, device=dev, dtype=torch.int64)
    hops = torch.empty(nq, device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.graph_traverse_q_launch(
        q_op.data_ptr(), q_bias.data_ptr(), codes.data_ptr(),
        node_bias.data_ptr(), nbrs0.data_ptr(),
        upper.data_ptr() if upper.numel() else None,
        None if alive is None else alive.data_ptr(), nq, n, c, dop,
        ksub if mode == "pq" else 0, 0 if mode == "sq8" else 1, w0, m,
        levels, entry, ef, None if vis is None else vis.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), evals.data_ptr(), hops.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"graph_traverse_q kernel launch failed (cuda "
                           f"error {err})")
    if nq:
        _build.count_launch(graph_traverse_q_cuda)
    return vals, ids, evals, hops


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
graph_traverse_q_cuda.launches = 0
