"""Binding of the hand-written CUDA encoder GEMM (``csrc/rae_encode.cu``).

Replaces the TPU kernel ``rae_encode_pallas``
(``src/repro/kernels/rae_encode/kernel.py``); the source file says how it
is laid out and what bounds it. The wrapper checks what the kernel takes,
allocates the output, launches on PyTorch's current stream and raises if
the launch was refused. It also allocates the scratch in which the
kernel's first pass lays out W_e's TF32 parts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: Widest output the kernel takes: a block owns whole output rows, so the
#: normalize epilogue can run in registers.
MAX_OUT_DIM = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rae_encode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rae_encode_launch.argtypes = [p, p, p, i, i, i, i, p, p]
    lib.rae_encode_launch.restype = i
    lib.rae_encode_scratch_bytes.argtypes = [i, i]
    lib.rae_encode_scratch_bytes.restype = ctypes.c_longlong
    return lib


def rae_encode_cuda(x: torch.Tensor, w_e: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
    """z [R, m] = x [R, n] @ w_e [n, m] (float32), optionally row-normalized
    by ``max(|z|, 1e-12)``. Both inputs: contiguous float32 on one CUDA
    device."""
    if x.device.type != "cuda" or w_e.device != x.device:
        raise ValueError(f"rae_encode_cuda needs both tensors on one CUDA "
                         f"device, got {x.device} and {w_e.device}")
    if x.dtype != torch.float32 or w_e.dtype != torch.float32:
        raise ValueError(f"rae_encode_cuda takes float32, got {x.dtype} "
                         f"and {w_e.dtype}")
    if x.dim() != 2 or w_e.dim() != 2 or x.shape[1] != w_e.shape[0]:
        raise ValueError(f"rae_encode_cuda shapes: x {tuple(x.shape)}, "
                         f"w_e {tuple(w_e.shape)}")
    if not (x.is_contiguous() and w_e.is_contiguous()):
        raise ValueError("rae_encode_cuda takes contiguous tensors")
    rows, n = x.shape
    m = w_e.shape[1]
    if not 1 <= m <= MAX_OUT_DIM:
        raise ValueError(f"rae_encode_cuda supports 1 <= m <= {MAX_OUT_DIM} "
                         f"(a block owns whole output rows), got m={m}")
    if n < 1 or rows >= 2 ** 31:
        raise ValueError(f"rae_encode_cuda shapes out of range: {rows}x{n}")
    lib = _lib()
    z = torch.empty((rows, m), device=x.device, dtype=torch.float32)
    # W_e's TF32 big and small parts, laid out for the tensor cores
    scratch = torch.empty(lib.rae_encode_scratch_bytes(n, m),
                          device=x.device, dtype=torch.uint8)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rae_encode_launch(x.data_ptr(), w_e.data_ptr(), z.data_ptr(),
                                rows, n, m, int(normalize), scratch.data_ptr(),
                                stream)
    if err != 0:
        raise RuntimeError(f"rae_encode kernel launch failed (cuda error "
                           f"{err})")
    if rows:
        _build.count_launch(rae_encode_cuda)
    return z


#: Kernel launches since the last reset (the main-path proof in chip_smoke).
rae_encode_cuda.launches = 0
