"""Binding of the hand-written CUDA decode attention
(``csrc/flash_decode.cu``).

Replaces the TPU kernel ``flash_decode_pallas``
(``src/repro/kernels/flash_decode/kernel.py``); the source file says how
it is laid out and what bounds it. The wrapper checks what the kernel
takes, picks the split of the KV axis, allocates the partials and the
output, launches both passes on PyTorch's current stream and raises if a
launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Blocks pass 1 aims for: one wave of two resident blocks (256 threads,
#: 48 KB of cp.async ring each) on each of the card's 132 SMs. A block
#: streams its split from a ring with loads in flight, so a few long
#: splits keep the bandwidth better than many short ones (on the H100 at
#: long_500k 264 blocks ran faster than 528, 1056 or 2048), and pass 2 has
#: few partials to merge. The split is chosen
#: from the cache's size S, never from ``cur_len``, which stays on the
#: device.
TARGET_BLOCKS = 2 * 132
#: Positions of the split granularity, ``kTile`` of the source (a stage of
#: a block at dh = 64 in bfloat16); the launch refuses a split that is not
#: a whole number of them.
TILE = 64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [p, p, p, i, p, p, p, p, p, i, i, i,
                                        i, i, i, i, ctypes.c_float, p]
    lib.flash_decode_launch.restype = i
    for name in ("flash_decode_max_dh", "flash_decode_max_gd",
                 "flash_decode_tile"):
        getattr(lib, name).restype = i
    if lib.flash_decode_tile() != TILE:
        raise RuntimeError(f"flash_decode: the kernel's tile is "
                           f"{lib.flash_decode_tile()}, kernel.py's {TILE}")
    return lib


def split_plan(b: int, kh: int, s: int, tile: int) -> tuple[int, int]:
    """(positions a pass-1 block takes, number of splits) for a cache of S
    positions: whole tiles, enough splits for about ``TARGET_BLOCKS``
    blocks, never more splits than tiles."""
    tiles = -(-s // tile)
    nsplit = max(1, min(tiles, -(-TARGET_BLOCKS // max(b * kh, 1))))
    per = -(-tiles // nsplit)
    nsplit = -(-tiles // per)
    return per * tile, nsplit


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cur_len: torch.Tensor
                      ) -> torch.Tensor:
    """q [B, kh, g, dh] float32; k_cache, v_cache [B, S, kh, dh] float32 or
    bfloat16 (one dtype); cur_len a 0-d int32 tensor; all contiguous on one
    CUDA device. Returns float32 [B, kh, g, dh]: attention over positions
    ``< clamp(cur_len, 0, S)``, zeros where that is 0."""
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (k_cache, v_cache, cur_len)):
        raise ValueError(f"flash_decode_cuda needs every tensor on one CUDA "
                         f"device, got {q.device}, {k_cache.device}, "
                         f"{v_cache.device}, {cur_len.device}")
    if q.dtype != torch.float32 or k_cache.dtype not in _DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"flash_decode_cuda takes float32 q and float32 or "
                         f"bfloat16 caches of one dtype, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if cur_len.dtype != torch.int32 or cur_len.numel() != 1:
        raise ValueError(f"flash_decode_cuda takes cur_len as one int32, got "
                         f"{cur_len.dtype} {tuple(cur_len.shape)}")
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[2] != q.shape[1] \
            or k_cache.shape[3] != q.shape[3]:
        raise ValueError(f"flash_decode_cuda shapes: q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("flash_decode_cuda takes contiguous tensors")
    b, kh, g, dh = q.shape
    s = k_cache.shape[1]
    lib = _lib()
    if not 1 <= dh <= lib.flash_decode_max_dh():
        raise ValueError(f"flash_decode kernel supports 1 <= dh <= "
                         f"{lib.flash_decode_max_dh()}, got dh={dh}")
    if g * dh > lib.flash_decode_max_gd():
        raise ValueError(f"flash_decode kernel supports g * dh <= "
                         f"{lib.flash_decode_max_gd()} (the partials a "
                         f"block merges), got g={g}, dh={dh}")
    if s < 1 or b > 65535 or kh > 65535:
        raise ValueError(f"flash_decode_cuda shapes out of range: B={b}, "
                         f"S={s}, kh={kh}")
    split, nsplit = split_plan(b, kh, s, TILE)
    out = torch.empty((b, kh, g, dh), device=dev, dtype=torch.float32)
    pm = torch.empty((b, kh, nsplit, g), device=dev, dtype=torch.float32)
    pl = torch.empty_like(pm)
    pacc = torch.empty((b, kh, nsplit, g, dh), device=dev,
                       dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        _DTYPES[k_cache.dtype], cur_len.data_ptr(), pm.data_ptr(),
        pl.data_ptr(), pacc.data_ptr(), out.data_ptr(), b, s, kh, g, dh,
        split, nsplit, dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (cuda error "
                           f"{err})")
    if b and kh and g:
        _build.count_launch(flash_decode_cuda)
    return out


#: Wrapper calls that launched the kernel (both passes count as one) since
#: the last reset (the main-path proof in chip_smoke).
flash_decode_cuda.launches = 0
