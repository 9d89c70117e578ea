"""Plain PyTorch version of the RAE encode: ``x @ W_e``, optionally
L2-normalized per row. The CPU path of :func:`..ops.rae_encode`, and what
the CUDA kernel is held against on the card. ``tf32_split`` is the operand
split of the kernel's 3xTF32 arithmetic, for the CPU tests of its
numerics."""
from __future__ import annotations

import torch


def rae_encode_ref(x: torch.Tensor, w_e: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    z = x.float() @ w_e.float()
    if normalize:
        z = z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                            min=1e-12)
    return z


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) float32 with ``big = rna(x)`` and ``small = rna(x -
    big)``, where ``rna`` rounds to TF32 (10 mantissa bits) to nearest,
    ties away from zero: the ``cvt.rna.tf32.f32`` the CUDA kernel splits
    each operand with before its three TF32 products (``big * big + big *
    small + small * big``). Emulated with integer operations on the float32
    bits: add half of the 13 dropped bits' weight to the magnitude, then
    clear them (a carry rounds up into the exponent)."""
    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        bits = (bits + 0x1000) & 0xFFFFE000
        bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
        return bits.to(torch.int32).view(torch.float32)

    x = x.float()
    big = rna(x)
    return big, rna(x - big)
