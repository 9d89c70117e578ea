"""Gradient compression for data parallelism across devices.

The reference's ``distributed/compression.py``: per-tensor symmetric int8
quantization (``int8_compress`` / ``int8_decompress``) and the error-
feedback residual state (``ErrorFeedbackState``, ``ef_init``), held to the
reference element for element. The reducing helpers (``psum_bf16``,
``psum_int8``, ``ef_compress_psum``) wrap an all-reduce over a mesh axis;
one card has no axis to reduce over, so they raise, naming the ROADMAP
item that ports the multi-card path (queue A item 10), as
``api/sharded.py`` does for ``workers="mesh"``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..pytree import tree_map

MESH_NOT_PORTED = ("an all-reduce over a mesh axis needs several cards; the "
                   "port runs on one (ROADMAP.md queue A item 10)")


class Int8Compressed(NamedTuple):
    q: torch.Tensor      # int8 payload
    scale: torch.Tensor  # per-tensor scale, float32


def int8_compress(g: torch.Tensor) -> Int8Compressed:
    """``q = clip(round(g / scale), -127, 127)`` with ``scale = (max |g| +
    1e-12) / 127``, rounding half to even; divisions by tensors (IEEE
    quotients on every device)."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return Int8Compressed(q=q, scale=scale)


def int8_decompress(c: Int8Compressed) -> torch.Tensor:
    return c.q.float() * c.scale


class ErrorFeedbackState(NamedTuple):
    residual: Any  # a tree like the grads, float32


def ef_init(grads_like: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def psum_bf16(tree: Any, axis_name) -> Any:
    """All-reduce in bfloat16 over a mesh axis: not on one card."""
    raise NotImplementedError(MESH_NOT_PORTED)


def psum_int8(tree: Any, axis_name) -> Any:
    """Int8 all-reduce over a mesh axis: not on one card."""
    raise NotImplementedError(MESH_NOT_PORTED)


def ef_compress_psum(grads: Any, state: ErrorFeedbackState, axis_name):
    """Error-feedback int8 all-reduce over a mesh axis: not on one card."""
    raise NotImplementedError(MESH_NOT_PORTED)
