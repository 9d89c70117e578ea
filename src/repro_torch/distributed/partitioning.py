"""Parameter schemas and corpus partitioning.

``ParamDef`` and ``init_from_schema`` are the reference's single-schema
parameter declaration (``distributed/partitioning.py:32,183``): a model
declares each parameter's shape, dtype, logical axes and initializer once.
The logical axes name how the reference shards a parameter over a mesh;
the port runs on one card and keeps them only as documentation. JAX's
``fold_in`` draws cannot be reproduced in PyTorch, so the port draws each
leaf from its own ``torch.Generator`` and parity tests carry the
reference's weights across with ``convert.py``.

The two partitioners are the reference's (lines 235-285). Both return
disjoint covers of the rows as int32 global-id arrays, ascending within
each shard: the merge's tie-break (lower global id) then matches each
shard's own tie order, which is what makes sharded answers invariant to
the shard count. The reference's mesh and rule-table helpers are JAX-only
and have no counterpart here.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def zlib_crc(s: str) -> int:
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


def _tree_map_defs(fn: Callable[[str, ParamDef], Any], schema: Any,
                   prefix: str = "") -> Any:
    if isinstance(schema, ParamDef):
        return fn(prefix, schema)
    if isinstance(schema, dict):
        return {k: _tree_map_defs(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in schema.items()}
    raise TypeError(f"bad schema node at {prefix}: {type(schema)}")


def leaf_std(d: ParamDef) -> float:
    """The standard deviation a random leaf is drawn with: ``scale``, else
    0.02 (``normal``, ``embed``) or 1/sqrt(fan_in) (``fan_in``)."""
    if d.scale is not None:
        return d.scale
    if d.init in ("normal", "embed"):
        return 0.02
    if d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return 1.0 / math.sqrt(fan_in)
    raise ValueError(f"no std for init {d.init!r}")


def init_from_schema(schema: Any, seed: int = 0,
                     device: str | torch.device = "cuda") -> Any:
    """Materialize parameters on ``device``. Each random leaf is drawn in
    float32 from a ``torch.Generator`` on the device, seeded from ``seed``
    and the leaf's path (so the draws do not depend on the schema's order),
    then cast to the leaf's dtype."""
    device = torch.device(device)

    def make(path: str, d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        if d.init not in ("normal", "embed", "fan_in"):
            raise ValueError(f"unknown init {d.init!r} at {path}")
        gen = torch.Generator(device=device).manual_seed(
            zlib_crc(f"{seed}:{path}"))
        x = torch.empty(d.shape, dtype=torch.float32, device=device)
        x.normal_(0.0, leaf_std(d), generator=gen)
        return x if d.dtype == torch.float32 else x.to(d.dtype)

    return _tree_map_defs(make, schema)


def partition_rows(n: int, n_shards: int) -> list[np.ndarray]:
    """Contiguous, balanced row ranges: shard i gets ``n // n_shards`` rows
    (+1 for the first ``n % n_shards`` shards), so a ragged corpus never
    drops its tail."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_shards = min(n_shards, max(n, 1))
    base, rem = divmod(n, n_shards)
    parts, start = [], 0
    for i in range(n_shards):
        size = base + (1 if i < rem else 0)
        parts.append(np.arange(start, start + size, dtype=np.int32))
        start += size
    return parts


def partition_ivf_cells(corpus, n_shards: int, n_cells: int = 0,
                        kmeans_iters: int = 10, seed: int = 0,
                        init: Optional[np.ndarray] = None
                        ) -> list[np.ndarray]:
    """Cluster the corpus into k-means cells and bin-pack whole cells onto
    shards (largest cell first, onto the lightest shard). The k-means runs
    on the corpus's device (a tensor's, or the CPU for a numpy array) from
    the port's seeded init, or from ``init`` rows (see ``search.ivf``)."""
    from ..search.ivf import kmeans

    x = torch.as_tensor(corpus, dtype=torch.float32)
    n = int(x.shape[0])
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_shards = min(n_shards, max(n, 1))
    if n_shards == 1:
        return [np.arange(n, dtype=np.int32)]
    n_cells = min(n_cells or 8 * n_shards, n)
    _, assign = kmeans(x, n_cells, iters=kmeans_iters, seed=seed, init=init)
    assign = assign.cpu().numpy()
    members = [np.flatnonzero(assign == c) for c in range(n_cells)]
    order = np.argsort([-len(m) for m in members], kind="stable")
    loads = np.zeros(n_shards, np.int64)
    buckets: list[list[np.ndarray]] = [[] for _ in range(n_shards)]
    for c in order:
        s = int(np.argmin(loads))
        buckets[s].append(members[c])
        loads[s] += len(members[c])
    return [np.sort(np.concatenate(b)).astype(np.int32) if b
            else np.empty(0, np.int32) for b in buckets]
