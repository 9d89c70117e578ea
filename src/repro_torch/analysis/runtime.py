"""Runtime guard: a budget for what a cold path pays on the card.

The reference counts XLA backend compiles; the port has no per-shape
compile. What a cold path pays instead is counted here:

- every ``nvcc`` build and every kernel-library load in
  ``kernels/_build.py`` (a library loads once a process, at its first
  launch);
- every graph ``torch.compile`` (dynamo) compiles, should one appear (the
  port calls none today).

:func:`no_retrace` raises :class:`RetraceError` when a block pays more than
its budget. Budget 0 is the serving invariant: after
``SearchEngine.warmup``, a mixed-size, mixed-k query storm pays nothing.

The reference's ``no_host_to_device`` wraps
``jax.transfer_guard_host_to_device``; PyTorch has no such guard, and the
port does not imitate one.
"""
from __future__ import annotations

import sys
from contextlib import contextmanager

from ..kernels import _build


class RetraceError(RuntimeError):
    """A guarded block paid more cold-path events than its budget allows."""


def _dynamo_compiles() -> int:
    # dynamo compiles nothing unless it was imported: never import it here
    if "torch._dynamo" not in sys.modules:
        return 0
    from torch._dynamo.utils import counters

    return int(counters["stats"]["unique_graphs"])


def compile_count() -> int:
    """Kernel builds, library loads and dynamo graph compiles seen so far
    in this process (monotonic; only differences mean something)."""
    return _build.cold_events() + _dynamo_compiles()


@contextmanager
def no_retrace(budget: int = 0, what: str = "guarded block"):
    """Assert the block pays at most ``budget`` cold-path events. Yields a
    zero-argument callable returning the events paid so far::

        with no_retrace(budget=0, what="warm query storm") as used:
            for q in storm:
                engine.search_one(q, k=10)
            assert used() == 0
    """
    start = compile_count()
    yield lambda: compile_count() - start
    used = compile_count() - start
    if used > budget:
        raise RetraceError(
            f"{what}: {used} kernel build(s), library load(s) or graph "
            f"compile(s), budget {budget}: a path ran that warm-up never "
            f"ran")
