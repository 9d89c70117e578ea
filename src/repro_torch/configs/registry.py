"""Arch registry: arch id -> (config, family), and its shape cells.

Only the architectures the port runs are here, and the paper's own RAE
configuration (``rae_paper``, family ``rae``: no shape cells, and kept out
of ``ARCH_IDS`` as the reference keeps it); every other arch id of the
reference's registry raises, naming the ROADMAP.md item that ports it."""
from __future__ import annotations

import importlib
from typing import Any

from .base import ShapeCell
from .shapes import shapes_for_family

_ARCH_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "two-tower-retrieval": "two_tower_retrieval",
    "rae_paper": "rae_paper",
}

#: arch ids of the reference's registry that the port does not run yet
_NOT_PORTED = {
    "qwen3-moe-235b-a22b": "the MoE family (ROADMAP.md queue A item 15)",
    "granite-moe-1b-a400m": "the MoE family (ROADMAP.md queue A item 15)",
    "phi3-medium-14b": "a dense LM at 14B (ROADMAP.md queue A item 15)",
    "qwen2-7b": "a dense LM at 7B (ROADMAP.md queue A item 15)",
    "graphsage-reddit": "the GNN family (ROADMAP.md queue A item 15)",
    "bst": "the bst recsys model (ROADMAP.md queue A item 15)",
    "autoint": "the autoint recsys model (ROADMAP.md queue A item 15)",
    "mind": "the mind recsys model (ROADMAP.md queue A item 15)",
}

ARCH_IDS = tuple(k for k in _ARCH_MODULES if k != "rae_paper")


def get_arch(arch_id: str) -> tuple[Any, str]:
    """Return (config, family) for an arch id."""
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported: "
                                  f"{_NOT_PORTED[arch_id]}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"{__package__}.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG, mod.FAMILY


def get_shapes(arch_id: str) -> tuple[ShapeCell, ...]:
    _, family = get_arch(arch_id)
    if family == "rae":
        return ()
    return shapes_for_family(family)
