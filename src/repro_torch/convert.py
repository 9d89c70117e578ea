"""Carry weights across from the reference package.

The reference's RAE parameters are a dict of arrays under the same names
and layouts as the port's (``w_e`` [n, m], ``w_d`` [m, n], optional
``b_e``/``b_d``), so conversion is a copy onto the device. So are the model
parameter trees: the two-tower's flat dict of tables and MLP weights, and
the transformer's ``{"layers": {...}, "embed", "final_ln"[, "head"]}`` with
the layers stacked ``[L, ...]`` as the reference stacks them. Each leaf
keeps its dtype (bfloat16 included). Directories the reference saved need
no conversion: ``api.load_index`` reads them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(params: dict[str, np.ndarray],
                    device: str | torch.device = "cuda"
                    ) -> dict[str, torch.Tensor]:
    """The port's parameters from the reference's (as numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in jax_params.items()}``)."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(params: Any, device) -> Any:
    if isinstance(params, dict):
        return {k: _tree(v, device) for k, v in params.items()}
    return _leaf(params, device)


def recsys_params_from_jax(params: dict, device: str | torch.device = "cuda"
                           ) -> dict[str, torch.Tensor]:
    """The port's recsys parameters (``table_<name>``, ``<tower>_w<i>``,
    ``<tower>_b<i>``) from the reference's, leaf dtypes kept."""
    return _tree(params, device)


def transformer_params_from_jax(params: dict,
                                device: str | torch.device = "cuda") -> dict:
    """The port's transformer parameters from the reference's: the same
    tree, the layer weights stacked ``[L, ...]``, leaf dtypes kept."""
    return _tree(params, device)
