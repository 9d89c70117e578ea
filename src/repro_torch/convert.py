"""Carry weights across from the reference package.

The reference's RAE parameters are a dict of arrays under the same names
and layouts as the port's (``w_e`` [n, m], ``w_d`` [m, n], optional
``b_e``/``b_d``), so conversion is a copy onto the device. Directories the
reference saved need no conversion: ``api.load_index`` reads them.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict[str, np.ndarray],
                    device: str | torch.device = "cuda"
                    ) -> dict[str, torch.Tensor]:
    """The port's parameters from the reference's (as numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in jax_params.items()}``)."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}
