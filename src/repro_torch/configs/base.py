"""Configuration dataclasses of the port (the RAE only, so far)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class RAEConfig:
    """The paper's own technique (Section 3.2) as a first-class config.

    Field for field the reference's ``RAEConfig``, so a ``meta.json`` that
    either package saved loads in the other."""

    name: str = "rae_paper"
    in_dim: int = 768
    out_dim: int = 384
    # lambda: regularization coefficient; realised as AdamW decoupled weight
    # decay (paper's experimental setup) or as an explicit Frobenius term in
    # the loss (paper's Eq. 7) when explicit_frobenius=True.
    weight_decay: float = 1e-2
    explicit_frobenius: bool = False
    use_bias: bool = False  # paper footnote 2: biases cancel in distances
    steps: int = 3000
    batch_size: int = 128
    lr_max: float = 1e-3
    lr_min: float = 1e-5
    seed: int = 0
    param_dtype: str = "float32"

    def replace(self, **kw) -> "RAEConfig":
        return dataclasses.replace(self, **kw)
