"""RAE — Regularized Auto-Encoder (the paper's core contribution, Section 3.2).

A *linear* autoencoder:  x_hat = W_d @ W_e @ x  with W_e in R^{m x n},
W_d in R^{n x m}, trained on

    L = ||W_d W_e x - x||_2^2 + lambda * (||W_e||_F^2 + ||W_d||_F^2)   (Eq. 7)

The paper realises lambda as AdamW decoupled weight decay (Section 4.1);
``explicit_frobenius=True`` instead adds the Frobenius term to the loss.
The trained encoder is the dimensionality-reduction map f(x) = W_e x.

Parameters live in a plain dict of tensors under the reference's names and
layouts (``w_e`` [n, m], ``w_d`` [m, n], optional ``b_e``/``b_d``), so the
two packages' weights and saved directories carry across unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import RAEConfig

Params = dict[str, torch.Tensor]


def init(cfg: RAEConfig, generator: Optional[torch.Generator] = None,
         device: str | torch.device = "cuda") -> Params:
    """Fan-in init: every weight ~ N(0, 1/fan_in) with fan_in its first
    dimension (the reference's ``init="fan_in"``), biases zero. Drawn on the
    CPU from ``generator`` (default: seeded with ``cfg.seed``) and moved to
    ``device``, so a seed gives the same weights on every device. The
    reference draws from ``jax.random``, which torch cannot reproduce: to
    start both packages from one init, convert the reference's
    (``convert.params_from_jax``)."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    dt = getattr(torch, cfg.param_dtype)
    n, m = cfg.in_dim, cfg.out_dim
    p = {
        "w_e": torch.randn((n, m), generator=g) / math.sqrt(n),
        "w_d": torch.randn((m, n), generator=g) / math.sqrt(m),
    }
    if cfg.use_bias:
        p["b_e"] = torch.zeros(m)
        p["b_d"] = torch.zeros(n)
    return {k: v.to(device=device, dtype=dt) for k, v in p.items()}


def encode(params: Params, x: torch.Tensor) -> torch.Tensor:
    """f(x) = x @ W_e (+ b_e). x: [..., n] -> [..., m]."""
    y = x @ params["w_e"]
    if "b_e" in params:
        y = y + params["b_e"]
    return y


def decode(params: Params, z: torch.Tensor) -> torch.Tensor:
    y = z @ params["w_d"]
    if "b_d" in params:
        y = y + params["b_d"]
    return y


def reconstruct(params: Params, x: torch.Tensor) -> torch.Tensor:
    return decode(params, encode(params, x))


def loss_fn(params: Params, x: torch.Tensor, cfg: RAEConfig
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean-over-batch squared reconstruction error (+ optional Frobenius
    term)."""
    x = x.float()
    x_hat = reconstruct(params, x).float()
    recon = torch.mean(torch.sum(torch.square(x_hat - x), dim=-1))
    loss = recon
    frob = frobenius_sq(params)
    if cfg.explicit_frobenius:
        loss = loss + cfg.weight_decay * frob
    return loss, {"recon": recon, "frobenius_sq": frob}


def frobenius_sq(params: Params) -> torch.Tensor:
    """||W_e||_F^2 + ||W_d||_F^2 (biases excluded, matching Eq. 7)."""
    tot = torch.zeros((), dtype=torch.float32, device=params["w_e"].device)
    for k in ("w_e", "w_d"):
        if k in params:
            tot = tot + torch.sum(torch.square(params[k].float()))
    return tot


def encoder_matrix(params: Params) -> torch.Tensor:
    """W_e as the paper writes it: [m, n] (maps R^n -> R^m)."""
    return params["w_e"].T
