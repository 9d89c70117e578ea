"""AdamW with decoupled weight decay (the paper's lambda), line for line
the reference's ``optim/adamw.py`` on dicts of tensors.

Decoupled decay ``w -= lr * wd * w`` is the exact gradient-descent step of
``0.5 * wd * ||W||_F^2`` rescaled by lr, so it implements the Frobenius
term without polluting the Adam moments. Three details differ from
``torch.optim.AdamW`` and are kept: ``lr`` is evaluated at the step
*before* the increment, the update is ``p - lr * (u + wd * p)``, and only
parameters with ``ndim >= 2`` decay (unless ``decay_mask`` says otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # params -> {name: bool}; None = decay everything 2D+
    decay_mask: Optional[Callable[[Any], Any]] = None
    clip_norm: float = 0.0
    moment_dtype: Optional[str] = None

    def _mdt(self, p: torch.Tensor) -> torch.dtype:
        return getattr(torch, self.moment_dtype) if self.moment_dtype \
            else p.dtype

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        zeros = {k: torch.zeros_like(p, dtype=self._mdt(p))
                 for k, p in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32), m=zeros,
                          v={k: torch.zeros_like(p, dtype=self._mdt(p))
                             for k, p in params.items()})

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32)

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params: dict[str, torch.Tensor]
               ) -> tuple[dict[str, torch.Tensor], AdamWState,
                          dict[str, torch.Tensor]]:
        step = state.step + 1
        lr = self._lr(state.step)
        gnorm = global_norm(grads)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}

        b1, b2 = self.b1, self.b2
        m = {k: (b1 * mu.float() + (1 - b1) * grads[k].float()).to(mu.dtype)
             for k, mu in state.m.items()}
        v = {k: (b2 * nu.float()
                 + (1 - b2) * torch.square(grads[k].float())).to(nu.dtype)
             for k, nu in state.v.items()}
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), stepf)

        if self.decay_mask is not None:
            mask = self.decay_mask(params)
        else:
            mask = {k: p.dim() >= 2 for k, p in params.items()}

        def upd(p, mu, nu, decay_ok):
            mu, nu = mu.float(), nu.float()
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            wd = self.weight_decay if self.weight_decay else 0.0
            decay = (wd * p.float()) if wd else 0.0
            decay = decay * float(decay_ok)
            return (p.float() - lr * (u + decay)).to(p.dtype)

        new_params = {k: upd(p, m[k], v[k], mask[k])
                      for k, p in params.items()}
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, AdamWState(step=step, m=m, v=v), metrics


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))
