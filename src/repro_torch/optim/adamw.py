"""AdamW with decoupled weight decay (the paper's lambda), line for line
the reference's ``optim/adamw.py`` on trees of tensors (nested dicts, as
the models' parameters are; ``pytree`` walks them in JAX's order, so the
global norm sums the leaves in the reference's order).

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

from ..pytree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the host
    m: Any              # a tree like the parameters
    v: Any


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

    def init(self, params: Any) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=self._mdt(p))

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> tuple[Any, AdamWState, dict[str, torch.Tensor]]:
        step = state.step + 1
        lr = self._lr(state.step)
        gnorm = global_norm(grads)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)

        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mu, g: (b1 * mu.float()
                                    + (1 - b1) * g.float()).to(mu.dtype),
                     state.m, grads)
        v = tree_map(lambda nu, g: (b2 * nu.float() + (1 - b2)
                                    * torch.square(g.float())).to(nu.dtype),
                     state.v, grads)
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), stepf)

        if self.decay_mask is not None:
            mask = self.decay_mask(params)
        else:
            mask = tree_map(lambda p: p.dim() >= 2, params)

        def upd(p, mu, nu, decay_ok):
            mu, nu = mu.float(), nu.float()
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            wd = self.weight_decay if self.weight_decay else 0.0
            decay = (wd * p.float()) if wd else 0.0
            decay = decay * float(decay_ok)
            return (p.float() - lr * (u + decay)).to(p.dtype)

        new_params = tree_map(upd, params, m, v, mask)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, AdamWState(step=step, m=m, v=v), metrics


def global_norm(tree: Any) -> torch.Tensor:
    xs = leaves(tree)
    if not xs:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in xs))
