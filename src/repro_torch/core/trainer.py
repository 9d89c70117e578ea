"""RAE trainer on one device.

Faithful to the paper (AdamW with weight decay = lambda, batch 128, 3000
steps, cosine annealing 1e-3 -> 1e-5). Batches are drawn on the host with a
per-step numpy seed (the reference's ``_batch_sampler``, copied exactly),
so both packages see the identical batch sequence. The RAE has no
hand-written kernel: its products run through ``torch.matmul`` under
autograd, as the reference leaves them to XLA.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import RAEConfig
from ..optim import AdamW, cosine_annealing
from . import rae


@dataclass
class TrainResult:
    params: Any
    opt_state: Any
    history: list[dict[str, float]] = field(default_factory=list)
    wall_time_s: float = 0.0
    steps_run: int = 0
    #: steps that took over 5x the mean of the 20 before them, as
    #: ``{"step", "straggler_step_s"}``; kept apart from ``history`` so
    #: that its last record is always the last loss record
    stragglers: list[dict[str, float]] = field(default_factory=list)


def make_optimizer(cfg: RAEConfig) -> AdamW:
    wd = 0.0 if cfg.explicit_frobenius else cfg.weight_decay
    return AdamW(
        lr=cosine_annealing(cfg.lr_max, cfg.lr_min, cfg.steps),
        weight_decay=wd,
    )


def make_train_step(cfg: RAEConfig, opt: AdamW):
    def step_fn(params, opt_state, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, aux = rae.loss_fn(leaves, batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params, opt_state, om = opt.update(dict(zip(leaves, grads)),
                                           opt_state, params)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return params, opt_state, metrics

    return step_fn


def _batch_sampler(data: np.ndarray, batch_size: int, seed: int):
    """Deterministic, step-indexed batch sampling (resumable at any step)."""
    n = data.shape[0]
    root = np.random.SeedSequence(seed)

    def batch_at(step: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence(
            entropy=root.entropy, spawn_key=(step,)))
        idx = rng.integers(0, n, size=batch_size)
        return data[idx]

    return batch_at


def train(
    cfg: RAEConfig,
    data: np.ndarray,
    log_every: int = 100,
    init_params: Optional[dict[str, torch.Tensor]] = None,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Train RAE on an embedding corpus ([N, n] float array, on the host).

    ``init_params`` starts from given weights (for example the reference's
    init through ``convert.params_from_jax``) instead of ``rae.init``."""
    if data.shape[1] != cfg.in_dim:
        raise ValueError(f"data dim {data.shape[1]} != cfg.in_dim "
                         f"{cfg.in_dim}")
    opt = make_optimizer(cfg)
    step_fn = make_train_step(cfg, opt)
    if init_params is None:
        params = rae.init(cfg, torch.Generator().manual_seed(cfg.seed),
                          device=device)
    else:
        params = {k: v.detach().to(device=device, dtype=torch.float32)
                  for k, v in init_params.items()}
    opt_state = opt.init(params)

    sample = _batch_sampler(data, cfg.batch_size, cfg.seed)
    history: list[dict[str, float]] = []
    stragglers: list[dict[str, float]] = []
    t0 = time.perf_counter()
    step_times: list[float] = []

    for step in range(cfg.steps):
        ts = time.perf_counter()
        batch = torch.as_tensor(sample(step), dtype=torch.float32,
                                device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == cfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
        step_times.append(time.perf_counter() - ts)
        if len(step_times) > 20:
            ewma = float(np.mean(step_times[-20:]))
            if step_times[-1] > 5 * ewma and step > 20:
                stragglers.append({"step": step,
                                   "straggler_step_s": step_times[-1]})

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return TrainResult(params=params, opt_state=opt_state, history=history,
                       wall_time_s=wall, steps_run=cfg.steps,
                       stragglers=stragglers)


def fit_transform(cfg: RAEConfig, train_data: np.ndarray,
                  eval_data: np.ndarray, **kw
                  ) -> tuple[np.ndarray, TrainResult]:
    """sklearn-style convenience: train, then encode eval_data."""
    res = train(cfg, train_data, **kw)
    w = res.params["w_e"]
    z = rae.encode(res.params, torch.as_tensor(eval_data, dtype=torch.float32,
                                               device=w.device))
    return z.detach().cpu().numpy(), res
