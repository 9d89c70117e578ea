"""Fault tolerance: supervised training loop, straggler watchdog, restart.

The reference's ``distributed/fault_tolerance.py`` on one device.
``TrainingSupervisor`` wraps any ``(state..., batch) -> (state...,
metrics)`` step function with:

* periodic async checkpoints and auto-resume from the newest valid one
  (corrupt or partial checkpoints are skipped, see ``checkpoint.py``);
* deterministic step-indexed data (the batch function is pure in the
  step, so a resumed run replays the exact stream);
* a straggler watchdog (an EWMA of step wall time; steps slower than
  ``threshold`` x EWMA are recorded);
* crash injection for tests (``fail_at_step``).

A step's wall time is taken on the host clock around the enqueue; at each
log point one ``torch.cuda.synchronize`` waits for the card (the
reference's ``jax.block_until_ready``) before the metrics are read. The
reference's ``state_shardings`` (restoring under a mesh's shardings) has
no counterpart on one card: restored leaves go to the devices of the
initial state's leaves.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..pytree import leaves
from .checkpoint import CheckpointManager


@dataclass
class WatchdogReport:
    slow_steps: list[tuple[int, float]] = field(default_factory=list)
    ewma_s: float = 0.0


class StragglerWatchdog:
    def __init__(self, threshold: float = 3.0, warmup: int = 10,
                 alpha: float = 0.1):
        self.threshold = threshold
        self.warmup = warmup
        self.alpha = alpha
        self.report = WatchdogReport()
        self._n = 0

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self._n += 1
        r = self.report
        if self._n <= self.warmup:
            r.ewma_s = dt if r.ewma_s == 0 else (
                (1 - self.alpha) * r.ewma_s + self.alpha * dt)
            return False
        slow = dt > self.threshold * r.ewma_s
        if slow:
            r.slow_steps.append((step, dt))
        else:  # a straggler's sample stays out of the EWMA
            r.ewma_s = (1 - self.alpha) * r.ewma_s + self.alpha * dt
        return slow


class SimulatedFailure(RuntimeError):
    pass


def _wait_for_device(state: Any) -> None:
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves(state)):
        torch.cuda.synchronize()


class TrainingSupervisor:
    def __init__(
        self,
        step_fn: Callable,                     # (state..., batch) -> state..., metrics
        init_state: tuple,                     # e.g. (params, opt_state)
        batch_fn: Callable[[int], Any],        # step -> device-ready batch
        checkpoint_dir: Optional[str] = None,
        save_every: int = 100,
        keep: int = 3,
        watchdog: Optional[StragglerWatchdog] = None,
    ):
        self.step_fn = step_fn
        self.state = init_state
        self.batch_fn = batch_fn
        self.save_every = save_every
        self.watchdog = watchdog or StragglerWatchdog()
        self.ckpt = (CheckpointManager(checkpoint_dir, keep=keep)
                     if checkpoint_dir else None)
        self.start_step = 0
        self.metrics_log: list[dict] = []
        if self.ckpt is not None:
            latest = None
            for s in reversed(self.ckpt.all_steps()):
                if self.ckpt._valid(s):
                    latest = s
                    break
            if latest is not None:
                restored = self.ckpt.restore_into(latest,
                                                  {"state": self.state})
                self.state = restored["state"]
                self.start_step = latest

    def run(self, total_steps: int, fail_at_step: Optional[int] = None,
            log_every: int = 50) -> dict:
        step = self.start_step
        while step < total_steps:
            if fail_at_step is not None and step == fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            *state, metrics = self.step_fn(*self.state, batch)
            self.state = tuple(state)
            step += 1
            if step % log_every == 0 or step == total_steps:
                _wait_for_device(self.state)
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                self.metrics_log.append(m)
            dt = time.perf_counter() - t0
            self.watchdog.observe(step, dt)
            if self.ckpt is not None and step % self.save_every == 0:
                self.ckpt.save(step, {"state": self.state})
        if self.ckpt is not None:
            self.ckpt.save(total_steps, {"state": self.state})
            self.ckpt.wait()
        return {"final_step": step, "watchdog": self.watchdog.report,
                "metrics": self.metrics_log}
