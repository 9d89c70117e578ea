"""Training launcher on the port's ``models.registry`` train cells.

Examples::

  # smoke-scale run (reduced config and cell) with checkpoints and
  # auto-resume: a second run with the same --checkpoint-dir resumes from
  # its newest valid checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --shape train_4k --scale smoke --steps 50 --checkpoint-dir /tmp/ck

  # the same on the CPU (the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch two-tower-retrieval --scale smoke --steps 50 --device cpu

The reference's ``launch/train.py`` on one device: ``make_batch_fn`` draws
the reference's batches (step ``s`` with seed ``seed + s``), the cell's
step runs under ``TrainingSupervisor`` (checkpoints every ``--save-every``
steps, auto-resume, the straggler watchdog). ``--device`` (``cuda`` by
default; without a card it fails, ``--device cpu`` runs the plain
versions) takes the place of the reference's ``--mesh``: one card has no
mesh. ``--scale full`` trains the published cell as it is, and refuses one
whose reckoned bytes (``reckon_bytes``) exceed the card's memory, as the
reference refuses a full cell off its pod. ``--fail-at-step`` is the
supervisor's crash injection (the resumed run's state equals an
uninterrupted run's, bit for bit). The dense LM (llama3.2-1b) and the
two-tower are ported; the other archs raise, naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs import get_arch, get_shapes
from ..configs.reduce import reduce_cell, reduce_config
from ..distributed.fault_tolerance import (SimulatedFailure, StragglerWatchdog,
                                           TrainingSupervisor)
from ..models import registry as reg
from ..models.common import dtype_of
from ..models.recsys import two_tower as tt_m
from ..models.registry import build_cell_with
from ..models.transformer import model as tm

RAE_NOT_A_CELL = ("rae_paper is the RAE's own configuration: it trains "
                  "through repro_torch.core.trainer.train "
                  "(api.make_reducer('rae'), ROADMAP.md queue A item 3), not "
                  "through a train cell")


def _check_trainable(arch_id: str, cfg, family: str) -> None:
    if family == "rae":
        raise NotImplementedError(RAE_NOT_A_CELL)
    if family == "recsys" and cfg.kind != "two_tower":
        raise NotImplementedError(f"recsys model {cfg.kind!r} is not ported: "
                                  f"ROADMAP.md queue A item 15")
    if family not in ("lm", "recsys"):
        raise NotImplementedError(f"{arch_id}: the {family} family is not "
                                  f"ported: ROADMAP.md queue A item 15")


def make_batch_fn(arch_id: str, cfg, family: str, cell, seed: int = 0,
                  device: str | torch.device = "cuda"):
    """Deterministic (step -> batch on ``device``): the reference's draws
    for the ``lm`` and ``two_tower`` kinds (``models.registry.train_batch``
    at seed ``seed + step``)."""
    _check_trainable(arch_id, cfg, family)
    return lambda step: reg.train_batch(cfg, family, cell, seed + step,
                                        device)


def init_for(cfg, family: str, seed: int = 0,
             device: str | torch.device = "cuda"):
    """The parameters of a train cell's model, drawn from ``seed`` on
    ``device``."""
    if family == "lm":
        return tm.init(cfg, seed, device)
    return tt_m.init(cfg, seed, device)


def _numel(schema) -> tuple[int, int]:
    """(elements, bytes) of a parameter schema's leaves."""
    from ..distributed.partitioning import ParamDef
    from ..pytree import leaves

    defs = [d for d in leaves(schema) if isinstance(d, ParamDef)]
    n = sum(int(torch.Size(d.shape).numel()) for d in defs)
    b = sum(int(torch.Size(d.shape).numel())
            * torch.empty((), dtype=d.dtype).element_size() for d in defs)
    return n, b


def reckon_bytes(cfg, family: str, cell) -> dict[str, int]:
    """The device bytes a train step of the cell holds at its peak, as the
    larger of two moments:

    - the backward: parameters, moments, the gradients, and the
      activations (LM, ``cfg.remat``: the residual stream at each layer's
      input, one layer's recompute, whose blockwise float32 attention keeps
      three ``[B, S, H, T]`` float32 score tensors over its KV chunks, the
      bfloat16 layer stack and its gradient, one cross-entropy chunk's
      three ``[B, C, Vp]`` float32 tensors; two-tower: the ``[B, B]``
      float32 in-batch logits, their scaled copy, the logsumexp's shifted
      exponentials and their gradient);
    - the optimizer update: old and new parameters and moments, the
      gradients and their clipped copy.

    A reckoning, not a measurement: ``chip_smoke.py`` phase 11 prints it
    beside the measured peak."""
    if family == "lm":
        n, p_bytes = _numel(tm.schema(cfg))
        m_bytes = n * torch.empty((), dtype=dtype_of(
            cfg.moment_dtype)).element_size() * 2
        b, s = cell.global_batch, cell.seq_len
        d, h, L = cfg.d_model, cfg.n_heads, cfg.n_layers
        cb = torch.empty((), dtype=dtype_of(cfg.compute_dtype)).element_size()
        layer_n = _numel(tm.schema(cfg)["layers"])[0]
        c = cfg.xent_chunk or min(s, 512)
        act = (L * b * s * d * cb                       # residual stream
               + 3 * b * s * h * s * 4                  # one layer's scores
               + 2 * layer_n * cb                       # cast stack + grad
               + 3 * b * c * tm.padded_vocab(cfg) * 4)  # one xent chunk
        g_bytes = n * 4
    else:
        _, p_bytes = _numel(tt_m.schema(cfg))
        m_bytes = 2 * p_bytes
        g_bytes = p_bytes
        b = cell.global_batch
        act = 4 * b * b * 4
    backward = p_bytes + m_bytes + g_bytes + act
    update = 2 * p_bytes + 2 * m_bytes + 2 * g_bytes
    return {"params": p_bytes, "moments": m_bytes, "grads": g_bytes,
            "activations": act, "peak": max(backward, update)}


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the step runs (cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="raise the supervisor's SimulatedFailure before "
                         "this step (checkpoints already written are kept)")
    args = ap.parse_args(argv)

    cfg, family = get_arch(args.arch)
    _check_trainable(args.arch, cfg, family)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is false): "
                         "train on the card, or pass --device cpu to run "
                         "the kernels' plain versions")
    shapes = {c.name: c for c in get_shapes(args.arch)}
    train_cells = [c for c in shapes.values() if c.kind == "train"]
    cell = shapes[args.shape] if args.shape else train_cells[0]
    if cell.kind != "train":
        raise SystemExit(f"{args.arch}/{cell.name} is a {cell.kind} cell, "
                         f"not a train cell")

    if args.scale == "smoke":
        cfg = reduce_config(cfg, family)
        cell = reduce_cell(cell, family)
    else:
        if device.type != "cuda":
            raise SystemExit("full-scale training runs on the card; use "
                             "--scale smoke on the CPU")
        need = reckon_bytes(cfg, family, cell)
        have = torch.cuda.get_device_properties(device).total_memory
        if need["peak"] > have:
            raise SystemExit(
                f"{args.arch}/{cell.name} at full scale reckons "
                f"{need['peak'] / 1e9:.1f} GB at its peak "
                f"({ {k: round(v / 1e9, 2) for k, v in need.items()} } GB) "
                f"and the card holds {have / 1e9:.1f} GB: it needs several "
                f"cards (ROADMAP.md queue A item 10); use --scale smoke, or "
                f"chip_smoke.py phase 11 for the published widths at a cut "
                f"batch")

    prog = build_cell_with(cfg, family, args.arch, cell, device)
    params = init_for(cfg, family, args.seed, device)
    opt_state = prog.init_opt(params)
    batch_fn = make_batch_fn(args.arch, cfg, family, cell, seed=args.seed,
                             device=device)
    sup = TrainingSupervisor(
        step_fn=prog.fn, init_state=(params, opt_state), batch_fn=batch_fn,
        checkpoint_dir=args.checkpoint_dir, save_every=args.save_every,
        watchdog=StragglerWatchdog())
    if sup.start_step:
        print(f"resumed {args.arch}/{cell.name} at step {sup.start_step} "
              f"from {args.checkpoint_dir}")
    t0 = time.perf_counter()
    try:
        report = sup.run(args.steps, fail_at_step=args.fail_at_step,
                         log_every=10)
    except SimulatedFailure as e:
        if sup.ckpt is not None:
            sup.ckpt.wait()      # commit the save in flight before exiting
        print(f"{e}; checkpoints kept: "
              f"{sup.ckpt.all_steps() if sup.ckpt else []}")
        return 3
    dt = time.perf_counter() - t0
    for m in report["metrics"][-5:]:
        print("  ", {k: round(v, 4) for k, v in m.items()})
    print(f"trained {args.arch}/{cell.name} ({args.scale}, {device.type}) "
          f"steps {sup.start_step}..{report['final_step']} in {dt:.1f}s; "
          f"stragglers: {len(report['watchdog'].slow_steps)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
