"""Model registry: the step function and a seeded input maker for each
cell of the architectures the port runs.

The port's counterpart of the reference's ``models/registry.py``
(``_lm_opt``, ``_small_opt``, ``_lm_cell``, ``_recsys_cell``,
``build_cell``). Where the reference lowers a cell to an abstract program
for a mesh, the port runs it: ``fn`` takes the parameters (``init``) and
the inputs (``make_inputs``) on the device. The reference's ``CellProgram``
and ``input_specs`` (abstract arguments and partition specs for XLA's
lowering) have no counterpart: PyTorch runs eagerly and one card holds
every tensor whole.

Kinds and their calls:

- ``train`` (both families): ``fn(params, opt_state, batch) -> (params,
  opt_state, metrics)``, one AdamW step; ``init_opt(params)`` makes the
  optimizer state and ``make_inputs(seed)`` returns ``(batch,)``, the
  reference launcher's draw for step 0 of that seed (``train_batch``);
- ``serve`` (recsys): ``fn(params, batch) -> scores [B]``;
- ``retrieval`` (recsys): ``fn(params, batch) -> (vals [100], ids [100])``,
  one user against ``n_candidates`` item ids, top-100;
- ``prefill`` (lm): ``fn(params, tokens) -> (logits, embed, DecodeState)``;
- ``decode`` (lm): ``fn(params, state, tokens) -> (logits, embed, state)``,
  the state's cache updated in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs import ShapeCell, get_arch, get_shapes
from ..data.pipeline import to_device
from ..data.synthetic import recsys_batch, token_batch
from ..optim import AdamW, cosine_annealing
from ..search.distributed import distributed_topk
from .common import dtype_of, value_and_grad
from .recsys import two_tower as tt_m
from .transformer import model as tm

#: top-k of the retrieval cell, as the reference's
RETRIEVAL_K = 100
#: positions of room a decode cell's seeded cache leaves past its length
DECODE_ROOM = 16


@dataclass
class Cell:
    arch_id: str
    cell: ShapeCell
    cfg: Any
    fn: Callable
    init: Callable[[int], Any]          # seed -> params on the device
    make_inputs: Callable[[int], tuple]  # seed -> fn's arguments after params
    #: train cells: params -> the optimizer state
    init_opt: Optional[Callable[[Any], Any]] = None


def _tensors(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _lm_opt(cfg) -> AdamW:
    """The LM cells' optimizer: cosine 3e-4 -> 3e-5 over 50,000 steps after
    500 of linear warmup (the first step's lr is 0), weight decay 0.1,
    clip 1.0, moments in ``cfg.moment_dtype``."""
    return AdamW(lr=cosine_annealing(3e-4, 3e-5, 50_000, warmup_steps=500),
                 weight_decay=0.1, clip_norm=1.0,
                 moment_dtype=cfg.moment_dtype)


def _small_opt() -> AdamW:
    """The recsys (and GNN) cells' optimizer: cosine 1e-3 -> 1e-5 over
    50,000 steps, weight decay 1e-4, clip 1.0."""
    return AdamW(lr=cosine_annealing(1e-3, 1e-5, 50_000), weight_decay=1e-4,
                 clip_norm=1.0)


def train_batch(cfg, family: str, cell: ShapeCell, seed: int,
                device="cuda") -> dict[str, torch.Tensor]:
    """The reference launcher's batch of a train cell for one seed
    (``launch/train.py:make_batch_fn``, which draws step ``s`` with seed
    ``seed + s``): Zipfian tokens and their next-token targets for an LM,
    ``recsys_batch`` over every table for the two-tower (user, item,
    history bag, label). Drawn on the host, moved to ``device`` pinned and
    non-blocking."""
    if family == "lm":
        batch = token_batch(cell.global_batch, cell.seq_len, cfg.vocab_size,
                            seed=seed)
    elif family == "recsys" and cfg.kind == "two_tower":
        vocabs = {t.name: t.vocab for t in cfg.tables}
        b = recsys_batch(cell.global_batch, vocabs,
                         hist_len=cfg.hist_len or cfg.seq_len,
                         n_fields=cfg.n_fields,
                         field_vocab=(cfg.tables[0].vocab if cfg.tables
                                      else 1000), seed=seed)
        batch = {k: b[k] for k in ("user", "hist", "hist_len", "item",
                                   "label")}
    else:
        raise NotImplementedError(f"{family} model {cfg.name!r} does not "
                                  f"train in the port: ROADMAP.md queue A "
                                  f"item 15")
    return to_device(batch, device)


def _recsys_train_step(cfg, opt: AdamW):
    def fn(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(tt_m.loss_fn, params, batch,
                                                cfg)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return fn


def _recsys_cell(arch_id: str, cfg, cell: ShapeCell, device) -> Cell:
    if cfg.kind != "two_tower":
        raise NotImplementedError(f"recsys model {cfg.kind!r} is not ported: "
                                  f"ROADMAP.md queue A item 15")
    vocabs = {t.name: t.vocab for t in cfg.tables}
    ids = {"user": vocabs["user"], "item": vocabs["item"]}
    b = cell.global_batch

    def init(seed: int = 0):
        return tt_m.init(cfg, seed, device)

    if cell.kind == "train":
        opt = _small_opt()
        return Cell(arch_id, cell, cfg, _recsys_train_step(cfg, opt), init,
                    lambda seed=0: (train_batch(cfg, "recsys", cell, seed,
                                                device),),
                    init_opt=opt.init)

    if cell.kind == "serve":
        def fn(params, batch):
            return tt_m.serve(params, batch, cfg)

        def make_inputs(seed: int = 0):
            batch = recsys_batch(b, ids, hist_len=cfg.hist_len, seed=seed)
            batch.pop("label")
            return (_tensors(batch, device),)

        return Cell(arch_id, cell, cfg, fn, init, make_inputs)

    nc = cell.n_candidates

    def fn(params, batch):
        return distributed_topk(tt_m.retrieval_scores(params, batch, cfg),
                                RETRIEVAL_K)

    def make_inputs(seed: int = 0):
        batch = recsys_batch(1, ids, hist_len=cfg.hist_len, seed=seed)
        batch.pop("label")
        batch["candidates"] = np.random.default_rng(seed + 1).integers(
            0, vocabs["item"], nc).astype(np.int32)
        return (_tensors(batch, device),)

    return Cell(arch_id, cell, cfg, fn, init, make_inputs)


def random_decode_state(cfg, batch: int, max_len: int, length: int,
                        seed: int = 0, device="cuda") -> tm.DecodeState:
    """A cache of ``max_len`` positions holding ``length`` seeded tokens'
    K and V (standard normal in the compute dtype, drawn on the device;
    positions past ``length`` zero)."""
    cdt = dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.zeros(shape, dtype=cdt, device=device)
    v = torch.zeros(shape, dtype=cdt, device=device)
    k[:, :, :length].normal_(generator=gen)
    v[:, :, :length].normal_(generator=gen)
    return tm.DecodeState(k=k, v=v, length=torch.tensor(
        length, dtype=torch.int32, device=device))


def _lm_cell(arch_id: str, cfg, cell: ShapeCell, device) -> Cell:
    s, b = cell.seq_len, cell.global_batch
    if cell.kind == "train":
        opt = _lm_opt(cfg)
        return Cell(arch_id, cell, cfg, tm.make_train_step(cfg, opt),
                    lambda seed=0: tm.init(cfg, seed, device),
                    lambda seed=0: (train_batch(cfg, "lm", cell, seed,
                                                device),),
                    init_opt=opt.init)
    # serving keeps the weights in bfloat16, as the reference's _lm_cell
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")

    def init(seed: int = 0):
        return tm.init(cfg, seed, device)

    def tokens(seed: int, width: int):
        return torch.as_tensor(token_batch(b, width, cfg.vocab_size,
                                           seed=seed)["tokens"], device=device)

    if cell.kind == "prefill":
        def fn(params, toks, max_len=None):
            return tm.prefill(params, toks, cfg, max_len=max_len)

        return Cell(arch_id, cell, cfg, fn, init,
                    lambda seed=0: (tokens(seed, s),))

    # decode: one new token against a cache of seq_len positions
    def fn(params, state, toks):
        return tm.decode_step(params, state, toks, cfg)

    def make_inputs(seed: int = 0):
        state = random_decode_state(cfg, b, s, s - DECODE_ROOM, seed, device)
        return state, tokens(seed, 1)[:, 0]

    return Cell(arch_id, cell, cfg, fn, init, make_inputs)


def build_cell(arch_id: str, cell: ShapeCell | str,
               device: str | torch.device = "cuda") -> Cell:
    """The cell's step function, parameter init and input maker, on
    ``device``. ``cell`` is a ``ShapeCell`` (a cut one too) or the name of
    one of the arch's cells."""
    cfg, family = get_arch(arch_id)
    if isinstance(cell, str):
        cells = {c.name: c for c in get_shapes(arch_id)}
        cell = cells[cell]
    return build_cell_with(cfg, family, arch_id, cell, device)


def build_cell_with(cfg, family: str, arch_id: str, cell: ShapeCell,
                    device: str | torch.device = "cuda") -> Cell:
    """``build_cell`` for a config given as it is (a reduced or cut one
    too)."""
    device = torch.device(device)
    if family == "lm":
        return _lm_cell(arch_id, cfg, cell, device)
    if family == "recsys":
        return _recsys_cell(arch_id, cfg, cell, device)
    raise ValueError(family)
