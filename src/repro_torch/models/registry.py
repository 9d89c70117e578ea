"""Model registry: the step function and a seeded input maker for each
serving cell of the architectures the port runs.

The port's counterpart of the reference's ``models/registry.py``
(``_lm_cell``, ``_recsys_cell``, ``build_cell``). Where the reference
lowers a cell to an abstract program for a mesh, the port runs it: ``fn``
takes the parameters (``init``) and the inputs (``make_inputs``) on the
device. Serving cells only: a ``train`` cell raises, naming its ROADMAP
item.

Kinds and their calls:

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
from typing import Any, Callable

import numpy as np
import torch

from ..configs import ShapeCell, get_arch, get_shapes
from ..data.synthetic import recsys_batch, token_batch
from ..search.distributed import distributed_topk
from .common import dtype_of
from .recsys import two_tower as tt_m
from .transformer import model as tm

#: top-k of the retrieval cell, as the reference's
RETRIEVAL_K = 100
#: positions of room a decode cell's seeded cache leaves past its length
DECODE_ROOM = 16
TRAIN_NOT_PORTED = ("train cells (losses, backward, optimizer state) are not "
                    "ported: ROADMAP.md queue A item 15")


@dataclass
class Cell:
    arch_id: str
    cell: ShapeCell
    cfg: Any
    fn: Callable
    init: Callable[[int], Any]          # seed -> params on the device
    make_inputs: Callable[[int], tuple]  # seed -> fn's arguments after params


def _tensors(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _recsys_cell(arch_id: str, cfg, cell: ShapeCell, device) -> Cell:
    if cfg.kind != "two_tower":
        raise NotImplementedError(f"recsys model {cfg.kind!r} is not ported: "
                                  f"ROADMAP.md queue A item 15")
    vocabs = {t.name: t.vocab for t in cfg.tables}
    ids = {"user": vocabs["user"], "item": vocabs["item"]}
    b = cell.global_batch

    def init(seed: int = 0):
        return tt_m.init(cfg, seed, device)

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
    if cell.kind == "train":
        raise NotImplementedError(TRAIN_NOT_PORTED)
    device = torch.device(device)
    if family == "lm":
        return _lm_cell(arch_id, cfg, cell, device)
    if family == "recsys":
        return _recsys_cell(arch_id, cfg, cell, device)
    raise ValueError(family)
