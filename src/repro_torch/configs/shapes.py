"""The input-shape sets of the families whose serving paths are ported: the
reference's ``configs/shapes.py`` for LMs and RecSys (its GNN set waits
with the GNN model, ROADMAP.md queue A item 15)."""
from __future__ import annotations

from .base import ShapeCell

# --- LM-family transformers: seq_len x global_batch -------------------------
LM_SHAPES = (
    ShapeCell(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeCell(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeCell(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    # long_500k is *decode* (one token vs a 524288-token KV cache): O(S)/step
    ShapeCell(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
)

# --- RecSys ------------------------------------------------------------------
RECSYS_SHAPES = (
    ShapeCell(name="train_batch", kind="train", global_batch=65536),
    ShapeCell(name="serve_p99", kind="serve", global_batch=512),
    ShapeCell(name="serve_bulk", kind="serve", global_batch=262144),
    ShapeCell(name="retrieval_cand", kind="retrieval", global_batch=1,
              n_candidates=1_000_000),
)


def shapes_for_family(family: str) -> tuple[ShapeCell, ...]:
    return {"lm": LM_SHAPES, "recsys": RECSYS_SHAPES}[family]
