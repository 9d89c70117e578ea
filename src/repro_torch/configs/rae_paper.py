"""The paper's own RAE configuration (Section 4.1): a copy of the
reference's ``configs/rae_paper.py``.

3000 steps, batch 128, AdamW with weight decay = lambda, cosine 1e-3 -> 1e-5.
in/out dims are dataset-dependent; this default matches the IMDb(768d)->384
setting of Table 1.
"""
from .base import RAEConfig

CONFIG = RAEConfig(
    name="rae_paper",
    in_dim=768,
    out_dim=384,
    weight_decay=1e-2,
    steps=3000,
    batch_size=128,
    lr_max=1e-3,
    lr_min=1e-5,
)
FAMILY = "rae"
