from .adamw import AdamW, AdamWState, global_norm
from .schedule import constant, cosine_annealing

__all__ = ["AdamW", "AdamWState", "constant", "cosine_annealing",
           "global_norm"]
