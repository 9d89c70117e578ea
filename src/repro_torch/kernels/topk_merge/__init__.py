from .ops import topk_merge

__all__ = ["topk_merge"]
