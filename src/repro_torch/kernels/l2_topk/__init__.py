from .ops import l2_topk

__all__ = ["l2_topk"]
