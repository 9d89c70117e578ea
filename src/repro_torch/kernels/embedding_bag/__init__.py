from .ops import embedding_bag, embedding_bag_bwd

__all__ = ["embedding_bag", "embedding_bag_bwd"]
