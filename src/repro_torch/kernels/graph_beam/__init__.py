from .ops import graph_beam

__all__ = ["graph_beam"]
