from .ops import graph_beam_q

__all__ = ["graph_beam_q"]
