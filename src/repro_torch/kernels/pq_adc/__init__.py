from .ops import pq_adc

__all__ = ["pq_adc"]
