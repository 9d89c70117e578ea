from .ops import rae_encode

__all__ = ["rae_encode"]
