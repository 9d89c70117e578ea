from .base import RAEConfig

__all__ = ["RAEConfig"]
