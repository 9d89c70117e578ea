from .ops import flash_decode

__all__ = ["flash_decode"]
