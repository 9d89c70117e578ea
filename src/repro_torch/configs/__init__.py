from .base import (EmbeddingTableSpec, RAEConfig, RecsysConfig, ShapeCell,
                   TransformerConfig)
from .registry import get_arch, get_shapes

__all__ = ["EmbeddingTableSpec", "RAEConfig", "RecsysConfig", "ShapeCell",
           "TransformerConfig", "get_arch", "get_shapes"]
