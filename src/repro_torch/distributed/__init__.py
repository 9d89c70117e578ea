"""Corpus partitioning for the sharded tier (``api/sharded.py``)."""
from .partitioning import partition_ivf_cells, partition_rows

__all__ = ["partition_ivf_cells", "partition_rows"]
