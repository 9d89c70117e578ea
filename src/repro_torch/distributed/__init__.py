"""Parameter schemas (``ParamDef``, ``init_from_schema``) and corpus
partitioning for the sharded tier (``api/sharded.py``)."""
from .partitioning import (ParamDef, init_from_schema, partition_ivf_cells,
                           partition_rows)

__all__ = ["ParamDef", "init_from_schema", "partition_ivf_cells",
           "partition_rows"]
