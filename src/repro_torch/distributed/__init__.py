"""Parameter schemas (``ParamDef``, ``init_from_schema``) and corpus
partitioning for the sharded tier (``api/sharded.py``); checkpoints
(``checkpoint.py``), the training supervisor (``fault_tolerance.py``) and
gradient compression (``compression.py``) for training."""
from .partitioning import (ParamDef, init_from_schema, partition_ivf_cells,
                           partition_rows)

__all__ = ["ParamDef", "init_from_schema", "partition_ivf_cells",
           "partition_rows"]
