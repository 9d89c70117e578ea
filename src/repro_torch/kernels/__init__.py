"""Hand-written Hopper kernels of the port, each a ``kernel/ops/ref``
triple like the reference package's Pallas kernels: ``kernel.py`` binds
the CUDA source in ``csrc/``, ``ref.py`` is the plain PyTorch version, and
``ops.py`` takes the kernel for a CUDA tensor and the plain version for a
CPU tensor. ``embedding_bag`` also has a backward kernel
(``embedding_bag_bwd``), the table's gradient in a fixed order."""
from .embedding_bag import embedding_bag, embedding_bag_bwd
from .flash_decode import flash_decode
from .graph_beam import graph_beam
from .graph_beam_q import graph_beam_q
from .l2_topk import l2_topk
from .pq_adc import pq_adc
from .rae_encode import rae_encode
from .topk_merge import topk_merge

__all__ = ["embedding_bag", "embedding_bag_bwd", "flash_decode", "graph_beam", "graph_beam_q",
           "l2_topk", "pq_adc", "rae_encode", "topk_merge"]
