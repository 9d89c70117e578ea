"""Hand-written Hopper kernels of the port, each a ``kernel/ops/ref``
triple like the reference package's Pallas kernels: ``kernel.py`` binds
the CUDA source in ``csrc/``, ``ref.py`` is the plain PyTorch version, and
``ops.py`` takes the kernel for a CUDA tensor and the plain version for a
CPU tensor."""
from .l2_topk import l2_topk
from .rae_encode import rae_encode

__all__ = ["l2_topk", "rae_encode"]
