"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

It imports ``torch`` and numpy, never JAX and nothing of ``repro``. Entry
points take a ``device`` argument that defaults to ``"cuda"``; on a CUDA
tensor every kernel op runs its hand-written kernel, on a CPU tensor its
plain PyTorch version (``kernels/<name>/ref.py``).
"""
