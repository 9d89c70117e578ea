"""The paper's primary contribution: RAE k-NN-preserving dimensionality
reduction (model, theory, metrics, trainer) and the baselines the paper
compares against."""
from . import baselines, metrics, rae, spectral, theory, trainer

__all__ = ["baselines", "metrics", "rae", "spectral", "theory", "trainer"]
