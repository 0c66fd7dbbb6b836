"""Neural-network layers of the port."""
from .basic_layers import (GELU, Dense, Dropout, Embedding,  # noqa: F401
                           HybridSequential, LayerNorm, gelu)

__all__ = ["HybridSequential", "Dense", "Dropout", "LayerNorm", "Embedding",
           "GELU", "gelu"]
