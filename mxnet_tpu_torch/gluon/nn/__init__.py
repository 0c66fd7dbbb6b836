"""Neural-network layers of the port."""
from .basic_layers import (GELU, Activation, BatchNorm, Dense,  # noqa: F401
                           Dropout, Embedding, Flatten, HybridSequential,
                           LayerNorm, gelu)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D,  # noqa: F401
                          Conv1D, Conv2D, Conv3D, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D, GlobalMaxPool1D,
                          GlobalMaxPool2D, GlobalMaxPool3D, MaxPool1D,
                          MaxPool2D, MaxPool3D)

__all__ = ["HybridSequential", "Dense", "Activation", "Dropout", "BatchNorm",
           "LayerNorm", "Embedding", "Flatten", "GELU", "gelu", "Conv1D",
           "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D"]
