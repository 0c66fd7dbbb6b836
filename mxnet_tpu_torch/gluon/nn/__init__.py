"""Neural-network layers of the port."""
from .basic_layers import (ELU, GELU, SELU, Activation,  # noqa: F401
                           BatchNorm, Dense, Dropout, Embedding, Flatten,
                           GroupNorm, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, LeakyReLU, PReLU,
                           Sequential, Swish, gelu)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D,  # noqa: F401
                          Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D, GlobalMaxPool1D,
                          GlobalMaxPool2D, GlobalMaxPool3D, MaxPool1D,
                          MaxPool2D, MaxPool3D, ReflectionPad2D)
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda", "LeakyReLU",
           "PReLU", "ELU", "SELU", "Swish", "GELU", "gelu", "Conv1D",
           "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D", "Block",
           "HybridBlock", "SymbolBlock"]
