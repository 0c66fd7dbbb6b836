"""Model families of the port."""
from .transformer import (BERTModel, MultiHeadAttention,  # noqa: F401
                          TransformerEncoderLayer, TransformerLM)

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerLM",
           "BERTModel"]
