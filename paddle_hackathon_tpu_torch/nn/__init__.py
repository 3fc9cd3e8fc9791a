from . import functional
from .layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "functional"]
