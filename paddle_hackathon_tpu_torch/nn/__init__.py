from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, dynamic_decode
from .layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["BeamSearchDecoder", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Dropout", "Embedding", "LayerNorm", "Linear",
           "dynamic_decode", "functional"]
