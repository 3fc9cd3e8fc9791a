from . import functional, initializer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .container import (Identity, LayerDict, LayerList, ParameterList,
                        Sequential)
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import Layer, functional_call
from .layers import *  # noqa: F401,F403 -- the layers, activations, losses
from .layers import Dropout, Embedding, LayerNorm, Linear
from .parameter import ParamAttr, Parameter, create_parameter
# the top-of-nn aliases the JAX package (and Paddle) still export
from .functional.common import diag_embed
from .utils import remove_weight_norm, weight_norm

__all__ = ["BeamSearchDecoder", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Dropout", "Embedding", "Identity", "Layer",
           "LayerDict", "LayerList", "LayerNorm", "Linear", "ParamAttr",
           "Parameter", "ParameterList", "Sequential", "create_parameter",
           "diag_embed", "dynamic_decode", "functional", "functional_call",
           "initializer", "remove_weight_norm", "utils", "weight_norm"]
