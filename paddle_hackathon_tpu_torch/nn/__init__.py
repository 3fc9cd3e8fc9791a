from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .container import (Identity, LayerDict, LayerList, ParameterList,
                        Sequential)
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import Layer, functional_call
from .layers import *  # noqa: F401,F403 -- the layers, activations, losses
from .layers import Dropout, Embedding, LayerNorm, Linear
from .parameter import ParamAttr, Parameter, create_parameter

__all__ = ["BeamSearchDecoder", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Dropout", "Embedding", "Identity", "Layer",
           "LayerDict", "LayerList", "LayerNorm", "Linear", "ParamAttr",
           "Parameter", "ParameterList", "Sequential", "create_parameter",
           "dynamic_decode", "functional", "functional_call", "initializer"]
