"""Normalisation layers (the JAX package's ``nn/layers/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import parameter_device
from .. import initializer as I
from ..layer import Layer


class LayerNorm(Layer):
    """Layer norm over the last dims, ``epsilon=1e-5``, with ``weight``
    (ones) and ``bias`` (zeros) of the normalised shape, made on the
    current place as ``Linear``'s are; ``weight_attr`` / ``bias_attr``
    ``False`` drops that one."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        dev = parameter_device(device)
        self.weight = None
        self.bias = None
        if weight_attr is not False:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr, dtype=dtype,
                default_initializer=I.Constant(1.0), device=dev)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=bias_attr, dtype=dtype,
                is_bias=True, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.layer_norm(x, self._normalized_shape,
                                        self.weight, self.bias,
                                        self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={list(self._normalized_shape)}"
