"""Common layers (the JAX package's ``nn/layers/common.py``).

``Linear`` keeps Paddle's weight layout ``(in_features, out_features)``,
so ``y = x @ W + b`` and a JAX state dict copies in without transposes.
The layers are ``Layer``s (``nn/layer.py``) holding ``Parameter``s
(``nn/parameter.py``) made as Paddle makes them: on the current place
(``core/device.parameter_device``; keyword ``device`` overrides it),
initialised by the ``ParamAttr``'s initializer, else ``Linear``'s
``XavierUniform`` weight and zero bias and ``Embedding``'s
``Normal(0, 1)``.  ``bias_attr=False`` drops the bias.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import parameter_device
from ...core.random import default_generator
from .. import initializer as I
from ..layer import Layer


class Linear(Layer):
    """``y = x @ W + b`` with ``W`` of shape ``(in_features, out_features)``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        dev = parameter_device(device)
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr, dtype=dtype,
            device=dev)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, dtype=dtype, is_bias=True,
                device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    """A row lookup; rows looked up at ``padding_idx`` come out zero, as in
    the JAX package.  ``sparse`` is accepted and has no effect there
    either."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr, dtype=dtype,
            default_initializer=I.Normal(0.0, 1.0),
            device=parameter_device(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = nn.functional.embedding(ids, self.weight)
        if self.padding_idx is not None:
            out = out.masked_fill((ids == self.padding_idx)[..., None], 0.0)
        return out

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """Upscale-in-train dropout; the identity at eval or ``p == 0``.  The
    mask is drawn from the device's default generator
    (``core/random.py``)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=default_generator(x.device),
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"
