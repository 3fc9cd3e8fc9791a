"""Normalisation layers (the JAX package's ``nn/layers/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    """Layer norm over the last dims, ``epsilon=1e-5``, with ``weight``
    (ones) and ``bias`` (zeros) of the normalised shape."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(self._normalized_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.layer_norm(x, self._normalized_shape,
                                        self.weight, self.bias,
                                        self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={list(self._normalized_shape)}"
