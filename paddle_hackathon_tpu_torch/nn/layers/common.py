"""Common layers (the JAX package's ``nn/layers/common.py``).

``Linear`` keeps Paddle's weight layout ``(in_features, out_features)``,
so ``y = x @ W + b`` and a JAX state dict copies in without transposes.
Parameters are created empty on the caller's device; the owning model
initialises them (``models/gpt.py``) or loads them
(``utils/convert.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.random import default_generator


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` of shape ``(in_features, out_features)``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = (nn.Parameter(torch.zeros(out_features, **kw))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
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
