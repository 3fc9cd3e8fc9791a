"""Activations (the JAX package's ``nn/functional/activation.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.tensor import takes_tensors


@takes_tensors
def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU; ``approximate=True`` is the tanh form that GPT's MLP uses
    (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")
