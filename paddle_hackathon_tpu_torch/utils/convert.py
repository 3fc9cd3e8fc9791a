"""Carry weights across from the JAX package.

The JAX model's ``state_dict()`` (``nn/layer.py``) exported to numpy is a
``{name: np.ndarray}`` dict whose names and layouts are the port's own
(Paddle's ``(in, out)`` Linear layout is kept on both sides), so loading
is a name-for-name copy with no transposes; :func:`state_to_numpy` is the
way back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def to_tensor(arr) -> torch.Tensor:
    """numpy -> CPU tensor.  A bf16 array exported from JAX has numpy
    dtype ``bfloat16`` (from ``ml_dtypes``), which ``torch.from_numpy``
    rejects: it goes through a ``uint16`` view of the same bits."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # e.g. a view of a JAX array's buffer
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def load_jax_state(model: nn.Module, arrays: Mapping[str, np.ndarray]):
    """Copy ``arrays`` into ``model``'s parameters name for name, onto each
    parameter's device and into its dtype.  Raises ``KeyError`` on a
    missing or extra name and ``ValueError`` on a shape mismatch; nothing
    is copied unless every name and shape agrees.  Returns ``model``."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, extra {extra}")
    for name, arr in arrays.items():
        if tuple(np.shape(arr)) != tuple(params[name].shape):
            raise ValueError(f"{name}: shape {tuple(np.shape(arr))} != "
                             f"{tuple(params[name].shape)}")
    for name, arr in arrays.items():
        params[name].copy_(to_tensor(arr))
    return model


def state_to_numpy(model: nn.Module) -> dict:
    """``{name: np.ndarray}`` of ``model``'s parameters, the inverse of
    :func:`load_jax_state`.  bf16 leaves through a 16-bit view of the same
    bits as ``ml_dtypes.bfloat16`` (numpy's own bf16 type, which JAX
    uses)."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            out[name] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[name] = t.numpy().copy()
    return out
