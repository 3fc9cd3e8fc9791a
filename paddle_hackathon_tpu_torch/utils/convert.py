"""Carry weights across from the JAX package.

The JAX model's ``state_dict()`` (``nn/layer.py``) exported to numpy is a
``{name: np.ndarray}`` dict whose names and layouts are the port's own
(Paddle's ``(in, out)`` Linear layout is kept on both sides), so loading
is a name-for-name copy with no transposes; :func:`state_to_numpy` is the
way back.

numpy has no bf16 or fp8 type of its own: JAX hands them over as
``ml_dtypes`` arrays, and a serving artifact stores them as same-width
unsigned views with the dtype's name beside them.  Both come in here
through an unsigned view of the same bits, so reading needs no
``ml_dtypes`` (the card's machine may have none); only
:func:`state_to_numpy`
imports it, to give bf16/fp8 back as JAX's own numpy types.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

# dtypes numpy lacks: name -> (torch dtype, unsigned view of the same bits)
_BIT_VIEWS = {"bfloat16": (torch.bfloat16, np.uint16),
              "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy/ml_dtypes name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``), as the JAX package records it in an artifact."""
    return str(dtype).split(".")[-1]


def to_tensor(arr, name: Optional[str] = None) -> torch.Tensor:
    """numpy -> CPU tensor.  ``name`` is the logical dtype when ``arr``
    holds its bits in another type of the same width (an artifact's
    ``uint16`` for ``"bfloat16"``, ``uint8`` for ``"float8_e4m3fn"``);
    by default the array's own dtype.  bf16 and fp8 arrays from
    ``ml_dtypes`` go through an unsigned view too, since
    ``torch.from_numpy`` rejects them."""
    # ascontiguousarray makes a 0-d array 1-d: keep the array's own shape
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if not arr.flags.writeable:     # e.g. a view of a JAX array's buffer
        arr = arr.copy()
    name = name or arr.dtype.name
    if name in _BIT_VIEWS:
        dtype, bits = _BIT_VIEWS[name]
        return torch.from_numpy(arr.view(bits)).view(dtype)
    if name != arr.dtype.name:
        arr = arr.view(np.dtype(name))
    return torch.from_numpy(arr)


def to_stored(t: torch.Tensor) -> np.ndarray:
    """CPU tensor -> the numpy array an artifact stores: bf16 and fp8 as
    their unsigned bit views (with :func:`dtype_name` recorded beside
    them), every other dtype as itself.  The inverse of
    :func:`to_tensor`."""
    t = t.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if name in _BIT_VIEWS:
        bits = _BIT_VIEWS[name][1]
        return t.view(torch.int16 if bits is np.uint16 else torch.uint8) \
            .numpy().view(bits)
    return t.numpy()


def _persistent_buffers(model: nn.Module) -> dict:
    """``model``'s buffers that belong in its state (the JAX package's
    persistable buffers: a QAT observer's ``scale``/``state``/``accum``),
    by dotted name."""
    out = {}
    for mname, mod in model.named_modules():
        for bname, buf in mod._buffers.items():
            if buf is not None and \
                    bname not in mod._non_persistent_buffers_set:
                out.setdefault(f"{mname}.{bname}" if mname else bname, buf)
    return out


def check_state(model: nn.Module, arrays: Mapping) -> dict:
    """``model``'s parameters and buffers by name, after checking that
    ``arrays`` (numpy arrays or tensors) names every parameter and every
    persistent buffer, and nothing else but the non-persistent buffers (a
    quantizer's recomputed scale, which JAX's ``functional_state`` carries
    beside its ``state_dict``), with their shapes: ``KeyError`` on a
    missing or extra name, ``ValueError`` on a shape mismatch."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    required = set(params) | set(_persistent_buffers(model))
    missing = sorted(required - set(arrays))
    extra = sorted(set(arrays) - set(params) - set(buffers))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, extra {extra}")
    tensors = dict(buffers, **params)
    for name, arr in arrays.items():
        if tuple(np.shape(arr)) != tuple(tensors[name].shape):
            raise ValueError(f"{name}: shape {tuple(np.shape(arr))} != "
                             f"{tuple(tensors[name].shape)}")
    return tensors


@torch.no_grad()
def load_jax_state(model: nn.Module, arrays: Mapping[str, np.ndarray]):
    """Copy ``arrays`` into ``model``'s parameters and buffers name for
    name, onto each tensor's device and into its dtype.  Nothing is copied
    unless every name and shape agrees (:func:`check_state`).  Returns
    ``model``."""
    tensors = check_state(model, arrays)
    for name, arr in arrays.items():
        tensors[name].copy_(to_tensor(arr))
    return model


def state_to_numpy(model: nn.Module) -> dict:
    """``{name: np.ndarray}`` of ``model``'s parameters and persistent
    buffers (the JAX ``state_dict``'s names), the inverse of
    :func:`load_jax_state`.  bf16 and fp8 leaves come back as
    ``ml_dtypes.bfloat16``/``ml_dtypes.float8_e4m3fn`` views of the same
    bits (numpy's own types for them, which JAX uses)."""
    out = {}
    named = dict(model.named_parameters())
    named.update(_persistent_buffers(model))
    for name, p in named.items():
        a = to_stored(p).copy()      # never a view of the tensor
        kind = dtype_name(p.dtype)
        if kind in _BIT_VIEWS:
            import ml_dtypes
            a = a.view(getattr(ml_dtypes, kind))
        out[name] = a
    return out
