"""Dtype names <-> ``torch.dtype`` (the port's counterpart of the JAX
package's ``core/dtype.py`` table, cut to the floating types the port
serves in)."""

from __future__ import annotations

import torch

_NAME2DTYPE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_DTYPE2NAME = {v: k for k, v in _NAME2DTYPE.items()}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``) or ``torch.dtype`` -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPE2NAME:
            raise ValueError(f"unsupported dtype: {dtype}")
        return dtype
    try:
        return _NAME2DTYPE[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype: {dtype!r}") from None


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return _DTYPE2NAME[convert_dtype(dtype)]
