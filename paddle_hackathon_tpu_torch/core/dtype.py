"""Dtype objects, names and the default float dtype (the JAX package's
``core/dtype.py``).

``paddle.float32`` and its kin are :class:`DType` objects: ``str()``
gives the Paddle name (``"float32"``), they compare equal to the name, to
the ``torch.dtype`` and to the numpy dtype, and ``.torch`` is the
``torch.dtype`` a payload holds.

The JAX package runs with JAX's 64-bit types off, so its integer tensors
are ``int32`` and float64 input becomes ``float32``.  The port's
``Tensor`` reports the same dtypes: :func:`narrow` maps ``int64`` to
``int32``, ``float64`` to ``float32`` and ``complex128`` to
``complex64`` wherever a ``Tensor`` is made.  Inside an op an index is
widened to int64 only where torch requires it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import flags


class DType:
    """A Paddle dtype: its name and the ``torch.dtype`` behind it."""

    __slots__ = ("name", "torch")

    def __init__(self, name: str, tdtype: torch.dtype):
        self.name = name
        self.torch = tdtype

    def __eq__(self, other):
        if isinstance(other, DType):
            return other.torch == self.torch
        try:
            return convert_dtype(other) == self.torch
        except (ValueError, TypeError):
            return False

    def __hash__(self):
        return hash(self.torch)

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"paddle.{self.name}"


_TABLE = [
    ("bool", torch.bool), ("uint8", torch.uint8), ("int8", torch.int8),
    ("int16", torch.int16), ("int32", torch.int32), ("int64", torch.int64),
    ("float16", torch.float16), ("bfloat16", torch.bfloat16),
    ("float32", torch.float32), ("float64", torch.float64),
    ("complex64", torch.complex64), ("complex128", torch.complex128),
]
_BY_NAME = {n: DType(n, t) for n, t in _TABLE}
_BY_TORCH = {d.torch: d for d in _BY_NAME.values()}

bool_ = _BY_NAME["bool"]
uint8 = _BY_NAME["uint8"]
int8 = _BY_NAME["int8"]
int16 = _BY_NAME["int16"]
int32 = _BY_NAME["int32"]
int64 = _BY_NAME["int64"]
float16 = _BY_NAME["float16"]
bfloat16 = _BY_NAME["bfloat16"]
float32 = _BY_NAME["float32"]
float64 = _BY_NAME["float64"]
complex64 = _BY_NAME["complex64"]
complex128 = _BY_NAME["complex128"]

# what a Tensor holds in place of a 64-bit type (JAX's 64-bit types off)
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def convert_dtype(dtype):
    """A dtype name (``"bfloat16"``), :class:`DType`, ``torch.dtype`` or
    numpy dtype -> ``torch.dtype``; ``None`` -> ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, DType):
        return dtype.torch
    if isinstance(dtype, str):
        name = "bool" if dtype == "bool_" else dtype
        try:
            return _BY_NAME[name].torch
        except KeyError:
            raise ValueError(f"unknown dtype: {dtype!r}") from None
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"unknown dtype: {dtype!r}") from None
    try:
        return _BY_NAME[name].torch
    except KeyError:
        raise ValueError(f"unsupported dtype: {dtype!r}") from None


def narrow(tdtype: torch.dtype) -> torch.dtype:
    """The dtype a ``Tensor`` holds for ``tdtype`` (64-bit types narrowed)."""
    return _NARROW.get(tdtype, tdtype)


def to_paddle(tdtype: torch.dtype) -> DType:
    """``torch.float32`` -> ``paddle.float32``."""
    return _BY_TORCH[tdtype]


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return _BY_TORCH[convert_dtype(dtype)].name


def default_float_dtype() -> torch.dtype:
    return convert_dtype(flags.flag("default_dtype"))


def set_default_dtype(dtype):
    """``paddle.set_default_dtype``: a floating dtype."""
    d = convert_dtype(dtype)
    if d not in (torch.float16, torch.bfloat16, torch.float32,
                 torch.float64):
        raise ValueError("default dtype must be a floating dtype")
    flags.set_flags({"default_dtype": _BY_TORCH[d].name})


def get_default_dtype() -> str:
    return flags.flag("default_dtype")

