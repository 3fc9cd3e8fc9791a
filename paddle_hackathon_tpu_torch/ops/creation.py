"""Tensor creation ops (the JAX package's ``ops/creation.py``).

New tensors land on the current place (``core/device.py``: the card
unless ``set_device("cpu")``); the ``*_like`` ops on their input's
device.
"""

from __future__ import annotations

import torch

from ..core import autograd
from ..core.dtype import convert_dtype, narrow
from ..core.tensor import Tensor, _as_payload, to_tensor  # noqa: F401
from ._common import dev as _dev
from ._common import dt as _dt
from ._common import ints as _ints
from ._common import to_t as _t


def _shape(shape):
    return _ints(shape)


def zeros(shape, dtype=None) -> Tensor:
    return Tensor._wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                    device=_dev()))


def ones(shape, dtype=None) -> Tensor:
    return Tensor._wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                                   device=_dev()))


def full(shape, fill_value, dtype=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor._wrap(torch.full(_shape(shape), fill_value,
                                   dtype=_dt(dtype), device=_dev()))


def empty(shape, dtype=None) -> Tensor:
    return zeros(shape, dtype)


def _like_dtype(dtype):
    d = convert_dtype(dtype)
    return None if d is None else narrow(d)


def zeros_like(x, dtype=None) -> Tensor:
    d = _like_dtype(dtype)
    return autograd.apply_op("zeros_like",
                             lambda v: torch.zeros_like(v, dtype=d), [_t(x)])


def ones_like(x, dtype=None) -> Tensor:
    d = _like_dtype(dtype)
    return autograd.apply_op("ones_like",
                             lambda v: torch.ones_like(v, dtype=d), [_t(x)])


def full_like(x, fill_value, dtype=None) -> Tensor:
    d = _like_dtype(dtype)
    return autograd.apply_op(
        "full_like", lambda v: torch.full_like(v, fill_value, dtype=d),
        [_t(x)])


def empty_like(x, dtype=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None) -> Tensor:
    """Integer bounds give int32 (as the JAX package, 64-bit types off),
    a float bound the default float dtype."""
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange bounds must be python numbers")
    d = convert_dtype(dtype)
    if d is None:
        d = (_dt(None) if any(isinstance(v, float)
                              for v in (start, end, step)) else torch.int32)
    return Tensor._wrap(torch.arange(start, end, step, dtype=narrow(d),
                                     device=_dev()))


def linspace(start, stop, num, dtype=None) -> Tensor:
    return Tensor._wrap(torch.linspace(float(start), float(stop), int(num),
                                       dtype=_dt(dtype), device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None) -> Tensor:
    return Tensor._wrap(torch.logspace(float(start), float(stop), int(num),
                                       base=base, dtype=_dt(dtype),
                                       device=_dev()))


def eye(num_rows, num_columns=None, dtype=None) -> Tensor:
    return Tensor._wrap(torch.eye(num_rows, num_columns
                                  if num_columns is not None else num_rows,
                                  dtype=_dt(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0) -> Tensor:
    def fn(v):
        d = torch.diag(v, offset)
        if v.dim() == 1 and padding_value != 0:
            mask = _diag_mask(d.shape, offset, d.device)
            return torch.where(mask, d, torch.as_tensor(
                padding_value, dtype=d.dtype, device=d.device))
        return d
    return autograd.apply_op("diag", fn, [_t(x)])


def _diag_mask(shape, offset, device):
    r = torch.arange(shape[0], device=device)[:, None]
    c = torch.arange(shape[1], device=device)[None, :]
    return c - r == offset


def diagflat(x, offset=0) -> Tensor:
    return autograd.apply_op("diagflat",
                             lambda v: torch.diagflat(v, offset), [_t(x)])


def tril(x, diagonal=0) -> Tensor:
    return autograd.apply_op("tril", lambda v: torch.tril(v, diagonal),
                             [_t(x)])


def triu(x, diagonal=0) -> Tensor:
    return autograd.apply_op("triu", lambda v: torch.triu(v, diagonal),
                             [_t(x)])


def meshgrid(*args):
    """``ij``-indexed grids, not recorded (as in the JAX package)."""
    arrs = [_t(a)._value.detach() for a in args]
    return [Tensor._wrap(m) for m in torch.meshgrid(*arrs, indexing="ij")]


def assign(x, output=None) -> Tensor:
    """A copy of ``x`` (not recorded); into ``output`` when given."""
    src = x._value if isinstance(x, Tensor) else \
        _as_payload(x, None, _dev() if output is None else
                    getattr(output, "_value", output).device)
    if output is not None:
        if isinstance(output, Tensor):
            output._set_value(src)
        else:
            output.set_value(src)
        return output
    return Tensor(src)


def clone(x) -> Tensor:
    return _t(x).clone()


def numel(x) -> Tensor:
    v = _t(x)._value
    return Tensor._wrap(torch.tensor(v.numel(), dtype=torch.int32,
                                     device=v.device))
