"""Helpers the op modules share (imported under private names, so that
``OP_TABLE`` does not take them for ops)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import device
from ..core.dtype import convert_dtype, default_float_dtype, narrow
from ..core.tensor import Tensor, _as_payload


def to_t(x, like=None) -> Tensor:
    """``x`` as a ``Tensor``: a ``Tensor`` as it is, a torch tensor (a
    ``Parameter``) wrapped without a copy, anything else made on
    ``like``'s device (a ``Tensor`` or torch tensor), else on the current
    place."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(like, Tensor):
        dev = like._value.device
    elif isinstance(like, torch.Tensor):
        dev = like.device
    else:
        dev = device.current_device()
    return Tensor._wrap(_as_payload(x, None, dev))


def pair(x, y):
    """Two operands as ``Tensor``s, a non-tensor one made on the other's
    device."""
    if isinstance(x, (Tensor, torch.Tensor)):
        return to_t(x), to_t(y, x)
    ty = to_t(y)
    return to_t(x, ty), ty


def dt(dtype, default=None) -> torch.dtype:
    """The payload dtype for ``dtype`` (default: ``default``, else the
    default float dtype), 64-bit types narrowed."""
    d = convert_dtype(dtype)
    if d is None:
        d = default if default is not None else default_float_dtype()
    return narrow(d)


def dev() -> torch.device:
    return device.current_device()


def ints(seq):
    """A shape-like (an int, a sequence of ints or 0-d tensors, or a
    tensor) -> a tuple of python ints."""
    if isinstance(seq, Tensor):
        seq = seq._value.tolist()
    elif isinstance(seq, torch.Tensor):
        seq = seq.tolist()
    if isinstance(seq, (int, np.integer)):
        return (int(seq),)
    return tuple(int(s._value) if isinstance(s, Tensor) else int(s)
                 for s in seq)


def axis(ax):
    """A reduction axis: None, an int, or a tuple of ints."""
    if ax is None:
        return None
    if isinstance(ax, Tensor):
        ax = ax.tolist()
    if isinstance(ax, (list, tuple)):
        return tuple(int(a) for a in ax)
    return int(ax)


def index(i: torch.Tensor) -> torch.Tensor:
    """An index tensor widened to int64 where torch requires it."""
    return i if i.dtype == torch.int64 else i.long()
