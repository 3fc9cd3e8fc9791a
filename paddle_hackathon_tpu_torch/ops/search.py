"""Search / sort ops (the JAX package's ``ops/search.py``).  Index
outputs are int32; ``sort`` returns values only; ties keep the lower
index first (``topk``, ``kthvalue`` and ``argsort`` sort stably)."""

from __future__ import annotations

import builtins as _b

import torch

from ..core import autograd
from ..core.autograd import apply_op
from ._common import index as _index
from ._common import to_t as _t


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    with autograd.no_grad():
        def fn(v):
            if axis is None:
                return torch.argmax(v.reshape(-1)).to(torch.int32)
            return torch.argmax(v, dim=axis, keepdim=keepdim).to(torch.int32)
        return apply_op("argmax", fn, [_t(x)])


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    with autograd.no_grad():
        def fn(v):
            if axis is None:
                return torch.argmin(v.reshape(-1)).to(torch.int32)
            return torch.argmin(v, dim=axis, keepdim=keepdim).to(torch.int32)
        return apply_op("argmin", fn, [_t(x)])


def _stable_order(v, axis, descending):
    """Indices that sort ``v`` along ``axis``, ties in their original
    order (descending too)."""
    return torch.sort(v, dim=axis, descending=descending, stable=True)


def argsort(x, axis=-1, descending=False, stable=True, name=None):
    with autograd.no_grad():
        return apply_op("argsort", lambda v: _stable_order(
            v, axis, descending).indices.to(torch.int32), [_t(x)])


def sort(x, axis=-1, descending=False, stable=True, name=None):
    return apply_op("sort", lambda v: _stable_order(
        v, axis, descending).values, [_t(x)])


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    """The ``k`` largest (or smallest) along ``axis``, sorted, ties by
    index."""
    if hasattr(k, "item"):
        k = int(k.item())

    def fn(v):
        ax = axis % v.dim()
        srt = _stable_order(v, ax, largest)
        return (srt.values.narrow(ax, 0, k),
                srt.indices.narrow(ax, 0, k).to(torch.int32))
    vals, idx = apply_op("topk", fn, [_t(x)])
    idx.stop_gradient = True
    return vals, idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(v):
        ax = axis % v.dim()
        srt = _stable_order(v, ax, False)
        vals = srt.values.select(ax, k - 1)
        idx = srt.indices.select(ax, k - 1)
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx.to(torch.int32)
    vals, idx = apply_op("kthvalue", fn, [_t(x)])
    idx.stop_gradient = True
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the index of its first occurrence."""
    def fn(v):
        ax = axis % v.dim()
        moved = torch.movedim(v, ax, -1)
        sorted_v = torch.sort(moved, dim=-1).values
        runs = torch.sum(sorted_v[..., :, None] == sorted_v[..., None, :],
                         dim=-1)
        best = torch.argmax(runs, dim=-1)
        vals = torch.take_along_dim(sorted_v, best[..., None], dim=-1)[..., 0]
        idx = torch.argmax((moved == vals[..., None]).to(torch.int32), dim=-1)
        if keepdim:
            vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
        return vals, idx.to(torch.int32)
    vals, idx = apply_op("mode", fn, [_t(x)])
    idx.stop_gradient = True
    return vals, idx


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    with autograd.no_grad():
        def fn(seq, v):
            if seq.dim() == 1:
                return torch.searchsorted(seq, v, right=right, out_int32=True)
            out = torch.searchsorted(
                seq.reshape(-1, seq.shape[-1]), v.reshape(-1, v.shape[-1]),
                right=right, out_int32=True)
            return out.reshape(v.shape)
        seq = _t(sorted_sequence)
        return apply_op("searchsorted", fn, [seq, _t(values, seq)])


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """Counts in ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0), int32."""
    with autograd.no_grad():
        def fn(v):
            return torch.histc(v.float(), bins=bins, min=min,
                               max=max).to(torch.int32)
        return apply_op("histogram", fn, [_t(input)])


def bincount(x, weights=None, minlength=0, name=None):
    with autograd.no_grad():
        arr = _t(x)
        n = int(_b.max(int(arr._value.max()) + 1 if arr.size else 1,
                       minlength))

        def fn(v, *w):
            return torch.bincount(_index(v.reshape(-1)),
                                  weights=w[0].reshape(-1) if w else None,
                                  minlength=n)
        args = [arr] + ([_t(weights, arr)] if weights is not None else [])
        return apply_op("bincount", fn, args)
