"""Shape / layout manipulation ops (the JAX package's
``ops/manipulation.py``), with Paddle's meanings: ``split`` by count or
sections (-1 allowed), ``gather`` an index-select, ``scatter`` an
overwrite (or zero-then-add), ``unique`` numpy's tuple, ``expand`` with
-1, ``flatten(start_axis, stop_axis)``, ``where`` with one argument the
nonzero indices.  Index tensors are widened to int64 only where torch
requires it.
"""

from __future__ import annotations

import builtins as _b

import numpy as np
import torch
import torch.nn.functional as _F

from ..core import autograd
from ..core.autograd import apply_op
from ..core.dtype import convert_dtype, narrow
from ..core.tensor import Tensor
from ._common import dev as _dev
from ._common import index as _index
from ._common import ints as _ints
from ._common import pair as _pair
from ._common import to_t as _t

_py_slice = _b.slice  # the `slice` op below shadows the builtin


def reshape(x, shape, name=None):
    return apply_op("reshape", lambda v: v.reshape(_ints(shape)), [_t(x)])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(v):
        nd = v.dim()
        s, e = start_axis % nd, stop_axis % nd
        return v.reshape(tuple(v.shape[:s]) + (-1,) + tuple(v.shape[e + 1:]))
    return apply_op("flatten", fn, [_t(x)])


def transpose(x, perm, name=None):
    return apply_op("transpose", lambda v: v.permute(_ints(perm)), [_t(x)])


def t(x, name=None):
    """All axes reversed (the 2-D transpose)."""
    return apply_op("t", lambda v: v.permute(*reversed(range(v.dim()))),
                    [_t(x)])


def moveaxis(x, source, destination, name=None):
    return apply_op("moveaxis", lambda v: torch.movedim(
        v, _ints(source), _ints(destination)), [_t(x)])


def swapaxes(x, axis0, axis1, name=None):
    return apply_op("swapaxes",
                    lambda v: torch.swapaxes(v, int(axis0), int(axis1)),
                    [_t(x)])


def squeeze(x, axis=None, name=None):
    def fn(v):
        if axis is None:
            return torch.squeeze(v)
        axes = _ints(axis if isinstance(axis, (list, tuple)) else [axis])
        axes = tuple(a for a in axes if v.shape[a] == 1)
        return torch.squeeze(v, axes) if axes else v
    return apply_op("squeeze", fn, [_t(x)])


def unsqueeze(x, axis, name=None):
    axes = _ints(axis if isinstance(axis, (list, tuple, Tensor)) else [axis])

    def fn(v):
        nd = v.dim() + len(axes)
        for a in sorted(a % nd for a in axes):
            v = v.unsqueeze(a)
        return v
    return apply_op("unsqueeze", fn, [_t(x)])


def concat(x, axis=0, name=None):
    tensors = [_t(v) for v in x]
    ax = int(axis._value) if isinstance(axis, Tensor) else int(axis)
    return apply_op("concat", lambda *vs: torch.cat(vs, dim=ax), tensors)


def stack(x, axis=0, name=None):
    tensors = [_t(v) for v in x]
    return apply_op("stack", lambda *vs: torch.stack(vs, dim=int(axis)),
                    tensors)


def unstack(x, axis=0, num=None, name=None):
    x = _t(x)
    n = num if num is not None else x.shape[axis]
    outs = apply_op(
        "unstack",
        lambda v: tuple(torch.movedim(v, axis, 0)[i] for i in range(n)),
        [x])
    return list(outs)


def unbind(input, axis=0):  # noqa: A002
    return unstack(input, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` an int (that many pieces of ``dim // n``) or
    the section sizes, one of which may be -1 (the rest)."""
    x = _t(x)
    ax = int(axis._value) if isinstance(axis, Tensor) else int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if _b.any(s == -1 for s in sizes):
            rest = dim - _b.sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
    offsets = np.cumsum([0] + sizes)[:-1]

    def fn(v):
        return tuple(v.narrow(ax, int(o), int(s))
                     for o, s in zip(offsets, sizes))
    return list(apply_op("split", fn, [x]))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def tile(x, repeat_times, name=None):
    return apply_op("tile", lambda v: torch.tile(v, _ints(repeat_times)),
                    [_t(x)])


def expand(x, shape, name=None):
    tgt = _ints(shape)

    def fn(v):
        full = list(tgt)
        off = len(full) - v.dim()
        for i in range(v.dim()):
            if full[off + i] == -1:
                full[off + i] = v.shape[i]
        return torch.broadcast_to(v, tuple(full))
    return apply_op("expand", fn, [_t(x)])


def expand_as(x, y, name=None):
    return apply_op("expand_as", lambda v, w: torch.broadcast_to(v, w.shape),
                    [_t(x), _t(y)])


def broadcast_to(x, shape, name=None):
    return apply_op("broadcast_to",
                    lambda v: torch.broadcast_to(v, _ints(shape)), [_t(x)])


def broadcast_tensors(inputs, name=None):
    tensors = [_t(v) for v in inputs]
    outs = apply_op("broadcast_tensors",
                    lambda *vs: tuple(torch.broadcast_tensors(*vs)), tensors)
    return list(outs)


def flip(x, axis, name=None):
    return apply_op("flip", lambda v: torch.flip(v, _ints(axis)), [_t(x)])


def roll(x, shifts, axis=None, name=None):
    def fn(v):
        if axis is None:
            return torch.roll(v.reshape(-1),
                              _ints(shifts)[0]).reshape(v.shape)
        return torch.roll(v, _ints(shifts), _ints(axis))
    return apply_op("roll", fn, [_t(x)])


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op("rot90", lambda v: torch.rot90(v, k, tuple(axes)),
                    [_t(x)])


def cast(x, dtype):
    d = narrow(convert_dtype(dtype))
    return apply_op("cast", lambda v: v.to(d), [_t(x)])


def _pad_index(n, lo, hi, mode):
    """Source rows of one padded axis for the numpy modes ``reflect``
    (edge not repeated), ``edge`` and ``wrap``."""
    i = np.arange(-lo, n + hi)
    if mode == "edge":
        i = np.clip(i, 0, n - 1)
    elif mode == "wrap":
        i = np.mod(i, n)
    else:   # reflect
        period = 2 * (n - 1) if n > 1 else 1
        i = np.abs(np.mod(i, period))
        i = np.where(i >= n, period - i, i)
    return i


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """``pad`` covers every dim (``2 * ndim`` entries, in dim order) or
    the trailing spatial dims of ``data_format`` (Paddle's order: the last
    spatial dim first)."""
    x = _t(x)
    nd = x.ndim
    p = _ints(pad)
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        width = [(0, 0)] * nd
        if data_format.endswith("C"):  # NHWC / NLC / NDHWC
            spatial = list(range(1, nd - 1))
        else:  # NCHW / NCL / NCDHW
            spatial = list(range(2, nd))
        pairs = [(p[i], p[i + 1]) for i in range(0, len(p), 2)]
        for dim, pr in zip(reversed(spatial), pairs):
            width[dim] = pr
    nmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]

    def fn(v):
        if nmode == "constant":
            flat = []
            for lo, hi in reversed(width):
                flat += [lo, hi]
            return _F.pad(v, flat, value=value)
        for d, (lo, hi) in enumerate(width):
            if lo or hi:
                idx = torch.as_tensor(_pad_index(v.shape[d], lo, hi, nmode),
                                      device=v.device)
                v = torch.index_select(v, d, idx)
        return v
    return apply_op("pad", fn, [x])


# -- gather / scatter -------------------------------------------------------
def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at the flattened ``index``
    (an index-select)."""
    ax = int(axis._value) if isinstance(axis, Tensor) else int(axis)
    return apply_op("gather", lambda v, i: torch.index_select(
        v, ax, _index(i.reshape(-1))), [_t(x), _t(index)])


def gather_nd(x, index, name=None):
    def fn(v, idx):
        idx = _index(idx)
        return v[tuple(idx[..., i] for i in range(idx.shape[-1]))]
    return apply_op("gather_nd", fn, [_t(x), _t(index)])


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply_op("take_along_axis", lambda v, i: torch.take_along_dim(
        v, _index(i), dim=axis), [_t(arr), _t(indices)])


def put_along_axis(arr, indices, values, axis, reduce="assign",  # noqa: A002
                   name=None):
    def fn(v, i, val):
        i = _index(i)
        val = torch.broadcast_to(val.to(v.dtype), i.shape)
        if reduce == "assign":
            return torch.scatter(v, axis, i, val)
        if reduce == "add":
            return torch.scatter_add(v, axis, i, val)
        if reduce in ("mul", "multiply"):
            return torch.scatter_reduce(v, axis, i, val, "prod")
        raise KeyError(reduce)
    arr = _t(arr)
    return apply_op("put_along_axis", fn,
                    [arr, _t(indices), _t(values, arr)])


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of ``x`` at ``index`` replaced by ``updates`` (``overwrite``),
    or zeroed and then summed over (duplicates add up)."""
    def fn(v, i, u):
        i = (_index(i.reshape(-1)),)
        if overwrite:
            return torch.index_put(v, i, u.to(v.dtype))
        base = torch.index_put(v, i, torch.zeros_like(u, dtype=v.dtype))
        return torch.index_put(base, i, u.to(v.dtype), accumulate=True)
    return apply_op("scatter", fn, [_t(x), _t(index), _t(updates)])


def scatter_nd_add(x, index, updates, name=None):
    def fn(v, i, u):
        i = _index(i)
        idx = tuple(i[..., d] for d in range(i.shape[-1]))
        return torch.index_put(v, idx, u.to(v.dtype), accumulate=True)
    return apply_op("scatter_nd_add", fn, [_t(x), _t(index), _t(updates)])


def scatter_nd(index, updates, shape, name=None):
    zeros_shape = _ints(shape)

    def fn(i, u):
        i = _index(i)
        idx = tuple(i[..., d] for d in range(i.shape[-1]))
        return torch.index_put(
            torch.zeros(zeros_shape, dtype=u.dtype, device=u.device), idx, u,
            accumulate=True)
    return apply_op("scatter_nd", fn, [_t(index), _t(updates)])


def index_select(x, index, axis=0, name=None):
    return apply_op("index_select", lambda v, i: torch.index_select(
        v, axis, _index(i.reshape(-1))), [_t(x), _t(index)])


def index_sample(x, index):
    return apply_op("index_sample", lambda v, i: torch.take_along_dim(
        v, _index(i), dim=1), [_t(x), _t(index)])


def index_add(x, index, axis, value, name=None):
    return apply_op("index_add", lambda v, i, u: torch.index_add(
        v, axis, _index(i.reshape(-1)), u.to(v.dtype)),
        [_t(x), _t(index), _t(value)])


def index_put(x, indices, value, accumulate=False, name=None):
    def fn(v, u, *idx):
        idx = tuple(i if i.dtype == torch.bool else _index(i) for i in idx)
        return torch.index_put(v, idx, u.to(v.dtype), accumulate=accumulate)
    x = _t(x)
    idx_t = [_t(i, x) for i in indices]
    return apply_op("index_put", fn, [x, _t(value, x)] + idx_t)


def masked_select(x, mask, name=None):
    """The entries of ``x`` where ``mask`` holds, flattened (not recorded:
    a data-dependent shape, as in the JAX package)."""
    x, mask = _pair(x, mask)
    return Tensor._wrap(x._value.detach()[mask._value.bool()])


def masked_fill(x, mask, value, name=None):
    v = value._value if isinstance(value, Tensor) else value

    def fn(a, m):
        return torch.where(m.bool(), torch.as_tensor(v, dtype=a.dtype,
                                                     device=a.device), a)
    return apply_op("masked_fill", fn, list(_pair(x, mask)))


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with one argument, the
    indices of the nonzero entries, one tensor per axis."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    c = _t(condition)
    a, b = _pair(x, y) if isinstance(x, (Tensor, torch.Tensor)) or \
        isinstance(y, (Tensor, torch.Tensor)) else (_t(x, c), _t(y, c))
    return apply_op("where", lambda c_, a_, b_: torch.where(c_.bool(), a_, b_),
                    [c, a, b])


def nonzero(x, as_tuple=False):
    """Indices of the nonzero entries (not recorded)."""
    v = _t(x)._value.detach()
    if as_tuple:
        return tuple(Tensor._wrap(i) for i in torch.nonzero(v, as_tuple=True))
    return Tensor._wrap(torch.nonzero(v))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's ``unique`` on the tensor's own device: the sorted values in
    the input's dtype, then the first indices, the inverse (the input's
    shape when ``axis`` is None) and the counts, as asked (not
    recorded)."""
    v = _t(x)._value.detach()
    vals, inv, counts = torch.unique(v, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        flat = inv.reshape(-1)
        n = flat.numel()
        first = torch.full((vals.shape[0] if axis is not None
                            else vals.numel(),), n, dtype=flat.dtype,
                           device=v.device)
        out.append(first.scatter_reduce_(
            0, flat, torch.arange(n, device=v.device), reduce="amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    if len(out) == 1:
        return Tensor._wrap(vals)
    return tuple(Tensor._wrap(o) for o in out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Runs of equal entries (of the flattened input when ``axis`` is None,
    else of slices along axis 0, whatever ``axis`` names, as in the JAX
    package), on the tensor's own device (not recorded)."""
    v = _t(x)._value.detach()
    if axis is None:
        v = v.reshape(-1)
    vals, inv, counts = torch.unique_consecutive(
        v, return_inverse=True, return_counts=True, dim=0)
    out = [vals] + [inv] * return_inverse + [counts] * return_counts
    if len(out) == 1:
        return Tensor._wrap(vals)
    return tuple(Tensor._wrap(o) for o in out)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        repeats = repeats._value.tolist()

    def fn(v):
        r = repeats if isinstance(repeats, int) else torch.as_tensor(
            repeats, device=v.device)
        return torch.repeat_interleave(v, r, dim=axis)
    return apply_op("repeat_interleave", fn, [_t(x)])


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis (negative strides too)."""
    def fn(v):
        for ax, s, e, st in zip(_ints(axes), _ints(starts), _ints(ends),
                                _ints(strides)):
            bounds = _py_slice(s, e, st).indices(v.shape[ax])
            if st > 0:
                idx = [_py_slice(None)] * v.dim()
                idx[ax] = _py_slice(*bounds)
                v = v[tuple(idx)]
            else:
                rng = range(*bounds)
                v = torch.index_select(v, ax, torch.as_tensor(
                    list(rng), dtype=torch.long, device=v.device))
        return v
    return apply_op("strided_slice", fn, [_t(x)])


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    return strided_slice(x, axes, starts, ends, [1] * len(_ints(axes)))


def crop(x, shape=None, offsets=None, name=None):
    """A ``shape`` window at ``offsets``, shifted back to fit (as
    ``lax.dynamic_slice``)."""
    x = _t(x)
    shp = _ints(shape) if shape is not None else tuple(x.shape)
    offs = _ints(offsets) if offsets is not None else (0,) * x.ndim

    def fn(v):
        for d, (o, s) in enumerate(zip(offs, shp)):
            o = _b.min(_b.max(o, 0), v.shape[d] - s)
            v = v.narrow(d, o, s)
        return v
    return apply_op("crop", fn, [x])


def as_complex(x, name=None):
    return apply_op("as_complex",
                    lambda v: torch.complex(v[..., 0], v[..., 1]), [_t(x)])


def as_real(x, name=None):
    return apply_op("as_real", lambda v: torch.stack(
        [torch.real(v), torch.imag(v)], dim=-1), [_t(x)])


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    d = convert_dtype(shape_or_dtype)
    return apply_op("view_dtype", lambda v: v.view(d), [_t(x)])


def atleast_1d(*inputs):
    outs = [apply_op("atleast_1d", torch.atleast_1d, [_t(x)])
            for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs):
    outs = [apply_op("atleast_2d", torch.atleast_2d, [_t(x)])
            for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs):
    outs = [apply_op("atleast_3d", torch.atleast_3d, [_t(x)])
            for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    def fn(v):
        shard_size = (index_num + nshards - 1) // nshards
        lo, hi = shard_id * shard_size, (shard_id + 1) * shard_size
        in_shard = (v >= lo) & (v < hi)
        return torch.where(in_shard, v - lo, torch.full_like(v, ignore_value))
    with autograd.no_grad():
        return apply_op("shard_index", fn, [_t(input)])


def reverse(x, axis, name=None):
    """Legacy ``paddle.reverse`` (= flip)."""
    ax = [axis] if isinstance(axis, int) else list(axis)
    return apply_op("reverse", lambda v: torch.flip(v, ax), [_t(x)])


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = row if col is None else col
    out = torch.tril_indices(row, col, offset, device=_dev())
    return Tensor._wrap(out.to(narrow(convert_dtype(dtype))))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = row if col is None else col
    out = torch.triu_indices(row, col, offset, device=_dev())
    return Tensor._wrap(out.to(narrow(convert_dtype(dtype))))
