"""Elementwise math and reduction ops (the JAX package's
``ops/math.py``): each a torch composition through ``apply_op``, with the
JAX package's meaning (reductions return values only, ``median`` averages
the two middle values, integer sums stay int32...).
"""

from __future__ import annotations

import builtins as _b
import functools as _functools

import torch

from ..core import autograd
from ..core.autograd import apply_op
from ..core.dtype import convert_dtype
from ..core.dtype import default_float_dtype as _default_float
from ..core.tensor import Tensor
from ._common import axis as _axis
from ._common import pair as _pair
from ._common import to_t as _t


def _unary(name, fn):
    def op(x, name=None):
        return apply_op(name_, fn, [_t(x)])
    name_ = name
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"Elementwise {name}."
    return op


def _binary(name, fn):
    def op(x, y, name=None):
        return apply_op(name_, fn, list(_pair(x, y)))
    name_ = name
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"Elementwise {name} with numpy broadcasting."
    return op


def _float(v):
    """Integers and bools as the default float dtype (jnp's promotion of
    a transcendental's integer input)."""
    return v if v.is_floating_point() or v.is_complex() else \
        v.to(_default_float())


def _same(a, b):
    """Both operands at their promoted dtype."""
    d = torch.result_type(a, b)
    return a.to(d), b.to(d)


def _imag(v):
    return torch.imag(v) if v.is_complex() else torch.zeros_like(v)


def _heaviside(a, b):
    a, b = _same(a, b)
    return torch.heaviside(a, b)


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


# -- unary ------------------------------------------------------------------
exp = _unary("exp", lambda v: torch.exp(_float(v)))
expm1 = _unary("expm1", lambda v: torch.expm1(_float(v)))
log = _unary("log", lambda v: torch.log(_float(v)))
log2 = _unary("log2", lambda v: torch.log2(_float(v)))
log10 = _unary("log10", lambda v: torch.log10(_float(v)))
log1p = _unary("log1p", lambda v: torch.log1p(_float(v)))
sqrt = _unary("sqrt", lambda v: torch.sqrt(_float(v)))
rsqrt = _unary("rsqrt", lambda v: torch.rsqrt(_float(v)))
abs = _unary("abs", torch.abs)  # noqa: A001 - matches paddle.abs
sign = _unary("sign", torch.sign)
floor = _unary("floor", lambda v: torch.floor(_float(v)))
ceil = _unary("ceil", lambda v: torch.ceil(_float(v)))
round = _unary("round", lambda v: torch.round(_float(v)))  # noqa: A001
trunc = _unary("trunc", lambda v: torch.trunc(_float(v)))
frac = _unary("frac", lambda v: v - torch.trunc(v))
sin = _unary("sin", lambda v: torch.sin(_float(v)))
cos = _unary("cos", lambda v: torch.cos(_float(v)))
tan = _unary("tan", lambda v: torch.tan(_float(v)))
asin = _unary("asin", lambda v: torch.asin(_float(v)))
acos = _unary("acos", lambda v: torch.acos(_float(v)))
atan = _unary("atan", lambda v: torch.atan(_float(v)))
sinh = _unary("sinh", lambda v: torch.sinh(_float(v)))
cosh = _unary("cosh", lambda v: torch.cosh(_float(v)))
tanh = _unary("tanh", lambda v: torch.tanh(_float(v)))
asinh = _unary("asinh", lambda v: torch.asinh(_float(v)))
acosh = _unary("acosh", lambda v: torch.acosh(_float(v)))
atanh = _unary("atanh", lambda v: torch.atanh(_float(v)))
reciprocal = _unary("reciprocal", lambda v: 1.0 / v)
square = _unary("square", torch.square)
neg = _unary("neg", torch.neg)
erf = _unary("erf", lambda v: torch.special.erf(_float(v)))
erfinv = _unary("erfinv", lambda v: torch.special.erfinv(_float(v)))
digamma = _unary("digamma", lambda v: torch.special.digamma(_float(v)))
lgamma = _unary("lgamma", lambda v: torch.lgamma(_float(v)))
angle = _unary("angle", lambda v: torch.angle(_float(v)))
conj = _unary("conj", torch.conj_physical)
real = _unary("real", torch.real)
imag = _unary("imag", _imag)

# -- binary -----------------------------------------------------------------
add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow = _binary("pow", torch.pow)  # noqa: A001
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", lambda a, b: torch.atan2(_float(a), _float(b)))
logaddexp = _binary("logaddexp",
                    lambda a, b: torch.logaddexp(_float(a), _float(b)))
heaviside = _binary("heaviside", _heaviside)
hypot = _binary("hypot", lambda a, b: torch.hypot(*_same(_float(a),
                                                         _float(b))))
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
kron = _binary("kron", torch.kron)
inner = _binary("inner", torch.inner)
outer = _binary("outer", _outer)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``), then ``act``."""
    def fn(v):
        return v * scale + bias if bias_after_scale else (v + bias) * scale
    out = apply_op("scale", fn, [_t(x)])
    if act == "relu":
        return apply_op("relu", torch.relu, [out])
    return out


def clip(x, min=None, max=None, name=None):  # noqa: A002
    """Clamp to ``[min, max]`` (either may be None); an integer ``x``
    with a float bound becomes the default float dtype."""
    lo = min._value if isinstance(min, Tensor) else min
    hi = max._value if isinstance(max, Tensor) else max

    def fn(v):
        if not v.is_floating_point() and _b.any(
                isinstance(b, float) or (isinstance(b, torch.Tensor)
                                         and b.is_floating_point())
                for b in (lo, hi)):
            v = v.to(_default_float())
        if lo is None and hi is None:
            return v.clone()
        return torch.clamp(v, lo, hi)
    return apply_op("clip", fn, [_t(x)])


def lerp(x, y, weight, name=None):
    x, y = _pair(x, y)
    w = _t(weight, x)
    return apply_op("lerp", lambda a, b, t: a + t * (b - a), [x, y, w])


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return apply_op("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
                    [_t(input), _t(x), _t(y)])


def multiplex(inputs, index, name=None):
    stacked = stack(inputs, axis=0)
    idx = _t(index)._value.reshape(-1).long()
    return apply_op(
        "multiplex",
        lambda s: s[idx, torch.arange(s.shape[1], device=s.device)],
        [stacked])


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op("nan_to_num",
                    lambda v: torch.nan_to_num(v, nan=nan, posinf=posinf,
                                               neginf=neginf), [_t(x)])


def isnan(x, name=None):
    with autograd.no_grad():
        return apply_op("isnan", torch.isnan, [_t(x)])


def isinf(x, name=None):
    with autograd.no_grad():
        return apply_op("isinf", torch.isinf, [_t(x)])


def isfinite(x, name=None):
    with autograd.no_grad():
        return apply_op("isfinite", torch.isfinite, [_t(x)])


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    with autograd.no_grad():
        return apply_op(
            "isclose", lambda a, b: torch.isclose(
                *_same(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan),
            list(_pair(x, y)))


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    with autograd.no_grad():
        return apply_op(
            "allclose", lambda a, b: torch.isclose(
                *_same(a, b), rtol=rtol, atol=atol,
                equal_nan=equal_nan).all(), list(_pair(x, y)))


def _array_equal(a, b):
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    a, b = _same(a, b)
    return torch.eq(a, b).all()


def equal_all(x, y, name=None):
    with autograd.no_grad():
        return apply_op("equal_all", _array_equal, list(_pair(x, y)))


# -- logical ----------------------------------------------------------------
def _logical(name, fn):
    def op(x, y=None, out=None, name=None):
        with autograd.no_grad():
            if y is None:
                return apply_op(name_, fn, [_t(x)])
            return apply_op(name_, fn, list(_pair(x, y)))
    name_ = name
    op.__name__ = name
    op.__qualname__ = name
    return op


logical_and = _logical("logical_and", torch.logical_and)
logical_or = _logical("logical_or", torch.logical_or)
logical_xor = _logical("logical_xor", torch.logical_xor)
logical_not = _logical("logical_not", torch.logical_not)
bitwise_and = _logical("bitwise_and", torch.bitwise_and)
bitwise_or = _logical("bitwise_or", torch.bitwise_or)
bitwise_xor = _logical("bitwise_xor", torch.bitwise_xor)
bitwise_not = _logical("bitwise_not", torch.bitwise_not)

equal = _logical("equal", torch.eq)
not_equal = _logical("not_equal", torch.ne)
less_than = _logical("less_than", torch.lt)
less_equal = _logical("less_equal", torch.le)
greater_than = _logical("greater_than", torch.gt)
greater_equal = _logical("greater_equal", torch.ge)


# -- reductions -------------------------------------------------------------
def _dims(v, ax):
    """A reduction axis as torch's ``dim``: every axis for None."""
    if ax is None:
        return tuple(range(v.dim()))
    return ax


def _to_last(v, ax):
    """Move the axes ``ax`` (None: all) to the end and flatten them into
    one; -> (moved, the kept shape with ones at ``ax``)."""
    dims = _dims(v, ax)
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    dims = tuple(d % v.dim() for d in dims) if v.dim() else ()
    keep = [d for d in range(v.dim()) if d not in dims]
    moved = v.permute(*keep, *dims).reshape(
        [v.shape[d] for d in keep] + [-1])
    kshape = [1 if d in dims else v.shape[d] for d in range(v.dim())]
    return moved, kshape


def _last_reduce(fn):
    """A reduction over one trailing axis, taken over any axes."""
    def run(v, axis=None, keepdims=False):
        moved, kshape = _to_last(v, axis)
        out = fn(moved)
        return out.reshape(kshape) if keepdims else out
    return run


def _sum(v, axis=None, keepdims=False):
    return torch.sum(v, dim=_dims(v, axis), keepdim=keepdims)


def _mean(v, axis=None, keepdims=False):
    return torch.mean(_float(v), dim=_dims(v, axis), keepdim=keepdims)


def _amax(v, axis=None, keepdims=False):
    return torch.amax(v, dim=_dims(v, axis), keepdim=keepdims)


def _amin(v, axis=None, keepdims=False):
    return torch.amin(v, dim=_dims(v, axis), keepdim=keepdims)


def _nansum(v, axis=None, keepdims=False):
    return torch.nansum(v, dim=_dims(v, axis), keepdim=keepdims)


def _nanmean(v, axis=None, keepdims=False):
    return torch.nanmean(_float(v), dim=_dims(v, axis), keepdim=keepdims)


def _logsumexp(v, axis=None, keepdims=False):
    return torch.logsumexp(_float(v), dim=_dims(v, axis), keepdim=keepdims)


def _reduce(name, fn):
    def op(x, axis=None, keepdim=False, name=None):
        ax = _axis(axis)
        return apply_op(name_, lambda v: fn(v, axis=ax, keepdims=keepdim),
                        [_t(x)])
    name_ = name
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"Reduce-{name}."
    return op


sum = _reduce("sum", _sum)  # noqa: A001
mean = _reduce("mean", _mean)
prod = _reduce("prod", _last_reduce(lambda m: torch.prod(m, -1)))
max = _reduce("max", _amax)  # noqa: A001
min = _reduce("min", _amin)  # noqa: A001
amax = _reduce("amax", _amax)
amin = _reduce("amin", _amin)
nansum = _reduce("nansum", _nansum)
nanmean = _reduce("nanmean", _nanmean)
logsumexp = _reduce("logsumexp", _logsumexp)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    ax = _axis(axis)
    with autograd.no_grad():
        return apply_op("all", lambda v: torch.all(
            v.bool(), dim=_dims(v, ax), keepdim=keepdim), [_t(x)])


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    ax = _axis(axis)
    with autograd.no_grad():
        return apply_op("any", lambda v: torch.any(
            v.bool(), dim=_dims(v, ax), keepdim=keepdim), [_t(x)])


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ddof = 1 if unbiased else 0
    ax = _axis(axis)
    return apply_op("std", lambda v: torch.std(
        _float(v), dim=_dims(v, ax), correction=ddof, keepdim=keepdim),
        [_t(x)])


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ddof = 1 if unbiased else 0
    ax = _axis(axis)
    return apply_op("var", lambda v: torch.var(
        _float(v), dim=_dims(v, ax), correction=ddof, keepdim=keepdim),
        [_t(x)])


def median(x, axis=None, keepdim=False, name=None):
    """The median; with an even count, the mean of the two middle values
    (numpy's, not ``torch.median``'s lower one)."""
    ax = _axis(axis)
    return apply_op("median", lambda v: _last_reduce(
        lambda m: torch.quantile(_float(m), 0.5, dim=-1))(
            v, ax, keepdim), [_t(x)])


def quantile(x, q, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def fn(v):
        qs = torch.as_tensor(q, dtype=_float(v).dtype, device=v.device)
        moved, kshape = _to_last(v, ax)
        out = torch.quantile(_float(moved), qs, dim=-1)
        if keepdim:
            out = out.reshape(tuple(qs.shape) + tuple(kshape))
        return out
    return apply_op("quantile", fn, [_t(x)])


def cumsum(x, axis=None, dtype=None, name=None):
    def fn(v):
        if axis is None:
            return torch.cumsum(v.reshape(-1), 0)
        return torch.cumsum(v, int(axis))
    return apply_op("cumsum", fn, [_t(x)])


def cumprod(x, dim=None, dtype=None, name=None):
    def fn(v):
        if dim is None:
            return torch.cumprod(v.reshape(-1), 0)
        return torch.cumprod(v, int(dim))
    return apply_op("cumprod", fn, [_t(x)])


def cummax(x, axis=None, name=None):
    """Running maximum (values only)."""
    def fn(v):
        vv = v.reshape(-1) if axis is None else v
        return torch.cummax(vv, 0 if axis is None else int(axis)).values
    return apply_op("cummax", fn, [_t(x)])


def cummin(x, axis=None, name=None):
    """Running minimum (values only)."""
    def fn(v):
        vv = v.reshape(-1) if axis is None else v
        return torch.cummin(vv, 0 if axis is None else int(axis)).values
    return apply_op("cummin", fn, [_t(x)])


def diff(x, n=1, axis=-1, name=None):
    return apply_op("diff", lambda v: torch.diff(v, n=n, dim=axis), [_t(x)])


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op("trace", lambda v: torch.diagonal(
        v, offset, axis1, axis2).sum(-1), [_t(x)])


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def fn(v):
        out = torch.count_nonzero(v, dim=_dims(v, ax))
        if keepdim:
            _, kshape = _to_last(v, ax)
            out = out.reshape(kshape)
        return out
    with autograd.no_grad():
        return apply_op("count_nonzero", fn, [_t(x)])


# needed by multiplex; full version lives in manipulation.py
def stack(x, axis=0, name=None):
    tensors = [_t(v) for v in x]
    return apply_op("stack", lambda *vs: torch.stack(vs, dim=axis), tensors)


# -- round-out ops ----------------------------------------------------------
def logit(x, eps=None, name=None):
    """``log(x / (1 - x))``; inputs clamped to ``[eps, 1 - eps]`` when
    ``eps`` is given."""
    def fn(v):
        vv = torch.clamp(v, eps, 1.0 - eps) if eps is not None else v
        return torch.log(vv / (1 - vv))
    return apply_op("logit", fn, [_t(x)])


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """``scale_b * tanh(scale_a * x)``."""
    return apply_op("stanh", lambda v: scale_b * torch.tanh(scale_a * v),
                    [_t(x)])


rad2deg = _unary("rad2deg", lambda v: torch.rad2deg(_float(v)))
deg2rad = _unary("deg2rad", lambda v: torch.deg2rad(_float(v)))


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def fn(v):
        vv = v.reshape(-1) if axis is None else v
        out = torch.logcumsumexp(vv, 0 if axis is None else int(axis))
        return out.to(convert_dtype(dtype)) if dtype else out
    return apply_op("logcumsumexp", fn, [_t(x)])


def renorm(x, p, axis, max_norm, name=None):
    """Renormalise the slices along ``axis`` to at most ``max_norm`` in
    p-norm."""
    def fn(v):
        red = tuple(i for i in range(v.dim()) if i != axis % v.dim())
        norms = torch.sum(torch.abs(v) ** p, dim=red, keepdim=True) \
            ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return v * factor
    return apply_op("renorm", fn, [_t(x)])


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op("nanmedian", lambda v: _last_reduce(
        lambda m: torch.nanquantile(_float(m), 0.5, dim=-1))(
            v, ax, keepdim), [_t(x)])


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def fn(v):
        qs = torch.as_tensor(q, dtype=_float(v).dtype, device=v.device)
        moved, kshape = _to_last(v, ax)
        out = torch.nanquantile(_float(moved), qs, dim=-1)
        if keepdim:
            out = out.reshape(tuple(qs.shape) + tuple(kshape))
        return out
    return apply_op("nanquantile", fn, [_t(x)])


def complex(real, imag, name=None):  # noqa: A001
    """A complex tensor from its real and imaginary parts."""
    return apply_op("complex", lambda a, b: torch.complex(*_same(a, b)),
                    list(_pair(real, imag)))


def add_n(inputs, name=None):
    """The sum of a list of tensors."""
    if isinstance(inputs, Tensor):
        return inputs
    tensors = [_t(v) for v in inputs]
    return apply_op("add_n",
                    lambda *vs: _functools.reduce(torch.add, vs), tensors)


def increment(x, value=1.0, name=None):
    """Add a scalar in place (a rebind); returns ``x``."""
    x._set_value(x._value.detach() + value)
    return x


def tensordot(x, y, axes=2, name=None):
    def fn(a, b):
        ax = axes
        if isinstance(ax, Tensor):
            ax = ax.tolist()
        if isinstance(ax, (list, tuple)):
            ax = [[int(i) for i in (a_ if isinstance(a_, (list, tuple))
                                    else [a_])] for a_ in ax]
            if len(ax) == 1:
                ax = [ax[0], ax[0]]
        return torch.tensordot(a, b, dims=ax)
    return apply_op("tensordot", fn, [_t(x), _t(y)])


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def rank(input, name=None):  # noqa: A002
    v = _t(input)._value
    return Tensor._wrap(torch.tensor(v.dim(), dtype=torch.int32,
                                     device=v.device))


def shape(input, name=None):  # noqa: A002
    v = _t(input)._value
    return Tensor._wrap(torch.tensor(list(v.shape), dtype=torch.int32,
                                     device=v.device))


def is_tensor(x):
    return isinstance(x, (Tensor, torch.Tensor))


def is_complex(x):
    return _t(x)._value.is_complex()


def is_integer(x):
    v = _t(x)._value
    return not (v.is_floating_point() or v.is_complex()
                or v.dtype == torch.bool)


def is_floating_point(x):
    return _t(x)._value.is_floating_point()


def is_empty(x, name=None):
    v = _t(x)._value
    return Tensor._wrap(torch.tensor(v.numel() == 0, device=v.device))


def tolist(x):
    return _t(x).tolist()
