"""The op cases the port's op-table tests and ``chip_smoke.py``'s op
sweep share: for every ``OP_TABLE`` entry, seeded inputs, how the op is
called, whether its gradients are compared and any looser tolerance
(with the reason), and :func:`run_case`, which runs one case through two
``Side``s and compares them.

This module imports neither JAX nor the JAX package, so the card's
sweep (CPU ``Tensor``s against CUDA ones, both the port's) runs it too;
``test_torch_ops.py`` and ``test_torch_ops_shape.py`` run it with the
JAX package on one side.  It holds no tests itself.
"""

import zlib

import numpy as np

RTOL, ATOL = 1e-5, 1e-6


class Side:
    """One side of a comparison: a package (the port or the JAX package),
    its op table, and the place its tensors go to (None: the package's
    default)."""

    def __init__(self, pkg, table, place=None):
        self.pkg, self.table, self.place = pkg, table, place

    def tensor(self, a, stop_gradient):
        if self.place is None:
            return self.pkg.to_tensor(a, stop_gradient=stop_gradient)
        return self.pkg.to_tensor(a, stop_gradient=stop_gradient,
                                  place=self.place)

    def activate(self):
        """Make this side's place current (the creation ops' place)."""
        if self.place is not None:
            self.pkg.set_device(self.place)


# -- inputs -----------------------------------------------------------------
def F(*shape, lo=-1.0, hi=1.0):
    """A seeded f32 array spec (values in [lo, hi))."""
    return ("f", shape, lo, hi)


def I(*shape, lo=-5, hi=5):  # noqa: E743
    return ("i", shape, lo, hi)


def B(*shape):
    return ("b", shape, 0, 0)


def _make(rng, spec):
    if isinstance(spec, tuple) and spec and spec[0] in ("f", "i", "b"):
        kind, shape, lo, hi = spec
        if kind == "f":
            return (rng.uniform(lo, hi, shape)).astype(np.float32)
        if kind == "i":
            return rng.randint(lo, hi, shape).astype(np.int32)
        return rng.rand(*shape) > 0.5
    if isinstance(spec, list):
        return [_make(rng, s) for s in spec]
    return spec


def _conv(side, a, diff):
    if isinstance(a, np.ndarray):
        return side.tensor(a, not (diff and a.dtype == np.float32))
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_conv(side, v, diff) for v in a]
    return a


def _is_tensor(x):
    """A dygraph Tensor of either package (both keep a ``_value``)."""
    return hasattr(x, "_value") and hasattr(x, "stop_gradient")


def _leaves(x):
    """Tensors anywhere in ``x``, in order."""
    if _is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _np(t):
    """A tensor's values as numpy (the port's ``numpy()``; the JAX
    package's payload); bf16 widened to f32 on both sides, since the
    port's ``numpy()`` of bf16 is its uint16 bit view."""
    if str(t.dtype) == "bfloat16":
        t = t.astype("float32")
    v = t._value
    if type(v).__module__.startswith("torch"):
        return t.numpy()
    return np.asarray(v)


def _plain(x):
    """Non-tensor outputs (python values, lists of them); None for a
    tensor."""
    if _is_tensor(x):
        return None
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


class Case:
    """``args``/``kw`` are input specs (``F``, ``I``, ``B``, lists of
    them, or plain values); ``grad``: compare gradients; ``call``: how to
    call the op (default ``op(*args, **kw)``); ``check``: a custom
    comparison ``check(jax_out, port_out, jax_args, port_args)`` in place
    of the value check; ``tol``: (rtol, atol, why) for a looser bound."""

    def __init__(self, *args, kw=None, grad=True, call=None, check=None,
                 tol=None, values=True):
        self.args, self.kw = list(args), dict(kw or {})
        self.grad, self.call, self.check = grad, call, check
        self.tol, self.values = tol, values


def run_case(name, case, ref, got):
    """Run ``case`` through the ``Side``s ``ref`` and ``got`` and hold
    ``got`` to ``ref``: shapes, dtype names, values, non-tensor outputs,
    and (``case.grad``) the gradients of a seeded weighted sum of the
    float outputs, at ``RTOL``/``ATOL`` or the case's own bound."""
    rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
    arrays = [_make(rng, s) for s in case.args]
    kw_arrays = {k: _make(rng, s) for k, s in case.kw.items()}
    call = case.call or (lambda op, a, k: op(*a, **k))
    outs = []
    for side in (ref, got):
        side.activate()
        a = [_conv(side, v, case.grad) for v in arrays]
        k = {n: _conv(side, v, False) for n, v in kw_arrays.items()}
        outs.append((call(side.table[name], a, k), a))
    (jout, ja), (tout, ta) = outs
    rtol, atol = (case.tol[0], case.tol[1]) if case.tol else (RTOL, ATOL)
    jl, tl = _leaves(jout), _leaves(tout)
    assert len(jl) == len(tl), (name, len(jl), len(tl))
    if case.check is not None:
        case.check(jout, tout, ja, ta)
    else:
        for j, t in zip(jl, tl):
            jv, tv = _np(j), _np(t)
            assert list(jv.shape) == list(tv.shape), (name, jv.shape,
                                                      tv.shape)
            assert str(j.dtype) == str(t.dtype), (name, j.dtype, t.dtype)
            if case.values:
                np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol,
                                           err_msg=name)
        assert _plain(tout) == _plain(jout), name
    if not case.grad:
        return
    # gradients of a seeded weighted sum of the float outputs
    wts = [np.asarray(np.random.RandomState(i).randn(*_np(j).shape),
                      np.float32) for i, j in enumerate(jl)]
    for side, leaves in ((ref, jl), (got, tl)):
        total = None
        for o, w in zip(leaves, wts):
            if o.stop_gradient or "float" not in str(o.dtype):
                continue
            term = (o * _conv(side, w, False)).sum()
            total = term if total is None else total + term
        if total is not None:
            total.backward()
    for j, t in zip(_leaves(ja), _leaves(ta)):
        if "float" not in str(j.dtype):
            continue
        shape = _np(j).shape
        jg = np.zeros(shape, np.float32) if j.grad is None else _np(j.grad)
        tg = np.zeros(shape, np.float32) if t.grad is None else _np(t.grad)
        np.testing.assert_allclose(tg, jg, rtol=rtol, atol=atol,
                                   err_msg=f"{name} grad")


def _distinct_rows(a):
    """Samples drawn without replacement are distinct within a row."""
    assert all(len(set(r)) == len(r) for r in a.tolist()), a


def _shape_dtype(jout, tout, *_):
    for j, t in zip(_leaves(jout), _leaves(tout)):
        assert list(_np(j).shape) == list(_np(t).shape)
        assert str(j.dtype) == str(t.dtype), (j.dtype, t.dtype)


# -- creation ---------------------------------------------------------------
CREATION = {
    "zeros": Case([2, 3], grad=False),
    "ones": Case([2, 3], kw={"dtype": "int32"}, grad=False),
    "full": Case([2, 3], 1.5, grad=False),
    "empty": Case([2, 3], grad=False),
    "zeros_like": Case(F(3, 4)),
    "ones_like": Case(F(3, 4), kw={"dtype": "int32"}),
    "full_like": Case(F(3, 4), 2.5),
    "empty_like": Case(F(3, 4)),
    "arange": Case(1, 11, 3, grad=False),
    "linspace": Case(-1.0, 2.0, 7, grad=False),
    "logspace": Case(0.0, 2.0, 5, grad=False),
    "eye": Case(3, 4, grad=False),
    "diag": Case(F(4), 1, 0.5),
    "diagflat": Case(F(2, 2), -1),
    "tril": Case(F(3, 4), -1),
    "triu": Case(F(3, 4), 1),
    "meshgrid": Case(F(3), F(4), grad=False),
    "assign": Case(F(3, 4), grad=False),
    "clone": Case(F(3, 4)),
    "numel": Case(F(3, 4), grad=False),
}

# -- math -------------------------------------------------------------------
_POS = F(3, 4, lo=0.5, hi=2.0)
_UNIT = F(3, 4, lo=-0.9, hi=0.9)
_INT_SIGNS = dict(call=lambda op, a, k: [op(a[0], a[1]), op(a[2], a[3])],
                  grad=True)

MATH = {name: Case(F(3, 4)) for name in (
    "exp", "expm1", "abs", "sign", "floor", "ceil", "round", "trunc",
    "frac", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh", "asinh",
    "square", "neg", "erf", "angle", "conj", "real", "imag", "stanh",
    "rad2deg", "deg2rad")}
MATH.update({name: Case(_POS) for name in (
    "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
    "lgamma")})
MATH.update({name: Case(_UNIT) for name in (
    "asin", "acos", "atanh", "erfinv")})
MATH.update({
    "acosh": Case(F(3, 4, lo=1.2, hi=3.0)),
    "digamma": Case(_POS, tol=(1e-4, 1e-5, "digamma's series: the two "
                                           "libraries sum it in other "
                                           "orders")),
    "logit": Case(F(3, 4, lo=0.1, hi=0.9)),
})
MATH.update({name: Case(F(3, 4), F(3, 4)) for name in (
    "add", "subtract", "multiply", "maximum", "minimum", "fmax", "fmin",
    "atan2", "logaddexp", "hypot")})
MATH.update({
    "divide": Case(F(3, 4), F(3, 4, lo=0.5, hi=2.0)),
    "pow": Case(_POS, F(3, 4)),
    "heaviside": Case(F(3, 4), F(3, 4), grad=False),
    # float operands, then int32 with negative signs (floor semantics)
    "floor_divide": Case(F(3, 4, lo=-4, hi=4), F(3, 4, lo=0.5, hi=2.0),
                         I(3, 4, lo=-9, hi=9), I(3, 4, lo=1, hi=4),
                         call=_INT_SIGNS["call"], grad=False),
    "remainder": Case(F(3, 4, lo=-4, hi=4), F(3, 4, lo=0.5, hi=2.0),
                      I(3, 4, lo=-9, hi=9), I(3, 4, lo=-4, hi=-1),
                      **_INT_SIGNS),
    "mod": Case(F(3, 4, lo=-4, hi=4), F(3, 4, lo=0.5, hi=2.0),
                I(3, 4, lo=-9, hi=9), I(3, 4, lo=1, hi=4), **_INT_SIGNS),
    "floor_mod": Case(F(3, 4, lo=-4, hi=4), F(3, 4, lo=-2.0, hi=-0.5),
                      I(3, 4, lo=-9, hi=9), I(3, 4, lo=1, hi=4),
                      **_INT_SIGNS),
    "gcd": Case(I(3, 4, lo=1, hi=30), I(3, 4, lo=1, hi=30), grad=False),
    "lcm": Case(I(3, 4, lo=1, hi=12), I(3, 4, lo=1, hi=12), grad=False),
    "kron": Case(F(2, 3), F(2, 2)),
    "inner": Case(F(3, 4), F(2, 4)),
    "outer": Case(F(3), F(2, 2)),
    "scale": Case(F(3, 4), 2.0, 0.5, kw={"bias_after_scale": False}),
    # float bounds; then an int32 tensor clipped by int and float bounds
    "clip": Case(F(3, 4), -0.5, 0.5, I(3, 4, lo=-9, hi=9),
                 call=lambda op, a, k: [op(a[0], a[1], a[2]),
                                        op(a[3], -2, 3),
                                        op(a[3], -2.5, 3.5)]),
    "lerp": Case(F(3, 4), F(3, 4), 0.3),
    "addmm": Case(F(3, 5), F(3, 4), F(4, 5), kw={"beta": 0.5,
                                                  "alpha": 2.0}),
    "multiplex": Case([F(3, 4), F(3, 4)], I(3, 1, lo=0, hi=2)),
    "nan_to_num": Case(np.array([[np.nan, np.inf, -np.inf, 1.5]],
                                np.float32), kw={"nan": 0.5},
                       grad=False),
    "isnan": Case(np.array([np.nan, 1.0, np.inf], np.float32), grad=False),
    "isinf": Case(np.array([np.nan, 1.0, -np.inf], np.float32), grad=False),
    "isfinite": Case(np.array([np.nan, 1.0, np.inf], np.float32),
                     grad=False),
    "isclose": Case(F(3, 4), F(3, 4), kw={"atol": 0.5}, grad=False),
    "allclose": Case(F(3, 4), F(3, 4), kw={"atol": 2.5}, grad=False),
    "equal_all": Case(I(3, 4, lo=0, hi=2), I(3, 4, lo=0, hi=2), grad=False),
    "sum": Case(F(3, 4), kw={"axis": 1, "keepdim": True}),
    "mean": Case(F(3, 4), kw={"axis": [0, 1]}),
    "prod": Case(F(3, 4, lo=0.5, hi=1.5), kw={"axis": [0, 1]}),
    "max": Case(F(3, 4), kw={"axis": 0}),
    "min": Case(F(3, 4), kw={"axis": 1, "keepdim": True}),
    "amax": Case(F(3, 4), kw={"axis": 1}),
    "amin": Case(F(3, 4)),
    "nansum": Case(F(3, 4), kw={"axis": 1}),
    "nanmean": Case(F(3, 4), kw={"axis": 0}),
    "logsumexp": Case(F(3, 4), kw={"axis": 1}),
    "all": Case(B(3, 4), kw={"axis": 1}, grad=False),
    "any": Case(B(3, 4), kw={"axis": 0}, grad=False),
    "std": Case(F(3, 4), kw={"axis": 1}),
    "var": Case(F(3, 4), kw={"axis": 0, "unbiased": False}),
    # an even count along the axis: the mean of the two middle values
    "median": Case(F(3, 4), kw={"axis": 1}),
    "quantile": Case(F(3, 5), 0.3, kw={"axis": 1}),
    "cumsum": Case(F(3, 4), kw={"axis": 1}),
    "cumprod": Case(F(3, 4), kw={"dim": 1}),
    "cummax": Case(F(3, 4), kw={"axis": 1}),
    "cummin": Case(F(3, 4), kw={"axis": 0}),
    "diff": Case(F(3, 5), kw={"axis": 1}),
    "trace": Case(F(3, 4), 1),
    "count_nonzero": Case(I(3, 4, lo=0, hi=2), kw={"axis": 1}, grad=False),
    "stack": Case([F(3, 4), F(3, 4)], 1),
    "logcumsumexp": Case(F(3, 4), kw={"axis": 1}),
    "renorm": Case(F(3, 4, lo=-2, hi=2), 2.0, 0, 1.0),
    "nanmedian": Case(F(3, 4), kw={"axis": 1}),
    "nanquantile": Case(F(3, 5), 0.5, kw={"axis": 1}),
    "complex": Case(F(3, 4), F(3, 4), grad=False),
    "add_n": Case([F(3, 4), F(3, 4), F(3, 4)]),
    "increment": Case(F(3, 4), 2.0, grad=False),
    "tensordot": Case(F(3, 4), F(4, 5), 1),
    "broadcast_shape": Case([2, 1, 4], [3, 1], grad=False),
    "rank": Case(F(3, 4), grad=False),
    "shape": Case(F(3, 4), grad=False),
    "is_tensor": Case(F(3, 4), grad=False),
    "is_complex": Case(F(3, 4), grad=False),
    "is_integer": Case(I(3, 4), grad=False),
    "is_floating_point": Case(F(3, 4), grad=False),
    "is_empty": Case(F(0, 4), grad=False),
    "tolist": Case(I(3, 4), grad=False),
})
MATH.update({name: Case(B(3, 4), B(3, 4), grad=False) for name in (
    "logical_and", "logical_or", "logical_xor")})
MATH["logical_not"] = Case(B(3, 4), grad=False)
MATH.update({name: Case(I(3, 4, lo=0, hi=64), I(3, 4, lo=0, hi=64),
                        grad=False)
             for name in ("bitwise_and", "bitwise_or", "bitwise_xor")})
MATH["bitwise_not"] = Case(I(3, 4, lo=-9, hi=9), grad=False)
MATH.update({name: Case(F(3, 4), F(3, 4), grad=False) for name in (
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal")})
MATH["equal"] = Case(I(3, 4, lo=0, hi=3), I(3, 4, lo=0, hi=3), grad=False)


# -- search -----------------------------------------------------------------
_TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0], [0.5, 0.5, 0.5, 2.0, 2.0],
                  [4.0, -1.0, 4.0, 4.0, 0.0]], np.float32)
SEARCH = {
    "argmax": Case(_TIES, kw={"axis": 1}, grad=False),
    "argmin": Case(_TIES, grad=False),
    "argsort": Case(_TIES, kw={"axis": 1, "descending": True}, grad=False),
    "sort": Case(_TIES + np.arange(15, dtype=np.float32).reshape(3, 5)
                 * 1e-3, kw={"axis": 1, "descending": True}),
    "topk": Case(_TIES, 3, grad=False),
    "kthvalue": Case(_TIES, 2, kw={"axis": 1}, grad=False),
    "mode": Case(_TIES, kw={"axis": 1}, grad=False),
    "searchsorted": Case(np.array([[1.0, 3.0, 5.0, 7.0], [2.0, 4.0, 6.0,
                                                          8.0]], np.float32),
                         np.array([[3.0, 6.5], [1.0, 8.0]], np.float32),
                         kw={"right": True}, grad=False),
    "bucketize": Case(F(3, 4, lo=0, hi=8), np.array([1.0, 3.0, 5.0, 7.0],
                                                     np.float32), grad=False),
    "histogram": Case(F(4, 5, lo=0, hi=1), 5, 0, 1, grad=False),
    "bincount": Case(I(7, lo=0, hi=5), kw={"minlength": 6}, grad=False),
}
# the gathered values of topk / kthvalue / mode are differentiable: a
# second case on distinct values holds their gradients
SEARCH_GRAD = {
    "topk": Case(F(3, 5), 2, kw={"largest": False}),
    "kthvalue": Case(F(3, 5), 3, kw={"axis": 1, "keepdim": True}),
    "bincount": Case(I(7, lo=0, hi=5), kw={"weights": F(7)}, grad=False),
}


# -- random: shapes, dtypes, ranges, moments and the seed ------------------
def _rand_check(lo=None, hi=None, mean=None, std=None, tol=0.1,
                integer=False):
    def check(jout, tout, *_):
        _shape_dtype(jout, tout)
        v = _np(_leaves(tout)[0]).astype(np.float64)
        if lo is not None:
            assert v.min() >= lo
        if hi is not None:
            assert v.max() < hi if integer else v.max() <= hi
        if mean is not None:
            assert abs(v.mean() - mean) < tol, v.mean()
        if std is not None:
            assert abs(v.std() - std) < tol, v.std()
    return check


_N = [200, 100]
RANDOM = {
    "rand": Case(_N, grad=False, check=_rand_check(0, 1, 0.5, 0.2887)),
    "randn": Case(_N, grad=False, check=_rand_check(mean=0, std=1)),
    "standard_normal": Case(_N, grad=False,
                            check=_rand_check(mean=0, std=1)),
    "normal": Case(2.0, 0.5, _N, grad=False,
                   check=_rand_check(mean=2.0, std=0.5)),
    "uniform": Case(_N, kw={"min": -2.0, "max": 3.0}, grad=False,
                    check=_rand_check(-2, 3, 0.5, 1.443)),
    "randint": Case(-3, 4, _N, grad=False,
                    check=_rand_check(-3, 4, 0.0, integer=True)),
    "randint_like": Case(I(200, 100), 0, 5, grad=False,
                         check=_rand_check(0, 5, 2.0, integer=True)),
    "randperm": Case(50, grad=False, check=lambda j, t, *_: (
        _shape_dtype(j, t), np.testing.assert_array_equal(
            np.sort(_np(t)), np.arange(50)))),
    "bernoulli": Case(np.full((200, 100), 0.3, np.float32), grad=False,
                      check=_rand_check(0, 1, 0.3, tol=0.02)),
    "poisson": Case(np.full((200, 100), 3.0, np.float32), grad=False,
                    check=_rand_check(0, None, 3.0, tol=0.1)),
    "multinomial": Case(np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]],
                                 np.float32), 2, grad=False,
                        check=lambda j, t, *_: (
                            _shape_dtype(j, t),
                            _distinct_rows(_np(t)))),
    "exponential_": Case(np.zeros((200, 100), np.float32), 2.0, grad=False,
                         check=_rand_check(0, None, 0.5, 0.5, tol=0.05)),
    "normal_": Case(np.zeros((200, 100), np.float32), 1.0, 2.0, grad=False,
                    check=_rand_check(mean=1.0, std=2.0, tol=0.1)),
    "uniform_": Case(np.zeros((200, 100), np.float32), 0.0, 2.0,
                     grad=False, check=_rand_check(0, 2, 1.0, tol=0.05)),
}


FIRST = dict(CREATION, **MATH, **SEARCH, **RANDOM,
             diagonal=Case(F(3, 4), 1))



# -- manipulation, linalg, in-place ----------------------------------------
def _idx(*values):
    return np.array(values, np.int32)


_A = F(3, 4)
MANIPULATION = {
    "reshape": Case(_A, [2, 6]),
    "flatten": Case(F(2, 3, 4), 1, 2),
    "transpose": Case(F(2, 3, 4), [2, 0, 1]),
    "t": Case(_A),
    "moveaxis": Case(F(2, 3, 4), 0, 2),
    "swapaxes": Case(F(2, 3, 4), 0, 2),
    "squeeze": Case(F(3, 1, 4, 1), [1, 2]),
    "unsqueeze": Case(_A, [0, 3]),
    "concat": Case([F(3, 4), F(3, 2)], 1),
    "unstack": Case(_A, 1),
    "unbind": Case(_A, 0),
    "split": Case(F(4, 6), [2, -1, 1], 1,
                  call=lambda op, a, k: op(a[0], a[1], a[2])
                  + op(a[0], 2, 0)),
    "chunk": Case(F(4, 6), 3, 1),
    "tile": Case(F(3, 2), [2, 1, 2]),
    "expand": Case(F(3, 1), [2, -1, 4]),
    "expand_as": Case(F(1, 4), F(3, 4)),
    "broadcast_to": Case(F(3, 1), [3, 4]),
    "broadcast_tensors": Case([F(3, 1), F(1, 4)]),
    "flip": Case(_A, [0, 1]),
    "roll": Case(_A, 2, call=lambda op, a, k: [op(a[0], a[1]),
                                              op(a[0], [1, -1], [0, 1])]),
    "rot90": Case(_A, 3),
    "cast": Case(F(3, 4, lo=-4, hi=4), call=lambda op, a, k: [
        op(a[0], "int32"), op(a[0], "float16"), op(a[0], "int64")],
        grad=False),
    "pad": Case(F(1, 2, 3, 4), [1, 2, 2, 1], call=lambda op, a, k: [
        op(a[0], a[1]), op(a[0], a[1], mode="reflect"),
        op(a[0], a[1], mode="replicate"), op(a[0], a[1], mode="circular"),
        op(a[0], [1, 0, 0, 1, 2, 0, 0, 3], value=0.5)]),
    "gather": Case(F(3, 5), _idx(4, 0, 4, 2), 1),
    "gather_nd": Case(F(3, 4, 2), _idx([0, 1], [2, 3], [0, 1])),
    "take_along_axis": Case(F(3, 4), _idx([0, 3], [1, 1], [2, 0]), 1),
    # assign on distinct columns (a repeated column's winner is
    # unspecified in both libraries), add on a repeated one
    "put_along_axis": Case(F(3, 4), _idx([0, 3], [1, 2], [2, 0]), F(3, 2),
                           _idx([0, 3], [1, 1], [2, 0]),
                           call=lambda op, a, k: [
                               op(a[0], a[1], a[2], 1),
                               op(a[0], a[3], a[2], 1, "add"),
                               op(a[0], a[3], 2.5, 1)]),
    # overwrite on distinct rows; sum (zeroed first) on repeated rows
    "scatter": Case(F(5, 3), _idx(3, 0, 1), F(3, 3), _idx(1, 3, 1),
                    call=lambda op, a, k: [
                        op(a[0], a[1], a[2]),
                        op(a[0], a[3], a[2], overwrite=False)]),
    "scatter_nd_add": Case(F(4, 3), _idx([1], [3], [1]), F(3, 3)),
    "scatter_nd": Case(_idx([1, 0], [3, 2], [1, 0]), F(3), [4, 3]),
    "index_select": Case(F(3, 5), _idx(4, 0, 4), 1),
    "index_sample": Case(F(3, 5), _idx([0, 4], [1, 1], [3, 2])),
    "index_add": Case(F(5, 3), _idx(4, 0, 4), 0, F(3, 3)),
    "index_put": Case(F(4, 3), [_idx(0, 3, 1), _idx(2, 0, 1)], F(3),
                      call=lambda op, a, k: [
                          op(a[0], a[1], a[2]),
                          op(a[0], a[1], a[2], accumulate=True)]),
    "masked_select": Case(_A, B(3, 4), grad=False),
    "masked_fill": Case(_A, B(3, 4), 0.25),
    "where": Case(B(3, 4), F(3, 4), F(3, 4),
                  call=lambda op, a, k: [op(a[0], a[1], a[2]),
                                         *op(a[0])]),
    "nonzero": Case(I(3, 4, lo=0, hi=2), grad=False,
                    call=lambda op, a, k: [op(a[0]),
                                           *op(a[0], as_tuple=True)]),
    # the bf16 calls: the values keep the input's dtype
    "unique": Case(I(12, lo=0, hi=5), grad=False, call=lambda op, a, k: [
        op(a[0]), *op(a[0], return_index=True, return_inverse=True,
                      return_counts=True),
        *op(a[0].astype("bfloat16"), return_index=True,
            return_counts=True),
        *op(a[0].reshape([3, 4]), return_inverse=True),
        *op(a[0].reshape([6, 2]), return_index=True, axis=0)]),
    "unique_consecutive": Case(_idx(1, 1, 2, 2, 2, 0, 1, 1), grad=False,
                               call=lambda op, a, k: [
        *op(a[0], return_inverse=True, return_counts=True),
        op(a[0].astype("bfloat16")),
        *op(a[0].reshape([4, 2]), return_inverse=True, axis=0)]),
    "repeat_interleave": Case(_A, 2, call=lambda op, a, k: [
        op(a[0], a[1], 1), op(a[0], 3, 0), op(a[0], 2)]),
    "strided_slice": Case(F(5, 6), call=lambda op, a, k: [
        op(a[0], [0, 1], [0, 5], [5, 0], [2, -2]),
        op(a[0], [1], [-1], [-7], [-1])]),
    "slice": Case(F(5, 6), [0, 1], [1, -4], [4, 100]),
    "crop": Case(F(5, 6), [2, 3], [4, 1]),
    "as_complex": Case(F(3, 2), grad=False),
    "as_real": Case((np.arange(6) + 1j * np.arange(6, 0, -1))
                    .astype(np.complex64), grad=False),
    "view": Case(_A, [4, 3]),
    "atleast_1d": Case(np.float32(2.5), F(3), grad=False),
    "atleast_2d": Case(F(3), grad=True),
    "atleast_3d": Case(F(3), F(2, 3), call=lambda op, a, k: op(*a)),
    "shard_index": Case(I(3, 4, lo=0, hi=20), 20, 2, 1, grad=False),
    "reverse": Case(_A, [1]),
    "tril_indices": Case(4, 5, -1, grad=False),
    "triu_indices": Case(4, 3, 1, grad=False),
}


# -- linalg -----------------------------------------------------------------
def _spd(n, seed=3):
    a = np.random.RandomState(seed).randn(n, n).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _qr_check(jout, tout, ja, ta):
    _shape_dtype(jout, tout)
    a = _np(ta[0])
    q, r = (_np(t) for t in tout)
    _close(q @ r, a)
    _close(q.T @ q, np.eye(q.shape[1]))
    assert np.allclose(np.abs(r), np.abs(_np(jout[1])), atol=1e-5)


def _svd_check(jout, tout, ja, ta):
    _shape_dtype(jout, tout)
    u, s, vh = (_np(t) for t in tout)
    _close(s, _np(jout[1]))
    _close((u * s) @ vh, _np(ta[0]))


def _eig_check(jout, tout, ja, ta):
    _shape_dtype(jout, tout)
    a = _np(ta[0]).astype(np.complex64)
    w, v = (_np(t) for t in tout)
    _close(np.sort_complex(w), np.sort_complex(_np(jout[0])))
    _close(a @ v, v * w)


def _eigh_check(jout, tout, ja, ta):
    _shape_dtype(jout, tout)
    w, v = (_np(t) for t in tout)
    _close(w, _np(jout[0]))
    _close((v * w) @ v.T, _np(ta[0]), rtol=1e-4, atol=1e-4)


def _sorted_check(jout, tout, *_):
    _shape_dtype(jout, tout)
    _close(np.sort_complex(_np(tout)), np.sort_complex(_np(jout)))


def _lu_check(jout, tout, ja, ta):
    _shape_dtype(jout, tout)
    _close(_np(tout[0]), _np(jout[0]))
    np.testing.assert_array_equal(_np(tout[1]), _np(jout[1]))


def _lu_unpack_call(op, a, k):
    lu_, piv = a[0].lu()
    return op(lu_, piv)


def _lu_unpack_check(jout, tout, ja, ta):
    _shape_dtype(jout, tout)
    p, l_, u = (_np(t) for t in tout)
    _close(p @ l_ @ u, _np(ta[0]))
    for j, t in zip(jout, tout):
        _close(_np(t), _np(j))


def _lstsq_tol():
    return (1e-4, 1e-5, "an SVD-based solve: LAPACK's gesdd orders its "
                        "sums differently in the two libraries")


_LINALG_TOL = (2e-5, 2e-6, "a factorisation underneath (LU / Cholesky / "
                           "SVD): the two libraries' LAPACK calls round "
                           "their sums in other orders")
LINALG = {
    "matmul": Case(F(3, 4), F(5, 4), kw={"transpose_y": True}),
    "mm": Case(F(3, 4), F(4, 2)),
    "bmm": Case(F(2, 3, 4), F(2, 4, 2)),
    "dot": Case(F(3, 4), F(3, 4)),
    "mv": Case(F(3, 4), F(4)),
    "norm": Case(F(3, 4), call=lambda op, a, k: [
        op(a[0]), op(a[0], p=1, axis=1), op(a[0], p=float("inf"), axis=0),
        op(a[0], p="fro", axis=[0, 1], keepdim=True), op(a[0], p=3,
                                                         axis=1)]),
    "dist": Case(F(3, 4), F(3, 4), 3),
    "cross": Case(F(3, 3), F(3, 3)),
    "einsum": Case("ij,jk->ik", F(3, 4), F(4, 2)),
    "cholesky": Case(_spd(4), tol=_LINALG_TOL),
    "cholesky_solve": Case(F(4, 2), np.linalg.cholesky(_spd(4))
                           .astype(np.float32), tol=_LINALG_TOL),
    "qr": Case(F(4, 3), check=_qr_check, grad=False),
    "svd": Case(F(4, 3), check=_svd_check, grad=False),
    "eig": Case(F(4, 4), check=_eig_check, grad=False),
    "eigh": Case(_spd(4), check=_eigh_check, grad=False),
    "eigvals": Case(F(4, 4), check=_sorted_check, grad=False),
    "eigvalsh": Case(_spd(4), tol=(1e-5, 1e-5, "eigenvalues of order 10"
                                               " from two LAPACKs"),
                     grad=False),
    "inverse": Case(_spd(4), tol=_LINALG_TOL),
    "inv": Case(_spd(3), tol=_LINALG_TOL),
    "pinv": Case(F(4, 3), tol=_lstsq_tol()),
    "solve": Case(_spd(4), F(4, 2), tol=_LINALG_TOL),
    "triangular_solve": Case(np.triu(_spd(4)), F(4, 2),
                             call=lambda op, a, k: [
                                 op(a[0], a[1]),
                                 op(a[0], a[1], transpose=True)],
                             tol=_LINALG_TOL),
    "lstsq": Case(F(5, 3), F(5, 2), tol=_lstsq_tol()),
    "matrix_power": Case(F(3, 3), 3),
    "matrix_rank": Case(np.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]],
                                 np.float32), grad=False),
    "det": Case(_spd(3), tol=_LINALG_TOL),
    "slogdet": Case(_spd(3), tol=_LINALG_TOL),
    "multi_dot": Case([F(3, 4), F(4, 5), F(5, 2)]),
    "householder_product": Case(F(4, 3), F(3)),
    "corrcoef": Case(F(3, 6)),
    "cov": Case(F(3, 6), kw={"rowvar": False}),
    "cond": Case(_spd(3), call=lambda op, a, k: [
        op(a[0]), op(a[0], "fro"), op(a[0], 1), op(a[0], -2)],
        tol=(1e-4, 1e-5, "a condition number of order 10 through an "
                         "inverse or an SVD")),
    "lu": Case(F(4, 4), check=_lu_check, grad=False),
    "lu_unpack": Case(F(4, 4), call=_lu_unpack_call, check=_lu_unpack_check,
                      grad=False),
}


# -- in-place ---------------------------------------------------------------
def _inplace_call(op, a, k):
    """Run the in-place op on a recorded tensor ``y = x * 1`` and return
    ``y`` (rebound to the result)."""
    y = a[0] * 1.0 if "float" in str(a[0].dtype) else a[0]
    assert op(y, *a[1:], **k) is y
    return y


_INPLACE_ARGS = {
    "add_": (F(3, 4), F(3, 4)), "subtract_": (F(3, 4), F(3, 4)),
    "multiply_": (F(3, 4), F(3, 4)),
    "divide_": (F(3, 4), F(3, 4, lo=0.5, hi=2)),
    "remainder_": (F(3, 4, lo=-4, hi=4), F(3, 4, lo=0.5, hi=2)),
    "clip_": (F(3, 4), -0.5, 0.5), "scale_": (F(3, 4), 2.0, 1.0),
    "lerp_": (F(3, 4), F(3, 4), 0.25),
    "pow_": (F(3, 4, lo=0.5, hi=2), 2.5),
    "exp_": (F(3, 4),), "sqrt_": (F(3, 4, lo=0.5, hi=2),),
    "rsqrt_": (F(3, 4, lo=0.5, hi=2),), "ceil_": (F(3, 4),),
    "floor_": (F(3, 4),), "round_": (F(3, 4),),
    "reciprocal_": (F(3, 4, lo=0.5, hi=2),),
    "erfinv_": (F(3, 4, lo=-0.9, hi=0.9),), "tanh_": (F(3, 4),),
    "abs_": (F(3, 4),), "neg_": (F(3, 4),), "sign_": (F(3, 4),),
    "trunc_": (F(3, 4),), "frac_": (F(3, 4, lo=-3, hi=3),),
    "reshape_": (F(3, 4), [4, 3]), "squeeze_": (F(3, 1, 4), 1),
    "unsqueeze_": (F(3, 4), 1), "flatten_": (F(2, 3, 2),),
    "scatter_": (F(5, 3), _idx(3, 0, 1), F(3, 3)),
    "put_along_axis_": (F(3, 4), _idx([0, 3], [1, 2], [2, 0]), F(3, 2), 1),
    "gather_": (F(3, 5), _idx(4, 0, 4, 2), 1),
    "cast_": (F(3, 4), "float16"),
}
INPLACE = {name: Case(*args, call=_inplace_call)
           for name, args in _INPLACE_ARGS.items()}
INPLACE["cast_"].grad = False

SECOND = dict(MANIPULATION, **LINALG, **INPLACE)

# forward-only second cases: the JAX package has no gradient for a
# multiplying scatter on repeated indices
FORWARD_ONLY = {
    "put_along_axis": Case(F(3, 4), _idx([0, 3], [1, 1], [2, 0]), F(3, 2),
                           1, "mul", grad=False),
}

FIRST = dict(CREATION, **MATH, **SEARCH, **RANDOM,
             diagonal=Case(F(3, 4), 1))
# every op's case
ALL = dict(FIRST, **SECOND)
# extra cases run after an op's main one
EXTRA = dict(SEARCH_GRAD, **FORWARD_ONLY)
