"""In-place op variants (``add_``, ``reshape_``, ``tanh_``...), the JAX
package's ``ops/inplace.py``.

Each runs the recorded out-of-place op and rebinds the tensor to the
result (``Tensor._rebind``), the rebind ``Tensor.__setitem__`` uses:
gradients flow as for the out-of-place op, and a graph recorded earlier
keeps the values it saw.  Given a torch tensor (a ``Parameter``), the
result is copied into it without recording.
"""

from __future__ import annotations

import torch

from ..core.tensor import Tensor

_INPLACE_SPECS = [
    # (inplace name, out-of-place op name in the ops namespace)
    ("add_", "add"), ("subtract_", "subtract"), ("multiply_", "multiply"),
    ("divide_", "divide"), ("remainder_", "remainder"),
    ("clip_", "clip"), ("scale_", "scale"), ("lerp_", "lerp"),
    ("pow_", "pow"),
    ("exp_", "exp"), ("sqrt_", "sqrt"), ("rsqrt_", "rsqrt"),
    ("ceil_", "ceil"), ("floor_", "floor"), ("round_", "round"),
    ("reciprocal_", "reciprocal"), ("erfinv_", "erfinv"),
    ("tanh_", "tanh"), ("sigmoid_", "sigmoid"), ("abs_", "abs"),
    ("neg_", "neg"), ("sign_", "sign"), ("trunc_", "trunc"),
    ("frac_", "frac"),
    ("reshape_", "reshape"), ("squeeze_", "squeeze"),
    ("unsqueeze_", "unsqueeze"), ("flatten_", "flatten"),
    ("scatter_", "scatter"), ("put_along_axis_", "put_along_axis"),
    ("gather_", "gather"), ("cast_", "cast"),
]


def _rebind(x, out: Tensor):
    if isinstance(x, Tensor):
        x._rebind(out._value)
        x._sg = out._sg
        return x
    with torch.no_grad():
        x.copy_(out._value)
    return x


def _make_inplace(base):
    def op(x, *args, **kwargs):
        return _rebind(x, base(x, *args, **kwargs))
    op.__name__ = base.__name__ + "_"
    op.__qualname__ = op.__name__
    op.__doc__ = (f"In-place variant of ``{base.__name__}`` (a rebind to "
                  "the recorded result).")
    return op


def install(namespace: dict) -> dict:
    """Build every in-place op from ``namespace`` (the ops' names) and
    patch them onto ``Tensor``; returns {name: fn}."""
    built = {}
    for iname, oname in _INPLACE_SPECS:
        base = namespace.get(oname)
        if base is None:
            continue
        fn = _make_inplace(base)
        fn.__name__ = iname
        fn.__qualname__ = iname
        built[iname] = fn
        setattr(Tensor, iname, fn)
    return built
