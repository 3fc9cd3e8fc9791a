"""paddle.autograd: custom autograd functions and the backward entry
point (the JAX package's ``autograd/__init__.py``).

``PyLayer`` runs over a ``torch.autograd.Function`` made once per
subclass: its forward calls the user's ``forward(ctx, *args)`` with
``Tensor``s for the tensor arguments and returns their payloads, its
backward wraps the incoming gradients as ``Tensor``s for the user's
``backward(ctx, *grads)``.  ``PyLayerContext`` keeps what the user saves
(``save_for_backward`` / ``saved_tensor()``) and passes
``mark_non_differentiable`` and ``set_materialize_grads`` on to torch's
context.
"""

from __future__ import annotations

import torch

from ..core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                             no_grad, run_backward, set_grad_enabled)
from ..core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "backward", "grad", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: accumulate the gradients of
    ``tensors`` (seeded with ``grad_tensors``, default ones)."""
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    run_backward(tensors, grad_tensors, retain_graph=retain_graph)


class PyLayerContext:
    """Carries state from forward to backward: ``save_for_backward`` /
    ``saved_tensor`` and free attributes."""

    def __init__(self):
        self._saved = ()
        self._non_differentiable = ()
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return list(self._saved)

    def mark_non_differentiable(self, *tensors):
        self._non_differentiable = tensors

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = bool(value)


def _payload(x):
    return x._value if isinstance(x, Tensor) else x


def _function_for(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, *flat):
            all_in, tpos, nargs, keys = spec
            call = list(all_in)
            for i, v in zip(tpos, flat):
                call[i] = Tensor._wrap(v) if isinstance(all_in[i], Tensor) \
                    else v
            pctx = PyLayerContext()
            outs = cls.forward(pctx, *call[:nargs],
                               **dict(zip(keys, call[nargs:])))
            single = not isinstance(outs, (tuple, list))
            vals = tuple(_payload(o) for o in ([outs] if single else outs))
            nd = {id(_payload(t)) for t in pctx._non_differentiable}
            if nd:
                ctx.mark_non_differentiable(
                    *[v for v in vals if id(v) in nd])
            ctx.set_materialize_grads(pctx._materialize_grads)
            ctx.pctx, ctx.n_tensors = pctx, len(tpos)
            return vals[0] if single else vals

        @staticmethod
        def backward(ctx, *grads):
            gouts = [None if g is None else Tensor._wrap(g) for g in grads]
            res = cls.backward(ctx.pctx, *gouts)
            if res is None or isinstance(res, (Tensor, torch.Tensor)):
                res = (res,)
            res = [_payload(g) for g in res]
            n = ctx.n_tensors
            diff = [j for j in range(n) if ctx.needs_input_grad[1 + j]]
            if len(res) == n:
                per_input = res
            elif len(res) == len(diff):
                per_input = [None] * n
                for j, g in zip(diff, res):
                    per_input[j] = g
            else:
                raise ValueError(
                    f"{cls.__name__}.backward returned {len(res)} grads for "
                    f"{len(diff)} differentiable inputs")
            return (None, *per_input)

    _Fn.__name__ = _Fn.__qualname__ = f"{cls.__name__}Function"
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    """Custom autograd function.

    Subclass with static ``forward(ctx, *args)`` and ``backward(ctx,
    *output_grads)``; call ``MyLayer.apply(*args)``.  ``backward``
    returns one grad per tensor input of forward (None for inputs that
    need none), or one per differentiable input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError("implement PyLayer.forward")

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError("implement PyLayer.backward")

    @classmethod
    def apply(cls, *args, **kwargs):
        keys = sorted(kwargs)
        all_in = list(args) + [kwargs[k] for k in keys]
        tpos = [i for i, a in enumerate(all_in)
                if isinstance(a, (Tensor, torch.Tensor))]
        outs = _function_for(cls).apply(
            (all_in, tpos, len(args), keys),
            *[_payload(all_in[i]) for i in tpos])
        if isinstance(outs, tuple):
            return tuple(Tensor._wrap(o) for o in outs)
        return Tensor._wrap(outs)

