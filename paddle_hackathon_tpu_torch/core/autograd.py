"""Grad mode, ``paddle.grad`` and the op entry point, over torch autograd
(the JAX package's ``core/autograd.py``).

The JAX package records its own tape: a ``GradNode`` per op holding the
op's ``jax.vjp``, walked by a ready queue (``_engine_walk``), with
``_LeafSlot`` accumulation targets and a jit dispatch cache
(``_dispatch_key``, ``_build_dispatch``, ``_freeze``, ``_Unfreezable``).
None of that has a counterpart here: torch's autograd records on the
payloads of the port's ``Tensor`` (``core/tensor.py``) and its engine
runs the backward, and torch's eager dispatch takes the place of the
dispatch cache.  What stays is the surface: the grad-mode switches
(torch's own), :func:`grad` with Paddle's signature, :func:`run_backward`,
:func:`apply_op` (run a torch composition on unwrapped payloads, wrap
the outputs, check them for NaN/Inf under ``FLAGS_check_nan_inf``) and
the :func:`primitive` decorator.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch

from . import flags

# Injected by tensor.py at import time to avoid a circular import.
Tensor = None  # type: ignore


def _set_tensor_class(cls) -> None:
    global Tensor
    Tensor = cls


# ---------------------------------------------------------------------------
# Grad mode: torch's switches, so that a Paddle ``no_grad`` block also
# stops torch code (layers, functionals) from recording, and back.
# ---------------------------------------------------------------------------

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


# ---------------------------------------------------------------------------
# Backward and grad
# ---------------------------------------------------------------------------

def _payload(t) -> torch.Tensor:
    return t._value if isinstance(t, Tensor) else t


def _grad_targets(t):
    """The payloads gradients of ``t`` land on: its payload, and the
    grad-carrying leaf payloads an in-place rebind left behind that a
    recorded graph still holds (the JAX package's ``_leaf_alias``)."""
    if not isinstance(t, Tensor):
        return [t]
    return [t._value] + t._live_aliases()


def run_backward(tensors: Sequence, grad_tensors: Sequence,
                 retain_graph: bool = False) -> None:
    """Accumulate the gradients of ``tensors`` (seeded with
    ``grad_tensors``) into the ``.grad`` of the leaves they reach.  A
    tensor that records nothing (``stop_gradient``) contributes
    nothing."""
    outs, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        v = _payload(t)
        if not v.requires_grad:
            continue
        g = v.new_ones(v.shape) if g is None else _payload(g)
        outs.append(v)
        seeds.append(g.to(dtype=v.dtype, device=v.device))
    if outs:
        torch.autograd.backward(outs, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, leaving every ``.grad`` untouched.

    ``create_graph=True`` records the gradient computation, so the
    results can be differentiated again (any order).  ``retain_graph``
    defaults to ``create_graph``.  An input the outputs do not reach
    raises ``ValueError`` unless ``allow_unused``, which gives ``None``
    for it.  ``no_grad_vars``: tensors through which no gradient flows
    (their incoming gradient is replaced by zeros)."""
    single_out = not isinstance(outputs, (list, tuple))
    outputs = [outputs] if single_out else list(outputs)
    inputs = [inputs] if not isinstance(inputs, (list, tuple)) \
        else list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    outs, seeds = [], []
    for o, g in zip(outputs, grad_outputs):
        v = _payload(o)
        if not v.requires_grad:
            continue
        outs.append(v)
        seeds.append(v.new_ones(v.shape) if g is None
                     else _payload(g).to(dtype=v.dtype, device=v.device))
    targets = [_grad_targets(t) for t in inputs]
    flat = [v for ts in targets for v in ts]
    handles = []
    for t in (no_grad_vars or ()):
        v = _payload(t)
        if v.requires_grad:
            handles.append(v.register_hook(torch.zeros_like))
    try:
        if outs and any(v.requires_grad for v in flat):
            got = torch.autograd.grad(outs, flat, seeds,
                                      retain_graph=retain_graph,
                                      create_graph=create_graph,
                                      allow_unused=True)
        else:
            got = [None] * len(flat)
    finally:
        for h in handles:
            h.remove()
    results, i = [], 0
    for ts in targets:
        parts = [g for g in got[i:i + len(ts)] if g is not None]
        i += len(ts)
        if not parts:
            if not allow_unused:
                raise ValueError(
                    "one of the input tensors receives no gradient; pass "
                    "allow_unused=True to return None for it")
            results.append(None)
            continue
        g = parts[0]
        for p in parts[1:]:
            g = g + p
        results.append(Tensor._wrap(g))
    return results


# ---------------------------------------------------------------------------
# Op application: the one entry every dygraph op goes through.
# ---------------------------------------------------------------------------

def _check_nan_inf(name, vals):
    for v in vals:
        if isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex()):
            if not bool(torch.isfinite(v).all()):
                raise FloatingPointError(
                    f"NaN or Inf detected in output of op {name!r} "
                    "(FLAGS_check_nan_inf)")


def apply_op(name: str, fn: Callable, args: Sequence[Any],
             n_outputs: int = 1):
    """Run ``fn(*payloads)`` and wrap its output (a tensor or a tuple of
    them) in ``Tensor``s.

    ``args`` may mix ``Tensor``s, plain ``torch.Tensor``s (a ``Parameter``
    is one), python scalars and None; ``Tensor``s are unwrapped to their
    payloads.  Torch autograd records the composition wherever a payload
    requires grad and grad mode is on, which is what makes the outputs
    differentiable; ``n_outputs`` is kept for the JAX package's
    signature."""
    vals = [a._value if isinstance(a, Tensor) else a for a in args]
    out = fn(*vals)
    if flags.flag("check_nan_inf"):
        _check_nan_inf(name, out if isinstance(out, tuple) else (out,))
    if isinstance(out, (tuple, list)):
        return tuple(Tensor._wrap(o) for o in out)
    return Tensor._wrap(out)


def primitive(name: str):
    """Decorator turning a function of torch tensors into a dygraph op:
    the wrapper takes ``Tensor``s and scalars, keyword arguments are
    static and folded into the call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            call = functools.partial(fn, **kwargs) if kwargs else fn
            return apply_op(name, call, args)

        wrapper.__framework_op__ = name
        return wrapper

    return deco
