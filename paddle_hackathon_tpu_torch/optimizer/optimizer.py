"""Optimizer base (the JAX package's ``optimizer/optimizer.py``).

The update is a pure function over lists of tensors,
:meth:`Optimizer.functional_update`: the gradient preamble (f32 cast of
f32 parameters' gradients, coupled weight decay, then the clip), then the
rule, at the learning rate times each parameter's own scale
(``optimize_attr["learning_rate"]``, set by ``ParamAttr``).  The eager ``step()`` runs it over every trainable parameter with a
gradient and writes the new values back in place under
``torch.no_grad()`` (the JAX package runs the same update as one jitted
program with donated buffers).  The learning rate is a float or an
:class:`~.lr.LRScheduler`, read on the host each step.

Parameters are tensors, or ``(name, tensor)`` pairs as
``model.named_parameters()`` yields them.  JAX-package parameters carry a
name of their own (``param_N``); the port's ``nn.Parameter``s carry none,
so the names given beside them are what AdamW's
``apply_decay_param_fun`` and Lars's ``exclude_from_weight_decay`` see
and what keys ``state_dict``.  A parameter given without a name is keyed
by its position.

Host scalars that the JAX package multiplies as f32 arrays (the learning
rate by a per-parameter scale, by a decay coefficient) are multiplied in
f32 here too (:func:`f32_product`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..nn.clip import ClipGradBase
from .lr import LRScheduler

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"


class L2Decay:
    """``regularizer.L2Decay``: adds ``coeff * param`` to the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    """``regularizer.L1Decay``: adds ``coeff * sign(param)`` to the
    gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def f32_product(*xs) -> float:
    """The product of host scalars, rounded to f32 after each multiply."""
    out = np.float32(xs[0])
    for x in xs[1:]:
        out = out * np.float32(x)
    return float(out)


def param_lrs_of(params):
    """Each parameter's learning-rate scale: ``optimize_attr
    ["learning_rate"]`` where it carries one (a ``Parameter``), else
    1.0."""
    return tuple(float(getattr(p, "optimize_attr", {}).get(
        "learning_rate", 1.0)) for p in params)


def _split_names(parameters):
    plist, names = [], {}
    for item in parameters:
        if isinstance(item, tuple):
            name, item = item
            names[id(item)] = name
        plist.append(item)
    return plist, names


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError("parameters must be given (pass "
                             "model.parameters() or model.named_parameters())")
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError("grad_clip must be a ClipGradByValue, "
                            "ClipGradByNorm or ClipGradByGlobalNorm")
        self._parameter_list, self._names = _split_names(parameters)
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        # stored as the JAX package stores it: its eager update ignores it
        # (the f32 update of bf16 parameters is the rule's own)
        self._multi_precision = multi_precision
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- public API --------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def _live_params(self) -> List[torch.Tensor]:
        return [p for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        """Apply one update to every trainable parameter with a gradient,
        in place."""
        params = self._live_params()
        if not params:
            return
        states = [self._get_accumulators(p) for p in params]
        new_vals, new_states = self._update_all(
            params, [p.grad for p in params], states, self.get_lr(),
            self._step_count + 1, param_lrs_of(params), params)
        torch._foreach_copy_(params, new_vals)
        for p, s in zip(params, new_states):
            self._accumulators[id(p)] = s
        self._step_count += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward, step and clear (the dygraph branch)."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -- functional surface ------------------------------------------------
    def functional_state(self, params) -> List[Dict[str, torch.Tensor]]:
        """The accumulator dicts of ``params`` (made on first use), in
        order."""
        return [self._get_accumulators(p) for p in params]

    def load_functional_state(self, params, states, step_count=None):
        """Write functionally updated accumulators back, so that
        ``state_dict`` sees them."""
        for p, s in zip(params, states):
            self._accumulators[id(p)] = s
        if step_count is not None:
            self._step_count = int(step_count)

    def functional_update(self, vals, grads, states, lr, step_t,
                          param_lrs=None, params=None, shard_info=None):
        """One update over explicit lists: parameter values, gradients and
        accumulator dicts, in order.  Returns ``(new_vals, new_states)``;
        nothing is written in place.  ``params`` (the matching parameters)
        lets a per-parameter rule (AdamW's decay mask, Lamb's and Lars's
        exclusions) find each one, and gives each one's learning-rate
        scale (``optimize_attr["learning_rate"]``, which
        ``ParamAttr(learning_rate=)`` sets; 1.0 for a parameter without
        one) unless ``param_lrs`` gives the scales."""
        if shard_info is not None:
            raise NotImplementedError(
                f"functional_update with a ZeRO shard_info {_DISTRIBUTED}")
        if param_lrs is None:
            param_lrs = param_lrs_of(params) if params is not None \
                else (1.0,) * len(vals)
        return self._update_all(list(vals), list(grads), list(states),
                                float(lr), int(step_t), tuple(param_lrs),
                                params)

    def _preprocess_grads(self, vals, grads):
        """The gradient preamble of every update: f32 cast of f32
        parameters' gradients, coupled weight decay, clip."""
        grads = [g.float() if v.dtype == torch.float32 else g
                 for g, v in zip(grads, vals)]
        wd = self._weight_decay
        if isinstance(wd, L2Decay) and wd.coeff:
            grads = [g + wd.coeff * v.to(g.dtype) for g, v in zip(grads, vals)]
        elif isinstance(wd, L1Decay) and wd.coeff:
            grads = [g + wd.coeff * torch.sign(v).to(g.dtype)
                     for g, v in zip(grads, vals)]
        elif isinstance(wd, float) and wd and \
                not self._decoupled_weight_decay():
            grads = [g + wd * v.to(g.dtype) for g, v in zip(grads, vals)]
        if self._grad_clip is not None:
            grads = self._grad_clip._clip(grads)
        return grads

    def _update_all(self, vals, grads, states, lr, step_t, param_lrs,
                    params):
        """The rule per tensor (the reference the multi-tensor rules are
        held to)."""
        grads = self._preprocess_grads(vals, grads)
        flags = self._decay_flags(params, len(vals))
        new_vals, new_states = [], []
        for v, g, s, plr, on in zip(vals, grads, states, param_lrs, flags):
            nv, ns = self._apply_one(v, g, s, f32_product(lr, plr), step_t,
                                     on)
            new_vals.append(nv.to(v.dtype))
            new_states.append(ns)
        return new_vals, new_states

    def _decoupled_weight_decay(self) -> bool:
        return False

    def _decay_flags(self, params, n):
        """Whether each of the ``n`` parameters takes weight decay; a rule
        with per-parameter exclusions overrides this."""
        return (True,) * n

    def _params_of(self, params, n):
        """The parameters the ``n`` positional values belong to: ``params``,
        or in an eager step the trainable ones with a gradient."""
        if params is None:
            params = self._live_params()
        if len(params) != n:
            raise ValueError(
                f"{type(self).__name__} resolves a per-parameter rule and "
                f"needs the {n} parameters of the update: pass params=")
        return params

    def _param_name(self, p):
        return self._names.get(id(p))

    # -- per-optimizer rule ------------------------------------------------
    def _init_accumulators(self, param) -> Dict[str, torch.Tensor]:
        return {}

    def _get_accumulators(self, param):
        s = self._accumulators.get(id(param))
        if s is None:
            s = self._init_accumulators(param)
            self._accumulators[id(param)] = s
        return s

    def _apply_one(self, value, grad, state, lr, step_t, decay=True):
        """``(new_value_f32_or_value_dtype, new_state)`` for one tensor;
        ``decay`` is False for a parameter excluded from weight decay."""
        raise NotImplementedError

    # -- state dict --------------------------------------------------------
    def state_dict(self):
        """``{"<name or index>_<slot>": tensor, ..., "@step": int}``, and the
        scheduler's state under ``"LR_Scheduler"``."""
        state = {}
        for i, p in enumerate(self._parameter_list):
            key = self._param_name(p) or i
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                state[f"{key}_{k}"] = v
        state["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state):
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            acc = self._init_accumulators(p)
            prefix = self._param_name(p) or i
            found = False
            for k in list(acc):
                key = f"{prefix}_{k}"
                if key in state:
                    v = state[key]
                    # a Tensor from paddle.load: its payload (a bf16
                    # moment would otherwise go through its uint16 bits)
                    v = getattr(v, "_value", v)
                    acc[k] = torch.as_tensor(v).to(
                        device=acc[k].device, dtype=acc[k].dtype)
                    found = True
            if found:
                self._accumulators[id(p)] = acc
