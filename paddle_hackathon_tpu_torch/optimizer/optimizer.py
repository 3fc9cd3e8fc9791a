"""Optimizer base (the JAX package's ``optimizer/optimizer.py``): the part
that Adam needs.

An eager ``step()`` updates every parameter that has a gradient, in place
under ``torch.no_grad()`` (the JAX package runs one jitted program over the
parameter tree with donated buffers).  The learning rate is a float.
Weight decay, gradient clipping, ``multi_precision`` and LR schedulers are
not ported yet: ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import Dict, List

import torch

_NOT_PORTED = "is not ported yet: ROADMAP Queue 1 item 6"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError("parameters must be given (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(f"an LR scheduler {_NOT_PORTED}")
        if weight_decay:
            raise NotImplementedError(f"weight_decay {_NOT_PORTED}")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip {_NOT_PORTED}")
        if multi_precision:
            raise NotImplementedError(f"multi_precision {_NOT_PORTED}")
        self._parameter_list: List[torch.Tensor] = list(parameters)
        self._learning_rate = float(learning_rate)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float):
        self._learning_rate = float(value)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    @torch.no_grad()
    def step(self):
        """Apply one update to every trainable parameter with a gradient,
        in place."""
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        lr = self.get_lr()
        step_t = self._step_count + 1
        for p in params:
            g = p.grad.float() if p.dtype == torch.float32 else p.grad
            new_v, state = self._apply_one(p, g, self._get_accumulators(p),
                                           lr, step_t)
            p.copy_(new_v.to(p.dtype))
            self._accumulators[id(p)] = state
        self._step_count += 1

    # -- per-optimizer rule ------------------------------------------------
    def _init_accumulators(self, param) -> Dict[str, torch.Tensor]:
        return {}

    def _get_accumulators(self, param):
        s = self._accumulators.get(id(param))
        if s is None:
            s = self._init_accumulators(param)
            self._accumulators[id(param)] = s
        return s

    def _apply_one(self, value, grad, state, lr, step_t):
        raise NotImplementedError

    # -- state dict --------------------------------------------------------
    def state_dict(self):
        """``{"<index>_<slot>": tensor, ..., "@step": int}``; parameters are
        keyed by their position in ``parameters``."""
        state = {}
        for i, p in enumerate(self._parameter_list):
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                state[f"{i}_{k}"] = v
        state["@step"] = self._step_count
        return state

    def set_state_dict(self, state):
        self._step_count = int(state.get("@step", 0))
        for i, p in enumerate(self._parameter_list):
            acc = self._init_accumulators(p)
            found = False
            for k in list(acc):
                key = f"{i}_{k}"
                if key in state:
                    acc[k] = torch.as_tensor(state[key]).to(
                        device=acc[k].device, dtype=acc[k].dtype)
                    found = True
            if found:
                self._accumulators[id(p)] = acc
