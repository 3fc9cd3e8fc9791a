"""Concrete optimizers (the JAX package's ``optimizer/optimizers.py``):
Adam.  AdamW, Lamb and Lars are not ported yet (ROADMAP Queue 1 item 6).

``torch.optim.Adam`` is not used: it keeps the moments in the parameter's
dtype (bf16 for bf16 parameters) and rounds its bias correction
differently from :func:`adam_update`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype
from .optimizer import Optimizer


def adam_update(value, grad, m, v, lr, t, beta1, beta2, eps,
                moment_dtype=torch.float32):
    """One Adam tensor update, op for op as the JAX package's: moments in
    f32, stored in ``moment_dtype``; ``mhat / (sqrt(vhat) + eps)``.
    Returns ``(new_value_f32, new_m_stored, new_v_stored)``; the caller
    casts the new value to the parameter's dtype."""
    g32 = grad.float()
    m32 = beta1 * m.float() + (1 - beta1) * g32
    v32 = beta2 * v.float() + (1 - beta2) * g32.square()
    # the bias corrections in f32, as JAX computes them, on the host: a
    # step count sent to the device would synchronise every tensor's update
    t = np.float32(t)
    mhat = m32 / float(np.float32(1) - np.float32(beta1) ** t)
    vhat = v32 / float(np.float32(1) - np.float32(beta2) ** t)
    new_value = value.float() - lr * mhat / (vhat.sqrt() + eps)
    return new_value, m32.to(moment_dtype), v32.to(moment_dtype)


class Adam(Optimizer):
    """Adam; ``moment_dtype='bfloat16'`` stores m/v in bf16 (the update
    still computes in f32)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._moment_dtype = (torch.float32 if moment_dtype is None
                              else convert_dtype(moment_dtype))

    def _init_accumulators(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device)}

    def _apply_one(self, v, g, s, lr, step_t):
        new_v, m, u = adam_update(v, g, s["moment1"], s["moment2"], lr,
                                  step_t, self._beta1, self._beta2,
                                  self._eps, self._moment_dtype)
        return new_v, {"moment1": m, "moment2": u}
