"""Concrete optimizers (the JAX package's ``optimizer/optimizers.py``):
SGD, Momentum, Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax, Lamb and
Lars (alias LarsMomentum), with the shared tensor rules ``adam_update``,
``lamb_update`` and ``lars_update``.

Adam and AdamW update the whole parameter list in one pass of
``torch._foreach_*`` ops (:func:`adam_update_multi`), the port's
counterpart of the JAX package's single jitted update: about 14 foreach
ops and a few casts, where a loop of :func:`adam_update` launches ~17
kernels a tensor.  It runs the per-tensor rule's ops one for one, in the
same order and with the same scalars (no ``addcmul``, ``lerp`` or
``alpha=`` form, whose rounding differs), so the two give the same bits;
the per-tensor rule stays as the reference the tests hold it to.  The
other rules run per tensor: Lamb and Lars take per-tensor norms.

``torch.optim.Adam`` is not used: it keeps the moments in the parameter's
dtype (bf16 for bf16 parameters) and rounds its bias correction
differently from :func:`adam_update`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype
from .optimizer import Optimizer, f32_product

# the LARS / LAMB hyperparameter defaults, shared by the eager classes and
# the train step (``parallel/api.py``), so that one nominal configuration
# means the same numbers on both paths
LARS_DEFAULTS = {"momentum": 0.9, "lars_coeff": 0.001,
                 "lars_weight_decay": 0.0005, "epsilon": 0.0}
LAMB_DEFAULTS = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                 "lamb_weight_decay": 0.01}


def cast_all(tensors, dtype):
    """``tensors`` in ``dtype`` (one dtype, or one a tensor).  A tensor
    already in its dtype is returned as it is; the others are cast in
    groups of one source and one target dtype, each group through one
    flat buffer (a ``cat`` and one cast, not a launch a tensor), and come
    back as views of it."""
    dts = list(dtype) if isinstance(dtype, (list, tuple)) \
        else [dtype] * len(tensors)
    out = list(tensors)
    groups = {}
    for i, (t, dt) in enumerate(zip(tensors, dts)):
        if t.dtype != dt:
            groups.setdefault((t.dtype, dt), []).append(i)
    for (_, dt), idx in groups.items():
        if len(idx) == 1:
            out[idx[0]] = tensors[idx[0]].to(dt)
            continue
        parts = [tensors[i] for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts]).to(dt)
        for i, piece in zip(idx, flat.split([p.numel() for p in parts])):
            out[i] = piece.view(tensors[i].shape)
    return out


def bias_corrections(beta1, beta2, t):
    """``1 / (1 - beta1**t)`` and ``1 / (1 - beta2**t)``, each step of it
    in f32, on the host: a step count sent to the device would
    synchronise the update.  The moments are multiplied by them, not
    divided: PyTorch's CUDA division by a host scalar multiplies by its f32
    reciprocal, and a foreach division does not, so both rules multiply."""
    one, t = np.float32(1), np.float32(t)
    return (float(one / (one - np.float32(beta1) ** t)),
            float(one / (one - np.float32(beta2) ** t)))


def adam_update(value, grad, m, v, lr, t, beta1, beta2, eps,
                moment_dtype=torch.float32):
    """One Adam tensor update, op for op as the JAX package's: moments in
    f32, stored in ``moment_dtype``; ``mhat / (sqrt(vhat) + eps)``.
    Returns ``(new_value_f32, new_m_stored, new_v_stored)``; the caller
    casts the new value to the parameter's dtype."""
    g32 = grad.float()
    m32 = beta1 * m.float() + (1 - beta1) * g32
    v32 = beta2 * v.float() + (1 - beta2) * (g32 * g32)
    r1, r2 = bias_corrections(beta1, beta2, t)
    mhat = m32 * r1
    vhat = v32 * r2
    new_value = value.float() - lr * mhat / (vhat.sqrt() + eps)
    return new_value, m32.to(moment_dtype), v32.to(moment_dtype)


def adam_update_multi(values, grads, ms, vs, lrs, t, beta1, beta2, eps,
                      moment_dtype=torch.float32):
    """:func:`adam_update` over lists, one learning rate a tensor in
    ``lrs``: the same ops on whole lists.  Returns ``(new_values_f32,
    new_ms, new_vs)``."""
    f32 = torch.float32
    g32 = cast_all(grads, f32)
    m32 = torch._foreach_add(torch._foreach_mul(cast_all(ms, f32), beta1),
                             torch._foreach_mul(g32, 1 - beta1))
    v32 = torch._foreach_add(
        torch._foreach_mul(cast_all(vs, f32), beta2),
        torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - beta2))
    r1, r2 = bias_corrections(beta1, beta2, t)
    mhat = torch._foreach_mul(m32, r1)
    vhat = torch._foreach_mul(v32, r2)
    denom = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
    delta = torch._foreach_div(torch._foreach_mul(mhat, list(lrs)), denom)
    new_values = torch._foreach_sub(cast_all(values, f32), delta)
    return (new_values, cast_all(m32, moment_dtype),
            cast_all(v32, moment_dtype))


def lamb_update(value, grad, m, v, lr, t, beta1, beta2, eps, wd,
                moment_dtype=torch.float32):
    """One LAMB tensor update: the Adam direction plus ``wd * w``, scaled
    by the trust ratio ``||w|| / ||r||`` (1 where either norm is 0).
    Returns ``(new_value_f32, new_m_stored, new_v_stored)``."""
    g32 = grad.float()
    w32 = value.float()
    m32 = beta1 * m.float() + (1 - beta1) * g32
    u32 = beta2 * v.float() + (1 - beta2) * (g32 * g32)
    r1, r2 = bias_corrections(beta1, beta2, t)
    r = (m32 * r1) / ((u32 * r2).sqrt() + eps) + wd * w32
    w_norm = (w32 * w32).sum().sqrt()
    r_norm = (r * r).sum().sqrt()
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
    return (w32 - lr * trust * r,
            m32.to(moment_dtype), u32.to(moment_dtype))


def lars_update(value, grad, velocity, lr, momentum, lars_coeff, lars_wd,
                epsilon=LARS_DEFAULTS["epsilon"]):
    """One LARS-momentum tensor update, all in f32::

        local_lr = lr * coeff * ||w|| / (||g|| + wd * ||w|| + eps)
        velocity = mu * velocity + local_lr * (g + wd * w)
        w       -= velocity

    (``local_lr = lr`` where either norm is 0).  Returns
    ``(new_value_f32, new_velocity)``."""
    g32 = grad.float()
    v32 = value.float()
    w_norm = (v32 * v32).sum().sqrt()
    g_norm = (g32 * g32).sum().sqrt()
    local_lr = torch.where(
        (w_norm > 0) & (g_norm > 0),
        f32_product(lr, lars_coeff) * w_norm
        / (g_norm + lars_wd * w_norm + epsilon), lr)
    vel = momentum * velocity.float() + local_lr * (g32 + lars_wd * v32)
    return v32 - vel, vel


class SGD(Optimizer):
    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        return v - lr * g, s


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_accumulators(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        vel = self._momentum * s["velocity"] + g
        if self._nesterov:
            return v - lr * (g + self._momentum * vel), {"velocity": vel}
        return v - lr * vel, {"velocity": vel}


class Adam(Optimizer):
    """Adam; ``moment_dtype='bfloat16'`` stores m/v in bf16 (the update
    still computes in f32).  ``step()`` and ``functional_update`` take the
    multi-tensor path; ``Optimizer._update_all(opt, ...)`` is the same
    update per tensor."""

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

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        new_v, m, u = adam_update(v, g, s["moment1"], s["moment2"], lr,
                                  step_t, self._beta1, self._beta2,
                                  self._eps, self._moment_dtype)
        return new_v, {"moment1": m, "moment2": u}

    def _update_all(self, vals, grads, states, lr, step_t, param_lrs,
                    params):
        grads = self._preprocess_grads(vals, grads)
        lrs = [f32_product(lr, plr) for plr in param_lrs]
        new_vals, ms, us = adam_update_multi(
            vals, grads, [s["moment1"] for s in states],
            [s["moment2"] for s in states], lrs, step_t, self._beta1,
            self._beta2, self._eps, self._moment_dtype)
        new_vals = self._decay_multi(vals, new_vals, lrs, params)
        return (cast_all(new_vals, [v.dtype for v in vals]),
                [{"moment1": m, "moment2": u} for m, u in zip(ms, us)])

    def _decay_multi(self, vals, new_vals, lrs, params):
        return new_vals


class AdamW(Adam):
    """AdamW: decoupled weight decay, ``w -= lr * coeff * w`` after the
    Adam step.  ``apply_decay_param_fun(name)`` picks the parameters that
    decay (the others take plain Adam); it needs the parameters' names,
    so pass ``model.named_parameters()``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         moment_dtype=moment_dtype, name=name)
        self._wd_coeff = float(weight_decay) if not hasattr(
            weight_decay, "coeff") else weight_decay.coeff
        self._apply_decay_param_fun = apply_decay_param_fun
        self._decay_mask = None

    def _decoupled_weight_decay(self):
        return True

    def _decay_flags(self, params, n):
        fn = self._apply_decay_param_fun
        if fn is None:
            return (True,) * n
        if self._decay_mask is None:
            unnamed = [i for i, p in enumerate(self._parameter_list)
                       if self._param_name(p) is None]
            if unnamed:
                raise ValueError(
                    f"apply_decay_param_fun needs parameter names, and "
                    f"parameters {unnamed[:4]} have none: pass "
                    f"model.named_parameters()")
            self._decay_mask = {id(p): bool(fn(self._param_name(p)))
                                for p in self._parameter_list}
        return tuple(self._decay_mask.get(id(p), True)
                     for p in self._params_of(params, n))

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        new_v, ns = super()._apply_one(v, g, s, lr, step_t)
        if decay:
            new_v = new_v - f32_product(lr, self._wd_coeff) * v.float()
        return new_v, ns

    def _decay_multi(self, vals, new_vals, lrs, params):
        idx = [i for i, on in enumerate(self._decay_flags(params, len(vals)))
               if on]
        if not idx:
            return new_vals
        dec = torch._foreach_mul(
            cast_all([vals[i] for i in idx], torch.float32),
            [f32_product(lrs[i], self._wd_coeff) for i in idx])
        out = list(new_vals)
        for i, nv in zip(idx, torch._foreach_sub([new_vals[i] for i in idx],
                                                 dec)):
            out[i] = nv
        return out


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._eps = epsilon
        self._init_val = initial_accumulator_value

    def _init_accumulators(self, p):
        return {"moment": torch.full(p.shape, self._init_val,
                                     dtype=torch.float32, device=p.device)}

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        g32 = g.float()
        mom = s["moment"] + g32 * g32
        new_v = v.float() - lr * g32 / (mom.sqrt() + self._eps)
        return new_v, {"moment": mom}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._rho = rho
        self._eps = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_accumulators(self, p):
        def zeros():
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        s = {"mean_square": zeros(), "momentum": zeros()}
        if self._centered:
            s["mean_grad"] = zeros()
        return s

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        g32 = g.float()
        rho = self._rho
        ms = rho * s["mean_square"] + (1 - rho) * (g32 * g32)
        out = dict(s, mean_square=ms)
        denom = ms
        if self._centered:
            mg = rho * s["mean_grad"] + (1 - rho) * g32
            out["mean_grad"] = mg
            denom = ms - mg * mg
        mom = self._momentum * s["momentum"] + lr * g32 / (
            denom + self._eps).sqrt()
        out["momentum"] = mom
        return v.float() - mom, out


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._rho = rho
        self._eps = epsilon

    def _init_accumulators(self, p):
        return {"avg_squared_grad": torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device),
                "avg_squared_update": torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device)}

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        g32 = g.float()
        rho, eps = self._rho, self._eps
        asg = rho * s["avg_squared_grad"] + (1 - rho) * (g32 * g32)
        update = ((s["avg_squared_update"] + eps).sqrt()
                  / (asg + eps).sqrt()) * g32
        asu = rho * s["avg_squared_update"] + (1 - rho) * (update * update)
        return v.float() - lr * update, {"avg_squared_grad": asg,
                                         "avg_squared_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_accumulators(self, p):
        return {"moment": torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device),
                "inf_norm": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        g32 = g.float()
        m = self._beta1 * s["moment"] + (1 - self._beta1) * g32
        inf = torch.maximum(self._beta2 * s["inf_norm"], g32.abs())
        one = np.float32(1)
        step_lr = float(np.float32(lr) / (
            one - np.float32(self._beta1) ** np.float32(step_t)))
        new_v = v.float() - step_lr * m / (inf + self._eps)
        return new_v, {"moment": m, "inf_norm": inf}


class Lamb(Optimizer):
    """LAMB; ``exclude_from_weight_decay_fn(param)`` True drops the decay
    of that parameter."""

    def __init__(self, learning_rate=0.001,
                 lamb_weight_decay=None, beta1=None,
                 beta2=None, epsilon=None, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None):
        d = LAMB_DEFAULTS
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = (d["lamb_weight_decay"] if lamb_weight_decay is None
                    else lamb_weight_decay)
        self._beta1 = d["beta1"] if beta1 is None else beta1
        self._beta2 = d["beta2"] if beta2 is None else beta2
        self._eps = d["epsilon"] if epsilon is None else epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_flags(self, params, n):
        if self._exclude_fn is None:
            return (True,) * n
        return tuple(not self._exclude_fn(p)
                     for p in self._params_of(params, n))

    def _init_accumulators(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)}

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        new_v, m, u = lamb_update(v, g, s["moment1"], s["moment2"], lr,
                                  step_t, self._beta1, self._beta2,
                                  self._eps, self._wd if decay else 0.0)
        return new_v, {"moment1": m, "moment2": u}


class Lars(Optimizer):
    """LARS momentum (layer-adaptive rate scaling).  Parameters whose name
    contains one of ``exclude_from_weight_decay``'s substrings take no
    decay; that needs the names, so pass ``model.named_parameters()``."""

    def __init__(self, learning_rate=0.001,
                 momentum=LARS_DEFAULTS["momentum"],
                 lars_coeff=LARS_DEFAULTS["lars_coeff"],
                 lars_weight_decay=LARS_DEFAULTS["lars_weight_decay"],
                 epsilon=LARS_DEFAULTS["epsilon"], parameters=None,
                 grad_clip=None, exclude_from_weight_decay=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _decay_flags(self, params, n):
        if not self._exclude:
            return (True,) * n
        if not self._names:
            # matching the substrings against no name would decay what
            # the caller excluded
            raise ValueError(
                "exclude_from_weight_decay needs named parameters to match "
                "against, and none has a name: pass "
                "model.named_parameters() or drop the exclusion list")
        return tuple(not any(s in (self._param_name(p) or "")
                             for s in self._exclude)
                     for p in self._params_of(params, n))

    def _init_accumulators(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}

    def _apply_one(self, v, g, s, lr, step_t, decay=True):
        new_v, vel = lars_update(v, g, s["velocity"], lr, self._momentum,
                                 self._coeff,
                                 self._lars_wd if decay else 0.0, self._eps)
        return new_v, {"velocity": vel}


LarsMomentum = Lars  # the reference exposes both spellings
