"""The train steps of the JAX package's ``parallel/api.py``, on one device.

- :func:`make_functional_train_step` composes a loss-and-gradient
  function with an optimizer's pure ``functional_update`` into
  ``train_step(params, opt_states, step, lr, batch)``, with gradient
  merge (``merge_k``) and K steps over a stacked batch (``scan_batch``, a
  Python loop where the JAX package runs ``lax.scan``).
- :func:`make_sharded_train_step` is the GPT bench's step: the forward,
  the mean token cross entropy (``fused_softmax_ce_rows``) or a custom
  ``loss_fn``, the backward, the global-norm clip and the Adam
  (multi-tensor), Lamb or Lars update, on f32 master weights if asked.
  The update is done in place under ``torch.no_grad()``: the JAX step
  donates the old buffers and rebinds the model to the new ones instead.

Everything that needs more than one device (a mesh with an axis over 1,
ZeRO, pp, sp, offload, gradient overlap) and recompute raise
``NotImplementedError`` naming ROADMAP Queue 1 item 12.  A sharding
``rule`` on a mesh whose every axis is 1 places nothing, in the JAX
package as here, and is accepted.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.random import rng_scope
from ..nn.functional.loss import fused_softmax_ce_rows
from ..optimizer.optimizers import (LAMB_DEFAULTS, LARS_DEFAULTS,
                                    adam_update_multi, cast_all,
                                    lamb_update, lars_update)

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"


def _mesh_shape(mesh) -> dict:
    """Axis sizes of ``mesh``: None, a ``{axis: size}`` mapping, or an
    object with such a ``shape``."""
    if mesh is None:
        return {}
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    return {str(k): int(v) for k, v in dict(shape).items()}


_current_mesh = None


def set_mesh(mesh) -> None:
    """Set the ambient mesh (None clears it): a ``{axis: size}`` mapping
    or an object with such a ``shape``, where the JAX package's
    ``set_mesh`` takes a ``jax.sharding.Mesh``.  ``ServingEngine`` reads
    its ``pp`` axis: the pipeline-parallel tick is ROADMAP Queue 1 item
    12."""
    global _current_mesh
    _current_mesh = mesh


def get_mesh():
    return _current_mesh


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree


def _as_tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


def _as_ids(x, device) -> torch.Tensor:
    return _as_tensor(x, device).long()


def make_functional_train_step(optimizer, plist, order, grads_of,
                               merge_k: int = 1, scan_batch: bool = False,
                               shard_info=None, grad_overlap: bool = False):
    """Compose ``grads_of`` with ``optimizer.functional_update`` into::

        train_step(params, opt_states, step, lr, batch)
            -> (new_params, new_opt_states, new_step, loss)

    - ``grads_of(params, xs, ys, step) -> (loss, grads)``, with ``grads``
      keyed like ``params`` (a name -> tensor dict); ``order`` maps
      ``plist`` (the optimizer's ordered parameters) to those keys, and
      ``opt_states`` is their accumulator list
      (``optimizer.functional_state(plist)``); ``batch`` is ``(xs, ys)``,
      each a tensor or a tuple, list or dict of tensors.
    - ``merge_k > 1``: the batch's leading dim is split into ``merge_k``
      micro-batches; their losses and f32 gradients are averaged and one
      update follows.
    - ``scan_batch``: every batch leaf has a leading ``(K, B, ...)`` dim;
      K full steps run in turn and ``loss`` is a ``(K,)`` tensor.

    ``step`` is the count of updates so far (an int); ``lr`` a float.
    Nothing is written in place: the new parameters and states are new
    tensors.  ``shard_info`` (ZeRO) and ``grad_overlap`` raise."""
    if shard_info is not None or grad_overlap:
        raise NotImplementedError(
            f"make_functional_train_step with a ZeRO shard_info or "
            f"grad_overlap {_DISTRIBUTED}")

    def one_step(params, opt_states, step, lr, xs, ys):
        if merge_k > 1:
            def split(a):
                return a.reshape((merge_k, a.shape[0] // merge_k)
                                 + a.shape[1:])

            xs_k, ys_k = _tree_map(split, xs), _tree_map(split, ys)
            loss_sum = 0.0
            grad_sum = {k: torch.zeros(v.shape, dtype=torch.float32,
                                       device=v.device)
                        for k, v in params.items()}
            for i in range(merge_k):
                loss, grads = grads_of(params,
                                       _tree_map(lambda a: a[i], xs_k),
                                       _tree_map(lambda a: a[i], ys_k), step)
                loss_sum = loss_sum + loss
                grad_sum = {k: g + grads[k] for k, g in grad_sum.items()}
            loss = loss_sum / merge_k
            grads = {k: g / merge_k for k, g in grad_sum.items()}
        else:
            loss, grads = grads_of(params, xs, ys, step)
        with torch.no_grad():
            new_vals, new_states = optimizer.functional_update(
                [params[k] for k in order], [grads[k] for k in order],
                opt_states, lr, step + 1, params=plist)
        new_params = dict(params)
        new_params.update(zip(order, new_vals))
        return new_params, new_states, step + 1, loss

    def train_step(params, opt_states, step, lr, batch):
        xs, ys = batch
        step = int(step)
        if not scan_batch:
            return one_step(params, opt_states, step, lr, xs, ys)
        losses = []
        for i in range(_first_leaf(xs).shape[0]):
            params, opt_states, step, loss = one_step(
                params, opt_states, step, lr,
                _tree_map(lambda a: a[i], xs), _tree_map(lambda a: a[i], ys))
            losses.append(loss)
        return params, opt_states, step, torch.stack(losses)

    return train_step


def make_sharded_train_step(model, mesh=None,
                            rule: Optional[Callable] = None,
                            learning_rate: float = 1e-4,
                            zero_stage: Optional[int] = None,
                            loss_fn: Optional[Callable] = None,
                            param_dtype=None,
                            grad_clip_norm: Optional[float] = 1.0,
                            recompute: bool = False,
                            recompute_policy: Optional[str] = None,
                            pp_microbatches: Optional[int] = None,
                            moment_dtype=None,
                            sp_mode: str = "auto",
                            optimizer: str = "adam",
                            optimizer_kwargs: Optional[dict] = None,
                            master_weights: bool = False,
                            zero_offload: bool = False,
                            grad_overlap: bool = False,
                            offload_depth: int = 2):
    """Build ``(step, state)`` for one device.

    ``step(state, ids, labels, rng=None, lr=None) -> (state, loss)``.
    ``ids`` and ``labels`` are the batch: (b, s) integer arrays or tensors
    for the default loss; anything (tensors, arrays, or tuples, lists and
    dicts of them, moved to the model's device) for a custom ``loss_fn``.
    ``rng`` is an optional int that seeds this step's dropout, ``lr`` an
    optional learning rate for this step.  ``loss`` is a 0-d f32 tensor on
    the model's device (not synchronised).

    ``loss_fn(model, params, buffers, batch, rng) -> loss`` replaces the
    mean token cross entropy of ``model(ids)`` against ``labels``:
    ``params`` and ``buffers`` are the model's name -> tensor dicts (what
    ``torch.func.functional_call`` takes), ``batch`` is ``(ids,
    labels)`` and ``rng`` the step's ``torch.Generator`` or None.

    ``optimizer`` is ``"adam"`` (β1, β2, ε default 0.9, 0.95, 1e-8; one
    multi-tensor update), ``"lamb"`` or ``"lars"`` (the optimizers'
    ``LAMB_DEFAULTS`` / ``LARS_DEFAULTS``; per tensor);
    ``optimizer_kwargs`` overrides the defaults.  ``param_dtype`` casts
    the floating parameters once; the moments are ``moment_dtype``
    (default f32).  ``master_weights`` keeps an f32 copy of every
    floating parameter in its state as ``"master"``: the update runs on
    it and the parameter is its cast.

    ``state`` is ``{"params": {name: parameter}, "opt_state": {name:
    {"m", "v" (not for lars)[, "master"]}}, "step": int}``, a view of the
    model and the step's slots after the last step, returned for the JAX
    call shape.
    """
    axes = _mesh_shape(mesh)
    if any(n > 1 for n in axes.values()):
        raise NotImplementedError(
            f"make_sharded_train_step on a mesh of more than one device "
            f"({axes}: data, tensor, pipeline or sequence parallelism) "
            f"{_DISTRIBUTED}")
    for name, on in (("zero_stage", bool(zero_stage)),
                     ("recompute", recompute),
                     ("recompute_policy", recompute_policy is not None),
                     ("pp_microbatches", pp_microbatches is not None),
                     ("sp_mode", sp_mode != "auto"),
                     ("zero_offload", zero_offload),
                     ("grad_overlap", grad_overlap),
                     ("offload_depth", offload_depth != 2)):
        if on:
            raise NotImplementedError(f"make_sharded_train_step: {name} "
                                      f"{_DISTRIBUTED}")
    opt_kind = optimizer.lower()
    if opt_kind not in ("adam", "lamb", "lars"):
        raise ValueError(f"optimizer must be adam/lamb/lars, got {optimizer}")
    okw = dict(optimizer_kwargs or {})
    if opt_kind == "adam":
        b1, b2, eps = (float(okw.get("beta1", 0.9)),
                       float(okw.get("beta2", 0.95)),
                       float(okw.get("epsilon", 1e-8)))
    else:
        b1 = float(okw.get("beta1", LAMB_DEFAULTS["beta1"]))
        b2 = float(okw.get("beta2", LAMB_DEFAULTS["beta2"]))
        eps = float(okw.get(
            "epsilon", LAMB_DEFAULTS["epsilon"] if opt_kind == "lamb"
            else LARS_DEFAULTS["epsilon"]))
    lamb_wd = float(okw.get("lamb_weight_decay",
                            LAMB_DEFAULTS["lamb_weight_decay"]))
    lars_mu = float(okw.get("momentum", LARS_DEFAULTS["momentum"]))
    lars_coeff = float(okw.get("lars_coeff", LARS_DEFAULTS["lars_coeff"]))
    lars_wd = float(okw.get("lars_weight_decay",
                            LARS_DEFAULTS["lars_weight_decay"]))

    params = dict(model.named_parameters())
    if param_dtype is not None:
        pdt = convert_dtype(param_dtype)
        with torch.no_grad():
            for p in params.values():
                if p.dtype.is_floating_point:
                    p.data = p.data.to(pdt)
    buffers = dict(model.named_buffers())
    # the JAX step's dicts iterate in sorted name order: the clip's sum
    # of squares runs over the parameters in that order
    names = sorted(params)
    plist = [params[k] for k in names]
    device = plist[0].device
    mdt = torch.float32 if moment_dtype is None else \
        convert_dtype(moment_dtype)
    slots = ("m",) if opt_kind == "lars" else ("m", "v")

    def init_slots(p):
        st = {s: torch.zeros(p.shape, dtype=mdt, device=p.device)
              for s in slots}
        if master_weights and p.dtype.is_floating_point:
            st["master"] = p.detach().float().clone()
        return st

    opt_state = {k: init_slots(params[k]) for k in names}
    counter = {"step": 0}

    custom_loss = loss_fn is not None
    if not custom_loss:
        def loss_fn(model, params, buffers, batch, rng):
            ids, labels = batch
            return fused_softmax_ce_rows(model(ids), labels).mean()

    def update(grads, lr, t):
        states = [opt_state[k] for k in names]
        vals = [st.get("master", p) for st, p in zip(states, plist)]
        if opt_kind == "adam":
            new_vals, ms, vs = adam_update_multi(
                vals, grads, [st["m"] for st in states],
                [st["v"] for st in states], [lr] * len(vals), t, b1, b2,
                eps, mdt)
            for st, m, v in zip(states, ms, vs):
                st["m"], st["v"] = m, v
        else:
            new_vals = []
            for v, g, st in zip(vals, grads, states):
                if opt_kind == "lamb":
                    nv, st["m"], st["v"] = lamb_update(
                        v, g, st["m"], st["v"], lr, t, b1, b2, eps, lamb_wd,
                        mdt)
                else:
                    nv, vel = lars_update(v, g, st["m"], lr, lars_mu,
                                          lars_coeff, lars_wd, eps)
                    st["m"] = vel.to(mdt)
                new_vals.append(nv)
        for st, nv in zip(states, new_vals):
            if "master" in st:
                st["master"] = nv
        torch._foreach_copy_(plist, cast_all(new_vals,
                                             [p.dtype for p in plist]))

    def view():
        return {"params": params, "opt_state": opt_state,
                "step": counter["step"]}

    def step(state, ids, labels, rng=None, lr=None):
        model.train()
        if custom_loss:
            batch = _tree_map(lambda a: _as_tensor(a, device), (ids, labels))
        else:
            batch = (_as_ids(ids, device), _as_ids(labels, device))
        for p in plist:
            p.grad = None
        gen = None
        if rng is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(rng))
        with rng_scope(gen) if gen is not None else contextlib.nullcontext():
            loss = loss_fn(model, params, buffers, batch, gen)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in plist]
            if grad_clip_norm is not None:
                gnorm = torch.stack([g.float().square().sum()
                                     for g in grads]).sum().sqrt()
                scale = torch.full_like(gnorm, grad_clip_norm) / \
                    torch.clamp_min(gnorm, grad_clip_norm)
                for dt in {g.dtype for g in grads}:
                    torch._foreach_mul_([g for g in grads if g.dtype == dt],
                                        scale.to(dt))
            counter["step"] += 1
            update(grads, float(learning_rate if lr is None else lr),
                   counter["step"])
        for p in plist:
            p.grad = None
        return view(), loss.detach()

    return step, view()
