"""The one-device train step (the JAX package's ``parallel/api.py``,
``make_sharded_train_step`` with ``optimizer="adam"`` and no mesh).

One call of ``step`` runs the forward, the mean token cross entropy
(``fused_softmax_ce_rows``), the backward, the global-norm clip and the
Adam update of every parameter.  The update is done in place under
``torch.no_grad()``: the JAX step donates the old buffers and rebinds the
model to the new ones instead.  Everything that needs more than one
device (a mesh with an axis over 1, pp, sp, ZeRO, offload) and the step's
other options raise ``NotImplementedError`` unless left at their defaults.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.random import rng_scope
from ..nn.functional.loss import fused_softmax_ce_rows
from ..optimizer.optimizers import Adam

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"


def _mesh_shape(mesh) -> dict:
    """Axis sizes of ``mesh``: None, a ``{axis: size}`` mapping, or an
    object with such a ``shape``."""
    if mesh is None:
        return {}
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    return {str(k): int(v) for k, v in dict(shape).items()}


def _as_ids(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.long)


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

    ``step(state, ids, labels, rng=None, lr=None) -> (state, loss)`` with
    ``ids`` and ``labels`` (b, s) integer arrays or tensors, ``rng`` an
    optional int that seeds this step's dropout, ``lr`` an optional
    learning rate for this step.  ``loss`` is a 0-d f32 tensor on the
    model's device (not synchronised).  The update runs through one
    :class:`~..optimizer.Adam` that the step owns, in place, so ``state``
    (``{"params": {name: parameter}, "opt_state": {name: {"moment1",
    "moment2"}}, "step": int}``) is a view of the model and that optimizer
    after the last step, returned for the JAX call shape.

    ``param_dtype`` casts the floating parameters once; the moments are
    ``moment_dtype`` (default f32).  Adam's β1, β2, ε default to 0.9,
    0.95, 1e-8 (``optimizer_kwargs`` overrides them).  Every other option
    raises ``NotImplementedError`` unless it has its default value.
    """
    axes = _mesh_shape(mesh)
    if any(n > 1 for n in axes.values()):
        raise NotImplementedError(
            f"make_sharded_train_step on a mesh of more than one device "
            f"({axes}: data, tensor, pipeline or sequence parallelism) "
            f"{_DISTRIBUTED}")
    for name, on in (("a tensor-parallel rule", rule is not None),
                     ("zero_stage", bool(zero_stage)),
                     ("recompute", recompute),
                     ("recompute_policy", recompute_policy is not None),
                     ("pp_microbatches", pp_microbatches is not None),
                     ("sp_mode", sp_mode != "auto"),
                     ("master_weights", master_weights),
                     ("zero_offload", zero_offload),
                     ("grad_overlap", grad_overlap),
                     ("offload_depth", offload_depth != 2),
                     ("a custom loss_fn", loss_fn is not None)):
        if on:
            raise NotImplementedError(f"make_sharded_train_step: {name} "
                                      f"{_DISTRIBUTED}")
    opt_kind = optimizer.lower()
    if opt_kind in ("lamb", "lars"):
        raise NotImplementedError(f"make_sharded_train_step: {opt_kind} "
                                  f"{_DISTRIBUTED}")
    if opt_kind != "adam":
        raise ValueError(f"optimizer must be adam/lamb/lars, got {optimizer}")
    okw = dict(optimizer_kwargs or {})

    params = dict(model.named_parameters())
    if param_dtype is not None:
        pdt = convert_dtype(param_dtype)
        with torch.no_grad():
            for p in params.values():
                if p.dtype.is_floating_point:
                    p.data = p.data.to(pdt)
    # the JAX step sums the squared norms over the sorted parameter names
    names = sorted(params)
    opt = Adam(learning_rate=learning_rate,
               beta1=float(okw.get("beta1", 0.9)),
               beta2=float(okw.get("beta2", 0.95)),
               epsilon=float(okw.get("epsilon", 1e-8)),
               parameters=[params[k] for k in names],
               moment_dtype=moment_dtype)
    device = next(iter(params.values())).device

    def view():
        return {"params": params,
                "opt_state": {k: opt._get_accumulators(params[k])
                              for k in names},
                "step": opt._step_count}

    def step(state, ids, labels, rng=None, lr=None):
        model.train()
        ids = _as_ids(ids, device)
        labels = _as_ids(labels, device)
        opt.clear_grad()
        gen = None
        if rng is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(rng))
        with rng_scope(gen) if gen is not None else contextlib.nullcontext():
            logits = model(ids)
        loss = fused_softmax_ce_rows(logits, labels).mean()
        loss.backward()
        if grad_clip_norm is not None:
            with torch.no_grad():
                grads = [params[k].grad for k in names]
                gnorm = torch.stack([g.float().square().sum()
                                     for g in grads]).sum().sqrt()
                scale = grad_clip_norm / torch.clamp_min(gnorm,
                                                         grad_clip_norm)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
        opt.set_lr(learning_rate if lr is None else lr)
        opt.step()
        opt.clear_grad()
        return view(), loss.detach()

    return step, view()
