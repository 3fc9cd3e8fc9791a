"""The K-step trainer behind ``Model.fit(jit_compile=...)`` (the JAX
package's ``hapi/compiled.py``).

The JAX package compiles forward, backward and the optimizer's
functional update into one donated jitted program, K steps per call
through ``lax.scan``.  Here the same step runs eagerly through the same
builder, ``parallel/api.make_functional_train_step``:

- the functional train state is the parameters (``functional_call``
  takes them by name), the optimizer's accumulators
  (``Optimizer.functional_state``) and the step count;
- one :meth:`CompiledTrainer.run` does K functional steps over K stacked
  batches and returns the K losses as one device tensor: no host sync
  inside the call;
- nothing is donated: after the call the updated values are copied into
  the live parameters in place, so eval, save and callbacks see them; the
  accumulators go back to the optimizer at epoch end
  (:meth:`CompiledTrainer.sync_optimizer`).

A CUDA-graph capture of the step is ROADMAP Queue 1 item 6's rest.  The
ZeRO-sharded, offloaded and overlapped variants and the flat checkpoint
are item 12, and raise.

Where the JAX package falls back to the eager loop because the first
trace failed (a forward that reads a device value on the host to decide
what to do), the port makes the same decision: the first superstep runs
with host reads of tensors (``numpy``, ``item``, ``tolist``, ``float``,
``bool``, ``int``...) forbidden on the calling thread, and a forward that
makes one raises :class:`HostReadInTrace`, which ``Model.fit`` takes as a
trace failure.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from ..core import random as core_random
from ..nn.layer import functional_call
from ..parallel.api import make_functional_train_step

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"


def has_moe_layers(network) -> bool:
    """Whether any sublayer carries the MoE aux side channel (the port has
    no MoE layer: ROADMAP Queue 1 item 11)."""
    return any(hasattr(l, "l_aux")
               for l in network.sublayers(include_self=True))


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _mutating_layer_types():
    """Layer classes whose forward mutates registered buffers in training
    mode (BatchNorm's running stats, SpectralNorm's power iterates), state
    the functional step cannot carry, so fit stays eager for them."""
    from ..nn.layers.norm import SpectralNorm, _BatchNormBase
    return (_BatchNormBase, SpectralNorm)


def unsupported_reason(model, accumulate_grad_batches=1):
    """Why ``model`` cannot take the compiled fit path (None = it can).

    Cheap structural checks only, the JAX package's; a forward that reads
    device values on the host is caught at the first superstep and falls
    back at run time.
    """
    network, opt, loss = model.network, model._optimizer, model._loss
    if opt is None or loss is None:
        return "prepare() with an optimizer and a loss is required"
    if model._metrics:
        return ("metrics need per-step host outputs; the compiled path "
                "keeps losses on device")
    if accumulate_grad_batches != 1:
        return ("accumulate_grad_batches relies on the eager tape's "
                "update=False staging")
    if not (hasattr(opt, "functional_update")
            and hasattr(opt, "_parameter_list")):
        return (f"{type(opt).__name__} exposes no functional update rule")
    by_id = {id(p) for _, p in network.named_parameters()}
    if any(id(p) not in by_id for p in opt._parameter_list):
        return "optimizer holds parameters outside the fitted network"
    mutating = _mutating_layer_types()
    for layer in network.sublayers(include_self=True):
        if isinstance(layer, mutating):
            return (f"{type(layer).__name__} updates buffers in-place "
                    "during training (running stats)")
    return None


class HostReadInTrace(RuntimeError):
    """A forward read a tensor's value on the host during the first
    superstep: the JAX package's trace would fail there."""


_HOST_READS = ("numpy", "item", "tolist", "__array__", "__bool__",
               "__float__", "__int__", "__index__")


@contextlib.contextmanager
def _forbid_host_reads():
    """Within the block, host reads of a tensor's value on this thread
    raise :class:`HostReadInTrace` (other threads, the DataLoader's, are
    not affected)."""
    owner = threading.get_ident()
    saved = {n: torch.Tensor.__dict__.get(n) for n in _HOST_READS}

    def guard(name, orig):
        def run(self, *a, **k):
            if threading.get_ident() == owner:
                raise HostReadInTrace(
                    f"the forward calls `{name}` on a tensor: a value read "
                    f"on the host decides the step")
            return orig(self, *a, **k)
        return run

    for n in _HOST_READS:
        setattr(torch.Tensor, n, guard(n, getattr(torch.Tensor, n)))
    try:
        yield
    finally:
        for n, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, orig)


class CompiledTrainer:
    """Functional train state and the K-step functional step of one
    ``Model.fit`` run.  ``seed`` seeds the per-step dropout generator
    (default: the last ``paddle.seed``): step ``t`` draws from a
    ``torch.Generator`` seeded ``seed + t``."""

    def __init__(self, model, seed=None, zero_stage=0, master_weights=False,
                 zero_offload=False, grad_overlap=False):
        if int(zero_stage or 0) >= 1 or zero_offload or grad_overlap:
            raise NotImplementedError(
                f"Model.fit(zero_stage=, zero_offload=, grad_overlap=) "
                f"{_DISTRIBUTED}")
        if master_weights:
            warnings.warn(
                "Model.fit(master_weights=True) only takes effect with "
                "zero_stage>=1 on a mesh; ignored", RuntimeWarning,
                stacklevel=3)
        network, opt, loss = model.network, model._optimizer, model._loss
        self._opt = opt
        self._network = network
        plist = opt._parameter_list
        by_id = {id(p): k for k, p in network.named_parameters()}
        order = [by_id[id(p)] for p in plist]
        self._plist, self._order = plist, order
        self._seed = core_random._seed if seed is None else int(seed)
        # the state's parameters are detached views of the live ones: the
        # in-place copy after each superstep updates both
        params = {k: p.detach() for k, p in network.named_parameters()}
        _, buffers = network.functional_state()
        self.state = {"params": params,
                      "opt": opt.functional_state(plist),
                      "step": int(opt._step_count)}
        self.ever_ran = False
        dev = plist[0].device if plist else torch.device("cpu")
        self._device = dev
        seed0 = self._seed   # the step closes over no reference to self

        def grads_of(p, xs, ys, step):
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed0 + int(step))
            ps = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in p.items()}
            with core_random.rng_scope(gen):
                outs = functional_call(network, ps, tuple(xs),
                                       buffers=buffers, training=True)
            outs = _to_list(outs)
            losses = _to_list(loss(*(outs + list(ys))))
            total = losses[0]
            for l in losses[1:]:
                total = total + l
            names = [k for k, v in ps.items() if v.requires_grad]
            grads = torch.autograd.grad(total, [ps[k] for k in names],
                                        allow_unused=True)
            g = {k: (gr if gr is not None else torch.zeros_like(ps[k]))
                 for k, gr in zip(names, grads)}
            return total.detach().float(), g

        self._train_step = make_functional_train_step(
            opt, plist, order, grads_of, scan_batch=True)

    def run(self, xs, ys):
        """One superstep over stacked batches (leaves ``(K, B, ...)`` on
        the parameters' device); returns the ``(K,)`` f32 losses as a
        device tensor, without a host sync.  The learning rate is read
        once per superstep."""
        lr = float(self._opt.get_lr())
        guard = contextlib.nullcontext() if self.ever_ran else \
            _forbid_host_reads()
        with guard:
            p, s, t, losses = self._train_step(
                self.state["params"], self.state["opt"], self.state["step"],
                lr, (xs, ys))
        live = [self.state["params"][k] for k in self._order]
        with torch.no_grad():
            torch._foreach_copy_(live, [p[k] for k in self._order])
        self.state.update(opt=s, step=t)
        self.ever_ran = True
        return losses

    def checkpoint_flat(self):
        raise NotImplementedError(f"CompiledTrainer.checkpoint_flat "
                                  f"(crash-safe fit checkpoints) "
                                  f"{_DISTRIBUTED}")

    def load_checkpoint_flat(self, placed):
        raise NotImplementedError(f"CompiledTrainer.load_checkpoint_flat "
                                  f"(crash-safe fit checkpoints) "
                                  f"{_DISTRIBUTED}")

    def sync_optimizer(self):
        """Write the accumulators and the step count back into the live
        optimizer (epoch end)."""
        self._opt.load_functional_state(self._plist, self.state["opt"],
                                        step_count=self.state["step"])

    def restore_eager(self):
        """Abandon the functional state (trace-failure fallback): the live
        network holds the last good parameters; the accumulators return to
        the optimizer so the eager path continues from them."""
        self.sync_optimizer()
