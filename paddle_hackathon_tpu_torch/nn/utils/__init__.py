"""nn.utils (the JAX package's ``nn/utils/__init__.py``): the weight
re-parametrisations ``weight_norm`` / ``remove_weight_norm`` and
``spectral_norm``, and the parameter-vector helpers.

A re-parametrised layer loses its ``weight`` parameter for new ones
(``weight_v`` and ``weight_g``; ``weight_orig`` with the ``weight_u`` /
``weight_v`` buffers), and a forward pre-hook sets ``layer.weight`` to
the effective weight, a plain attribute computed from them, before every
forward: torch autograd takes the gradient to the new parameters, and
``torch.func.functional_call`` swaps them by name.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor
from ..parameter import Parameter

__all__ = ["parameters_to_vector", "remove_weight_norm", "spectral_norm",
           "vector_to_parameters", "weight_norm"]


def _norm_except(v, dim):
    """L2 norm over all axes except ``dim`` (kept as size-1 axes)."""
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Decompose ``layer.<name>`` into the magnitude ``<name>_g`` (the
    norm over every axis but ``dim``, those axes kept at size 1) and the
    direction ``<name>_v``; ``g * v / ||v||`` is recomputed before every
    forward."""
    w = getattr(layer, name)
    v0 = w.detach().clone()
    g0 = _norm_except(v0, dim)
    del layer._parameters[name]
    layer.add_parameter(name + "_v", Parameter(v0, trainable=True))
    layer.add_parameter(name + "_g", Parameter(g0, trainable=True))

    def _recompute(lyr, inputs):
        v = getattr(lyr, name + "_v")
        g = getattr(lyr, name + "_g")
        # a plain attribute, not a registered parameter
        object.__setattr__(lyr, name, g * v / (_norm_except(v, dim) + 1e-12))
        return None

    handle = layer.register_forward_pre_hook(_recompute)
    layer._weight_norm_handle = (handle, name, dim)
    _recompute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Undo :func:`weight_norm`, baking the current effective weight back
    into a single parameter."""
    handle, name, dim = getattr(layer, "_weight_norm_handle",
                                (None, name, 0))
    if handle is not None:
        handle.remove()
    v = getattr(layer, name + "_v").detach()
    g = getattr(layer, name + "_g").detach()
    eff = g * v / (_norm_except(v, dim) + 1e-12)
    del layer._parameters[name + "_v"]
    del layer._parameters[name + "_g"]
    layer.__dict__.pop("_weight_norm_handle", None)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(eff, trainable=True))
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened into one 1-D ``Tensor`` (detached)."""
    return Tensor(torch.cat([p.detach().reshape(-1) for p in parameters]))


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of the flat ``vec`` into the parameters."""
    v = vec._value if isinstance(vec, Tensor) else torch.as_tensor(vec)
    off = 0
    for p in parameters:
        n = int(np.prod(tuple(p.shape))) if p.dim() else 1
        p.copy_(v[off:off + n].reshape(p.shape))
        off += n


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Spectral normalisation: ``layer.<name>`` becomes ``<name>_orig /
    sigma``, sigma estimated by the power iteration on the persistent
    ``<name>_u`` / ``<name>_v`` buffers (advanced before each forward in
    training only, on the detached weight; the gradient reaches
    ``<name>_orig`` through the division and ``u @ W @ v``).  ``dim``
    defaults to 1 for ``Linear`` and the transposed convolutions, else
    0; ``u`` and ``v`` start from ``RandomState(0)``'s normals, as in the
    JAX package."""
    w = getattr(layer, name)
    if dim is None:
        cls = type(layer).__name__
        dim = 1 if cls in ("Linear", "Conv1DTranspose", "Conv2DTranspose",
                           "Conv3DTranspose") else 0
    w0 = w.detach().clone()
    h = w0.shape[dim]
    rest = int(np.prod(tuple(w0.shape))) // h
    rng = np.random.RandomState(0)

    def _l2n(x):
        return x / (np.linalg.norm(x) + eps)

    u0 = _l2n(rng.randn(h).astype(np.float32))
    v0 = _l2n(rng.randn(rest).astype(np.float32))
    del layer._parameters[name]
    layer.add_parameter(name + "_orig", Parameter(w0, trainable=True))
    layer.register_buffer(name + "_u", torch.from_numpy(u0).to(w0.device))
    layer.register_buffer(name + "_v", torch.from_numpy(v0).to(w0.device))

    def _mat(vv):
        if dim != 0:
            perm = (dim,) + tuple(i for i in range(vv.dim()) if i != dim)
            vv = vv.permute(perm)
        return vv.reshape(h, rest)

    def _recompute(lyr, inputs):
        w_orig = getattr(lyr, name + "_orig")
        u = getattr(lyr, name + "_u")
        v = getattr(lyr, name + "_v")
        if lyr.training:
            with torch.no_grad():
                wm = _mat(w_orig.detach())
                for _ in range(n_power_iterations):
                    v = wm.T @ u
                    v = v / (torch.linalg.norm(v) + eps)
                    u = wm @ v
                    u = u / (torch.linalg.norm(u) + eps)
                getattr(lyr, name + "_u").copy_(u)
                getattr(lyr, name + "_v").copy_(v)
        object.__setattr__(lyr, name, w_orig / (u @ _mat(w_orig) @ v))
        return None

    handle = layer.register_forward_pre_hook(_recompute)
    layer._spectral_norm_handle = (handle, name, dim)
    _recompute(layer, None)
    return layer
