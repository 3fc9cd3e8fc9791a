"""Activations (the JAX package's ``nn/functional/activation.py``).

Elementwise torch compositions with the JAX package's formulas.  The
entry points take torch tensors or Paddle ``Tensor``s
(``core/tensor.takes_tensors``); the ``<name>_`` variants rebind a
``Tensor`` to the result as ``ops/inplace.py`` does (a torch tensor is
written in place without recording).  ``rrelu`` (training) and
``gumbel_softmax`` draw from the default generator of the input's device
(``core/random.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.random import default_generator
from ...core.tensor import takes_tensors

__all__ = ["celu", "elu", "elu_", "gelu", "glu", "gumbel_softmax",
           "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
           "leaky_relu", "log_sigmoid", "log_softmax", "maxout", "mish",
           "prelu", "relu", "relu6", "relu_", "rrelu", "selu", "sigmoid",
           "silu", "softmax", "softmax_", "softplus", "softshrink",
           "softsign", "swish", "tanh", "tanh_", "tanhshrink",
           "thresholded_relu"]


@takes_tensors
def relu(x, name=None):
    return torch.relu(x)


@takes_tensors
def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


@takes_tensors
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@takes_tensors
def tanh(x, name=None):
    return torch.tanh(x)


@takes_tensors
def gelu(x, approximate: bool = False, name=None):
    """GELU; ``approximate=True`` is the tanh form that GPT's MLP uses
    (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


@takes_tensors
def silu(x, name=None):
    return F.silu(x)


def swish(x, name=None):
    return silu(x)


@takes_tensors
def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


@takes_tensors
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@takes_tensors
def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(torch.clamp_max(x, 0.0)))


@takes_tensors
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@takes_tensors
def celu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x,
                       alpha * torch.expm1(torch.clamp_max(x, 0.0) / alpha))


@takes_tensors
def prelu(x, weight, data_format="NCHW", name=None):
    w = weight
    if w.numel() > 1:
        shape = [1] * x.dim()
        ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape[ch_axis] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


@takes_tensors
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    r = torch.empty_like(x).uniform_(lower, upper,
                                     generator=default_generator(x.device))
    return torch.where(x >= 0, x, r * x)


@takes_tensors
def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


@takes_tensors
def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


@takes_tensors
def hardswish(x, name=None):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@takes_tensors
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


@takes_tensors
def softshrink(x, threshold=0.5, name=None):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - threshold, 0.0)


@takes_tensors
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@takes_tensors
def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, 0.0)


@takes_tensors
def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x, F.softplus(x * beta) / beta)


@takes_tensors
def softsign(x, name=None):
    return x / (1 + torch.abs(x))


@takes_tensors
def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(x, dim=axis)


@takes_tensors
def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(x, dim=axis)


@takes_tensors
def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


@takes_tensors
def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + \
        tuple(x.shape[ax + 1:])
    return torch.amax(x.reshape(shape), dim=ax + 1)


@takes_tensors
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@takes_tensors
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.empty_like(x).uniform_(generator=default_generator(x.device))
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = onehot + y - y.detach()
    return y


def _inplace(x, out):
    from ...ops.inplace import _rebind
    from ...core.tensor import Tensor
    return _rebind(x, out if isinstance(out, Tensor) else Tensor._wrap(out))


def relu_(x, name=None):
    return _inplace(x, relu(x))


def tanh_(x, name=None):
    return _inplace(x, tanh(x))


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, elu(x, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return _inplace(x, softmax(x, axis=axis, dtype=dtype))
