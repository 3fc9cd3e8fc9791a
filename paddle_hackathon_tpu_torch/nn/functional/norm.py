"""Normalization functionals (the JAX package's ``nn/functional/norm.py``).

Torch compositions with the JAX package's formulas; ``layer_norm`` is
torch's fused ``layer_norm`` (the op ``LayerNorm`` has always run).
``batch_norm`` keeps the JAX package's conventions:

- Paddle's momentum, ``running = m * running + (1 - m) * batch`` (m = 0.9);
- the biased batch variance to normalise with, the unbiased one for the
  running update;
- the running stats written in place (``copy_`` under ``no_grad``), only
  when ``training and not use_global_stats``;
- in training, the batch mean and variance enter the normalisation as
  constants: the JAX package computes them outside its tape, so no
  gradient flows through them (Paddle's kernel differentiates through
  them; ROADMAP, faults in the reference).
"""

from __future__ import annotations

import torch
import torch.nn.functional as _F

from ...core.tensor import takes_tensors
from .common import promote

__all__ = ["batch_norm", "group_norm", "instance_norm", "layer_norm",
           "local_response_norm", "rms_norm"]


def _affine(out, weight, bias, shape=None):
    if weight is not None:
        out = out * (weight if shape is None else weight.reshape(shape))
    if bias is not None:
        out = out + (bias if shape is None else bias.reshape(shape))
    return out


@takes_tensors
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """BatchNorm over every dim but the channel's (dim 1 for ``NC*``
    formats, else the last).  In training the running stats are updated
    in place on the tensors given."""
    ch = 1 % x.dim() if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    if training and not use_global_stats:
        with torch.no_grad():
            mean = torch.mean(x, dim=axes)
            var = torch.var(x, dim=axes, unbiased=False)
            if running_mean is not None:
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean)
            if running_var is not None:
                n = x.numel() / mean.numel()
                running_var.copy_(momentum * running_var + (1 - momentum)
                                  * (var * n / max(n - 1, 1)))
    else:
        mean, var = running_mean, running_var
    shape = [1] * x.dim()
    shape[ch] = mean.shape[0]
    out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                 + epsilon)
    return _affine(out, weight, bias, shape)


@takes_tensors
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Layer norm over the trailing ``normalized_shape`` dims (biased
    variance), scaled by ``weight`` and shifted by ``bias``."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(int(s) for s in normalized_shape)
    x, weight, bias = promote(x, weight, bias)
    return _F.layer_norm(x, shape, weight, bias, epsilon)


@takes_tensors
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = not data_format.startswith("NC")
    v = torch.movedim(x, -1, 1) if channel_last else x
    n, c = v.shape[0], v.shape[1]
    grouped = v.reshape((n, num_groups, c // num_groups)
                        + tuple(v.shape[2:]))
    axes = tuple(range(2, grouped.dim()))
    mean = torch.mean(grouped, dim=axes, keepdim=True)
    var = torch.var(grouped, dim=axes, unbiased=False, keepdim=True)
    out = ((grouped - mean) / torch.sqrt(var + epsilon)).reshape(v.shape)
    out = _affine(out, weight, bias, [1, c] + [1] * (v.dim() - 2))
    return torch.movedim(out, 1, -1) if channel_last else out


@takes_tensors
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-sample, per-channel normalisation over dims 2..; the running
    stats, ``use_input_stats``, ``momentum`` and ``data_format`` are not
    read, as in JAX."""
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, unbiased=False, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    return _affine(out, weight, bias, [1, x.shape[1]] + [1] * (x.dim() - 2))


@takes_tensors
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum of squares over a window of size channels)
    ** beta`` (the window's sum, not its mean, as in JAX)."""
    sq = torch.square(x)
    half = size // 2
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    c = x.shape[ch]
    pads = [0, 0] * x.dim()
    j = 2 * (x.dim() - 1 - ch)          # torch's pad lists the last dim first
    pads[j], pads[j + 1] = half, size - half - 1
    padded = _F.pad(sq, pads)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + padded.narrow(ch, i, c)
    return x / torch.pow(k + alpha * acc, beta)


@takes_tensors
def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x / torch.sqrt(ms + epsilon)
    return out if weight is None else out * weight
