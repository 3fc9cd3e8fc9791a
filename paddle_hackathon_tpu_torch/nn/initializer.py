"""Weight initializers (the JAX package's ``nn/initializer.py``).

An initializer is a callable ``(shape, dtype, device=None) ->
torch.Tensor`` drawing from the device's default generator
(``core/random.default_generator``), so ``paddle.seed`` reproduces it;
``device`` defaults to the current place.  Torch's generator cannot
reproduce JAX's draws: the two packages agree in distribution, not in
values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import device as device_mod
from ..core.dtype import convert_dtype, default_float_dtype
from ..core.random import default_generator


def _fan_in_out(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    # paddle Linear weight layout is (in_features, out_features);
    # conv weight layout is (out_channels, in_channels, *kernel)
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    else:
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


def _where(dtype, device):
    d = convert_dtype(dtype) or default_float_dtype()
    dev = device_mod.current_device() if device is None else \
        torch.device(device)
    return d, dev


def _normal(shape, dtype, device, mean=0.0, std=1.0):
    d, dev = _where(dtype, device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    out.normal_(mean, std, generator=default_generator(dev))
    return out.to(d)


def _uniform(shape, dtype, device, low, high):
    d, dev = _where(dtype, device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    out.uniform_(low, high, generator=default_generator(dev))
    return out.to(d)


class Initializer:
    def __call__(self, shape, dtype, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        d, dev = _where(dtype, device)
        return torch.full(tuple(shape), self.value, dtype=d, device=dev)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        from ..core.tensor import _as_payload
        d, dev = _where(dtype, device)
        return _as_payload(self.value, d, dev).reshape(tuple(shape)).clone()


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        return _normal(shape, dtype, device, self.mean, self.std)


class TruncatedNormal(Initializer):
    """Normal(mean, std) truncated to two standard deviations, drawn by
    the inverse CDF of a uniform draw."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        d, dev = _where(dtype, device)
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
        u = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        u.uniform_(2 * lo - 1, 2 * hi - 1, generator=default_generator(dev))
        z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return (z * self.std + self.mean).to(d)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device=None):
        return _uniform(shape, dtype, device, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _normal(shape, dtype, device, 0.0, std)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, device, -limit, limit)


def _kaiming_gain(negative_slope, nonlinearity):
    return (math.sqrt(2.0 / (1 + negative_slope ** 2))
            if nonlinearity in ("relu", "leaky_relu") else 1.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            / math.sqrt(fi)
        return _normal(shape, dtype, device, 0.0, std)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, device, -limit, limit)


class Orthogonal(Initializer):
    """``gain`` times a (semi-)orthogonal matrix over the last dim against
    the rest, from the QR of a normal draw with R's diagonal signs folded
    in (as ``jax.nn.initializers.orthogonal``)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        d, dev = _where(dtype, device)
        shape = tuple(shape)
        n_rows, n_cols = int(np.prod(shape[:-1])), shape[-1]
        big, small = max(n_rows, n_cols), min(n_rows, n_cols)
        a = _normal((big, small), torch.float32, dev)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q).reshape(shape).to(d)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype, device=None):
        d, dev = _where(dtype, device)
        out = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for i in range(min(oc, ic * self.groups)):
            idx = (i, i % ic) + tuple(centers)
            out[idx] = 1.0
        return torch.from_numpy(out).to(device=dev, dtype=d)
