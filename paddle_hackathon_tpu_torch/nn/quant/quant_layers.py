"""Quantization-aware-training layers (the JAX package's
``nn/quant/quant_layers.py``; ref ``python/paddle/nn/quant/quant_layers.py``:
``FakeQuantAbsMax:47``, ``FakeQuantMovingAverageAbsMax:128``,
``FakeQuantChannelWiseAbsMax:226``, ``MovingAverageAbsMaxScale:310``,
``QuantizedLinear:591``, ``_get_fake_quant_type:722``).

Each fake-quantizer is a plain PyTorch expression with the
straight-through estimator written out, ``v + (q - v).detach()``: the
forward value is the quantize-dequantize of ``v`` and the gradient is the
identity, as in the JAX package's ``v + stop_gradient(q - v)``.  Observer
state lives in buffers with the JAX package's names (``scale``, ``state``,
``accum``), so ``utils.convert.load_jax_state`` carries it across name for
name.  The moving-average observers update only in training mode; the
abs-max quantizers recompute their scale every forward, as the reference
does.

A layer that owns buffers takes ``device`` (``None``: the CUDA card, as
every entry point of the port); the wrappers put theirs on the wrapped
layer's device.

``QuantizedConv2D`` and ``QuantizedConv2DTranspose`` wrap conv layers the
port does not have yet: both raise (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device

__all__ = [
    "FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
    "FakeQuantChannelWiseAbsMax", "MovingAverageAbsMaxScale",
    "QuantizedConv2D", "QuantizedConv2DTranspose", "QuantizedLinear",
    "MAOutputScaleLayer", "FakeQuantMAOutputScaleLayer", "QuantStub",
]


@torch.no_grad()
def _ema_absmax_update(layer, v, rate):
    """The moving-average abs-max recurrence over a layer's
    ``accum``/``state``/``scale`` buffers (shared by the fake-quantizer and
    the observer)."""
    abs_max = v.detach().abs().amax().to(torch.float32)
    accum = rate * layer.accum + abs_max
    state = rate * layer.state + 1.0
    layer.accum.copy_(accum)
    layer.state.copy_(state)
    layer.scale.copy_(accum / state)


def channel_absmax(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-channel absolute maximum over every other axis, in f32: the
    statistic of the channel-wise fake-quantizer and of the weight-only
    serving quantizer (``weight_only.py``)."""
    axis = axis % v.dim()
    other = tuple(i for i in range(v.dim()) if i != axis)
    # amax over an empty dim tuple would reduce every axis
    a = v.abs().amax(dim=other) if other else v.abs()
    return a.to(torch.float32)


def _ste_quant_dequant(v, scale, qmax):
    """Quantize-dequantize with straight-through gradients, in ``v``'s
    dtype (``scale`` already cast to it)."""
    scale = torch.clamp_min(scale, 1e-9)
    q = torch.clamp(torch.round(v / scale * qmax), -qmax, qmax) / qmax * scale
    return v + (q - v).detach()


def _qmax(bits):
    return float(2 ** (bits - 1) - 1)


class FakeQuantAbsMax(nn.Module):
    """Per-tensor abs-max fake quantization (ref ``quant_layers.py:47``):
    scale = max(|x|) of the current tensor; STE gradients."""

    def __init__(self, name=None, quant_bits=8, dtype="float32",
                 reduce_type=None, device=None):
        super().__init__()
        self._quant_bits = quant_bits
        self.register_buffer("scale",
                             torch.zeros(1, device=resolve_device(device)),
                             persistent=False)

    def forward(self, x):
        scale = x.detach().abs().amax().to(torch.float32)
        with torch.no_grad():
            self.scale.copy_(scale.reshape(1))
        return _ste_quant_dequant(x, scale.to(x.dtype),
                                  _qmax(self._quant_bits))


class FakeQuantChannelWiseAbsMax(nn.Module):
    """Per-channel abs-max fake quantization for weights (ref
    ``quant_layers.py:226``)."""

    def __init__(self, name=None, channel_num=None, quant_bits=8,
                 quant_axis=0, dtype="float32", reduce_type=None,
                 device=None):
        super().__init__()
        if not channel_num:
            raise ValueError(
                "FakeQuantChannelWiseAbsMax requires channel_num (the size "
                "of the quantized axis)")
        self._quant_bits = quant_bits
        self._quant_axis = quant_axis
        # recomputed every forward, like FakeQuantAbsMax.scale: not part of
        # the persisted state
        self.register_buffer(
            "scale", torch.zeros(channel_num, device=resolve_device(device)),
            persistent=False)

    def forward(self, x):
        axis = self._quant_axis % x.dim()
        scale = channel_absmax(x.detach(), axis)
        with torch.no_grad():
            self.scale.copy_(scale)
        shape = [1] * x.dim()
        shape[axis] = scale.shape[0]
        return _ste_quant_dequant(x, scale.reshape(shape).to(x.dtype),
                                  _qmax(self._quant_bits))


class FakeQuantMovingAverageAbsMax(nn.Module):
    """Moving-average abs-max fake quantization for activations (ref
    ``quant_layers.py:128``): in training mode ``accum = rate*accum +
    |x|_max; state = rate*state + 1; scale = accum/state``; in eval the
    scale is frozen."""

    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32", reduce_type=None, device=None):
        super().__init__()
        self._moving_rate = moving_rate
        self._quant_bits = quant_bits
        device = resolve_device(device)
        # nonzero start (ref Constant(0.001)): an untrained observer in eval
        # must not collapse activations to zero
        self.register_buffer("scale", torch.full((1,), 1e-3, device=device))
        # state and accum start at 1 (ref Constant(1)), so the first update
        # gives (rate + absmax) / (rate + 1)
        self.register_buffer("state", torch.ones(1, device=device))
        self.register_buffer("accum", torch.ones(1, device=device))

    def forward(self, x):
        if self.training:
            _ema_absmax_update(self, x, self._moving_rate)
        return _ste_quant_dequant(x, self.scale[0].to(x.dtype),
                                  _qmax(self._quant_bits))


class MovingAverageAbsMaxScale(nn.Module):
    """Scale observer only: passes the input through unchanged while
    tracking the moving-average abs-max (ref ``quant_layers.py:310``)."""

    def __init__(self, name=None, moving_rate=0.9, dtype="float32",
                 reduce_type=None, device=None):
        super().__init__()
        self._moving_rate = moving_rate
        device = resolve_device(device)
        self.register_buffer("scale", torch.full((1,), 1e-3, device=device))
        self.register_buffer("state", torch.ones(1, device=device))
        self.register_buffer("accum", torch.ones(1, device=device))

    def forward(self, x):
        if self.training:
            _ema_absmax_update(self, x, self._moving_rate)
        return x


# ref ``quant_layers.py:395``: the quantization entry-point marker is the
# moving-average observer itself
QuantStub = MovingAverageAbsMaxScale


_QUANT_TYPES = {
    "abs_max": (FakeQuantAbsMax,
                ("name", "quant_bits", "dtype", "reduce_type", "device")),
    "moving_average_abs_max": (
        FakeQuantMovingAverageAbsMax,
        ("name", "moving_rate", "quant_bits", "dtype", "reduce_type",
         "device")),
    "channel_wise_abs_max": (
        FakeQuantChannelWiseAbsMax,
        ("name", "channel_num", "quant_bits", "quant_axis", "dtype",
         "reduce_type", "device")),
}


def _get_fake_quant_type(quant_type, **kwargs):
    """ref ``quant_layers.py:722``."""
    if quant_type not in _QUANT_TYPES:
        raise ValueError(f"unsupported quant type {quant_type!r}")
    call, allowed = _QUANT_TYPES[quant_type]
    return call(**{k: v for k, v in kwargs.items() if k in allowed})


class _QuantizedWrapper(nn.Module):
    """Shared QAT wrapper: fake-quant the activation and the wrapped
    layer's weight, then run the float op.  ``weight`` and ``bias`` are the
    wrapped layer's own parameters (shared, so the state names are
    ``<path>.weight`` / ``<path>.bias`` as in the JAX package).

    ``_default_weight_quant_axis`` is the reference's: 1 for the ``(in,
    out)`` Linear weight (its output channels)."""

    _default_weight_quant_axis = 0

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 weight_quant_axis=None, **kwargs):
        super().__init__()
        if weight_quant_axis is None:
            weight_quant_axis = self._default_weight_quant_axis
        self._inner = layer
        self.weight = layer.weight
        self.bias = getattr(layer, "bias", None)
        dev = layer.weight.device
        ch = layer.weight.shape[weight_quant_axis]
        self._fake_quant_weight = _get_fake_quant_type(
            weight_quantize_type, quant_bits=weight_bits, channel_num=ch,
            quant_axis=weight_quant_axis, device=dev)
        self._fake_quant_input = _get_fake_quant_type(
            activation_quantize_type, quant_bits=activation_bits,
            moving_rate=moving_rate, device=dev)

    def _quantized(self, x):
        return self._fake_quant_input(x), self._fake_quant_weight(self.weight)


class QuantizedLinear(_QuantizedWrapper):
    """ref ``quant_layers.py:591``: ``y = fq(x) @ fq(W) + b``."""

    _default_weight_quant_axis = 1   # (in, out): the out-features axis

    def forward(self, x):
        qx, qw = self._quantized(x)
        y = qx @ qw
        return y if self.bias is None else y + self.bias


_NO_CONV = ("the port has no conv layers yet: ROADMAP Queue 1 item 11")


class QuantizedConv2D(nn.Module):
    """ref ``quant_layers.py:398``: wraps a ``Conv2D``, which the port does
    not have yet."""

    def __init__(self, layer=None, *args, **kwargs):
        raise NotImplementedError(f"QuantizedConv2D: {_NO_CONV}")


class QuantizedConv2DTranspose(nn.Module):
    """ref ``quant_layers.py:486``: wraps a ``Conv2DTranspose``, which the
    port does not have yet."""

    def __init__(self, layer=None, *args, **kwargs):
        raise NotImplementedError(f"QuantizedConv2DTranspose: {_NO_CONV}")


class MAOutputScaleLayer(nn.Module):
    """Wrap a layer and observe its output scale (ref
    ``quant_layers.py:662``)."""

    def __init__(self, layer=None, moving_rate=0.9, name=None,
                 dtype="float32", reduce_type=None, device=None):
        super().__init__()
        self._layer = layer
        self._ma_output_scale = MovingAverageAbsMaxScale(
            name, moving_rate, dtype, device=device)

    def forward(self, *inputs, **kwargs):
        out = self._layer(*inputs, **kwargs)
        if isinstance(out, (tuple, list)):
            return out
        return self._ma_output_scale(out)


class FakeQuantMAOutputScaleLayer(nn.Module):
    """Wrap a layer and fake-quant its output (ref
    ``quant_layers.py:689``)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, name=None, *args, device=None, **kwargs):
        super().__init__()
        self._layer = layer
        self._fake_quant_output = FakeQuantMovingAverageAbsMax(
            name, moving_rate, quant_bits=activation_bits, device=device)

    def forward(self, *inputs, **kwargs):
        out = self._layer(*inputs, **kwargs)
        if isinstance(out, (tuple, list)):
            return out
        return self._fake_quant_output(out)
