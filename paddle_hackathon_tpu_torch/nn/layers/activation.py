"""Activation layers (the JAX package's ``nn/layers/activation.py``; ref
``python/paddle/nn/layer/activation.py``): each calls the port's
functional."""

from __future__ import annotations

from .. import functional as F
from ..layer import Layer
from ..parameter import ParamAttr


def _make(name, fn_name, **defaults):
    def __init__(self, name=None, **kwargs):
        Layer.__init__(self)
        self._kwargs = {**defaults, **kwargs}

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


ReLU = _make("ReLU", "relu")
ReLU6 = _make("ReLU6", "relu6")
Sigmoid = _make("Sigmoid", "sigmoid")
Tanh = _make("Tanh", "tanh")
SiLU = _make("SiLU", "silu")
Swish = _make("Swish", "swish")
Mish = _make("Mish", "mish")
Hardswish = _make("Hardswish", "hardswish")
Hardsigmoid = _make("Hardsigmoid", "hardsigmoid")
Softsign = _make("Softsign", "softsign")
Tanhshrink = _make("Tanhshrink", "tanhshrink")
LogSigmoid = _make("LogSigmoid", "log_sigmoid")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from .. import initializer as I
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=ParamAttr._to_attr(weight_attr),
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


Silu = SiLU  # paddle spells it Silu (``python/paddle/nn/__init__.py``)


class Softmax2D(Layer):
    """Softmax over the channel axis of NCHW inputs (ref nn.Softmax2D)."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softmax(x, axis=-3)
