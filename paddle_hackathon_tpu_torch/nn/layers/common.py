"""Common layers (the JAX package's ``nn/layers/common.py``).

``Linear`` keeps Paddle's weight layout ``(in_features, out_features)``,
so ``y = x @ W + b`` and a JAX state dict copies in without transposes.
The layers are ``Layer``s (``nn/layer.py``) holding ``Parameter``s
(``nn/parameter.py``) made as Paddle makes them: on the current place
(``core/device.parameter_device``; keyword ``device`` overrides it),
initialised by the ``ParamAttr``'s initializer, else ``Linear``'s
``XavierUniform`` weight and zero bias and ``Embedding``'s
``Normal(0, 1)``.  ``bias_attr=False`` drops the bias.  Each forward is
its functional's (``nn/functional/common.py``).
"""

from __future__ import annotations

import torch

from ...core.device import parameter_device
from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class Linear(Layer):
    """``y = x @ W + b`` with ``W`` of shape ``(in_features, out_features)``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        dev = parameter_device(device)
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr, dtype=dtype,
            device=dev)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, dtype=dtype, is_bias=True,
                device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Dropout(Layer):
    """Dropout (``F.dropout``): ``axis`` broadcasts one mask entry over
    the other dims, ``mode`` is ``"upscale_in_train"`` or
    ``"downscale_in_infer"``; the identity at eval or ``p == 0``.  The
    mask is drawn from the device's default generator
    (``core/random.py``)."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = float(p), axis, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Embedding(Layer):
    """A row lookup; rows looked up at ``padding_idx`` come out zero, as in
    the JAX package.  ``sparse`` is accepted and has no effect there
    either."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr, dtype=dtype,
            default_initializer=I.Normal(0.0, 1.0),
            device=parameter_device(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self.padding, self.mode = padding, mode
        self.value, self.data_format = value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    pass


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    """``out[b, o] = x1[b] @ W[o] @ x2[b] + bias[o]``, ``W`` of shape
    ``(out_features, in1_features, in2_features)``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        dev = parameter_device(device)
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            dtype=dtype, device=dev)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, dtype=dtype, is_bias=True,
                device=dev)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings, self.dilations = strides, paddings, dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class PairwiseDistance(Layer):
    """The p-norm of ``x - y + epsilon`` over the last dim."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        from ...ops import linalg as _lin
        return _lin.norm(x - y + self.epsilon, p=self.p, axis=-1,
                         keepdim=self.keepdim)._value


__all__ = ["AlphaDropout", "Bilinear", "ChannelShuffle", "CosineSimilarity",
           "Dropout", "Dropout2D", "Dropout3D", "Embedding", "Flatten",
           "Fold", "Linear", "Pad1D", "Pad2D", "Pad3D", "PairwiseDistance",
           "PixelShuffle", "PixelUnshuffle", "Unfold", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "ZeroPad2D"]
