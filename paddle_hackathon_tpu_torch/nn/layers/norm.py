"""Normalisation layers (the JAX package's ``nn/layers/norm.py``).

Parameters are made on the current place as ``Linear``'s are
(``core/device.parameter_device``; keyword ``device`` overrides it), and
so are the buffers: ``BatchNorm``'s running ``_mean`` / ``_variance`` and
``SpectralNorm``'s ``weight_u`` / ``weight_v``, named as in the JAX
package so that ``utils/convert.load_jax_state`` carries them across.
``weight_attr`` / ``bias_attr`` ``False`` drops that parameter.

Two layers keep the JAX package's departures from Paddle (ROADMAP,
faults in the reference): ``BatchNorm``'s batch statistics are constants
to the gradient (``nn/functional/norm.py``), and ``SpectralNorm``
returns ``weight / sigma`` detached, advancing its power iterates in
eval mode too.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.device import parameter_device
from .. import functional as F
from .. import initializer as I
from ..layer import Layer

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = parameter_device(device)
        self.weight = None
        self.bias = None
        if weight_attr is not False:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr, dtype=dtype,
                default_initializer=I.Constant(1.0), device=dev)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (num_features,), attr=bias_attr, dtype=dtype, is_bias=True,
                device=dev)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm.  In one process it is ``BatchNorm``, as in
    the JAX package; in a ``torch.distributed`` group of more than one
    rank its statistics would need an all-reduce, which is ROADMAP Queue 1
    item 12, so the forward raises there."""

    def forward(self, x):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            raise NotImplementedError(
                f"SyncBatchNorm across {dist.get_world_size()} ranks "
                f"{_DISTRIBUTED}")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm below it (itself included)
        replaced by a ``SyncBatchNorm`` holding the same state."""
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format,
                      device=layer._mean.device)
            new.set_state_dict(layer.state_dict())
            return new
        return layer


class LayerNorm(Layer):
    """Layer norm over the last dims, ``epsilon=1e-5``, with ``weight``
    (ones) and ``bias`` (zeros) of the normalised shape."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        dev = parameter_device(device)
        self.weight = None
        self.bias = None
        if weight_attr is not False:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr, dtype=dtype,
                default_initializer=I.Constant(1.0), device=dev)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=bias_attr, dtype=dtype,
                is_bias=True, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={list(self._normalized_shape)}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        dev = parameter_device(device)
        self.weight = None
        self.bias = None
        if weight_attr is not False:
            self.weight = self.create_parameter(
                (num_channels,), attr=weight_attr, dtype=dtype,
                default_initializer=I.Constant(1.0), device=dev)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (num_channels,), attr=bias_attr, dtype=dtype, is_bias=True,
                device=dev)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """Instance norm with a ``scale`` (ones) and ``bias`` (zeros) per
    channel; ``momentum`` and ``data_format`` are kept and not read, as in
    the JAX package."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        dev = parameter_device(device)
        self.scale = None
        self.bias = None
        if weight_attr is not False:
            self.scale = self.create_parameter(
                (num_features,), attr=weight_attr, dtype=dtype,
                default_initializer=I.Constant(1.0), device=dev)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (num_features,), attr=bias_attr, dtype=dtype, is_bias=True,
                device=dev)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0),
            device=parameter_device(device))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    with ``dim`` first and the rest flattened, estimated by
    ``power_iters`` steps of the power iteration from the persistent
    ``weight_u`` / ``weight_v``.  As in the JAX package, the result is
    detached from ``weight`` and the iterates advance on every call,
    training or not."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, *, device=None):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        dev = parameter_device(device)
        self.register_buffer("weight_u", torch.ones(h, device=dev) / h ** 0.5)
        self.register_buffer("weight_v", torch.ones(w, device=dev) / w ** 0.5)

    @torch.no_grad()
    def forward(self, weight):
        w = torch.as_tensor(weight, device=self.weight_u.device)
        mat = torch.movedim(w, self._dim, 0).reshape(w.shape[self._dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.norm(v) + self._eps)
            u = mat @ v
            u = u / (torch.linalg.norm(u) + self._eps)
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)
        return w / (u @ mat @ v)


__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LayerNorm", "LocalResponseNorm", "RMSNorm", "SpectralNorm",
           "SyncBatchNorm"]
