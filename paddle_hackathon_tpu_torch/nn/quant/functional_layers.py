"""Layer wrappers over functional ops, so that QAT passes can hook the
arithmetic (the JAX package's ``nn/quant/functional_layers.py``; ref
``python/paddle/nn/quant/functional_layers.py``)."""

import torch
from torch import nn

__all__ = []


class FloatFunctionalLayer(nn.Module):
    def __init__(self):
        super().__init__()


class add(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return x + y


class subtract(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return x - y


class multiply(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return x * y


class divide(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return x / y


class reshape(FloatFunctionalLayer):
    def forward(self, x, shape, name=None):
        return torch.reshape(x, tuple(shape))


class transpose(FloatFunctionalLayer):
    def forward(self, x, perm, name=None):
        return x.permute(*perm)


class concat(FloatFunctionalLayer):
    def forward(self, x, axis=0, name=None):
        return torch.cat(list(x), dim=axis)


class flatten(FloatFunctionalLayer):
    def forward(self, x, start_axis=0, stop_axis=-1, name=None):
        return torch.flatten(x, start_axis, stop_axis)
