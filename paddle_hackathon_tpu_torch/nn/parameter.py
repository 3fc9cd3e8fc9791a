"""Parameter, ParamAttr and create_parameter (the JAX package's
``nn/parameter.py``).

``Parameter`` is an ``nn.Parameter`` subclass, so that every torch call
site (optimizers, ``torch.func``, ``state_dict``, the train steps) takes
it as it is.  It adds only Paddle's names that do not collide with
torch's: ``trainable`` and ``stop_gradient`` (over ``requires_grad``),
``optimize_attr`` (``{"learning_rate": ...}``, read by the optimizers),
``regularizer``, ``do_model_average``, ``need_clip``, ``name``, a
detaching ``numpy()``, ``set_value``, ``clear_grad``, ``gradient()`` and
``astype``.  Where Paddle and torch differ on a name, a parameter keeps
torch's meaning: ``shape`` is a ``torch.Size``, ``size()`` a method and
``grad`` a ``torch.Tensor``.  Paddle ops take a parameter as they take a
``Tensor``.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..core import device as device_mod
from ..core.dtype import convert_dtype, default_float_dtype
from ..core.tensor import Tensor, _as_payload, _to_numpy

_param_counter = [0]


class Parameter(nn.Parameter):
    """A trainable tensor with Paddle's parameter attributes."""

    def __new__(cls, data=None, requires_grad: bool = True, *,
                trainable: Optional[bool] = None,
                name: Optional[str] = None):
        if isinstance(data, Tensor):
            data = data._value.detach()
        if trainable is not None:
            requires_grad = bool(trainable)
        p = super().__new__(cls, data, requires_grad)
        if name is None:
            name = f"param_{_param_counter[0]}"
            _param_counter[0] += 1
        p._pname = name
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.do_model_average = None
        p.need_clip = True
        return p

    def __deepcopy__(self, memo):
        # nn.Parameter's copy rebuilds through __new__ and would drop the
        # Paddle attributes (a ParamAttr's learning rate among them)
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            setattr(out, k, copy.deepcopy(v, memo))
        return out

    @property
    def name(self):
        return self.__dict__.get("_pname")

    @name.setter
    def name(self, value):
        self.__dict__["_pname"] = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.requires_grad_(not value)

    def numpy(self):
        """The values as numpy, detached (bf16 as its ``uint16`` bits)."""
        return _to_numpy(self)

    def set_value(self, value) -> None:
        """Copy ``value`` (array-like or tensor) into this parameter."""
        with torch.no_grad():
            self.copy_(_as_payload(value, self.dtype, self.device)
                       .reshape(self.shape))

    def clear_grad(self) -> None:
        self.grad = None

    def gradient(self):
        """The gradient as numpy, or None."""
        return None if self.grad is None else _to_numpy(self.grad)

    def astype(self, dtype) -> Tensor:
        """A recorded cast, as a Paddle ``Tensor``."""
        from ..core.autograd import apply_op
        d = convert_dtype(dtype)
        return apply_op("cast", lambda x: x.to(d), [self])


def create_parameter(shape, dtype=None, name=None, attr=None,
                     is_bias: bool = False, default_initializer=None,
                     device=None) -> Parameter:
    """``paddle.create_parameter``: a ``Parameter`` of ``shape`` on
    ``device`` (default the current place), initialised by ``attr``'s
    initializer, else ``default_initializer``, else ``Constant(0)`` for a
    bias and ``XavierUniform`` otherwise; ``attr`` also gives its name,
    learning rate, regularizer, trainability and clip flag."""
    from . import initializer as I

    d = convert_dtype(dtype) or default_float_dtype()
    dev = device_mod.current_device() if device is None else \
        device_mod.resolve_device(device)
    init = default_initializer
    if attr is not None and getattr(attr, "initializer", None) is not None:
        init = attr.initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    value = init(tuple(int(s) for s in shape), d, device=dev)
    trainable = not (attr is not None and
                     getattr(attr, "trainable", True) is False)
    p = Parameter(value, trainable=trainable,
                  name=getattr(attr, "name", None) or name)
    if attr is not None:
        if getattr(attr, "learning_rate", None) is not None:
            p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = getattr(attr, "regularizer", None)
        p.need_clip = getattr(attr, "need_clip", True)
        p.do_model_average = getattr(attr, "do_model_average", None)
    return p


class ParamAttr:
    """``paddle.ParamAttr``: how a layer makes one of its parameters."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None or isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        # an initializer instance
        return ParamAttr(initializer=attr)
