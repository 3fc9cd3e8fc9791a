"""The Layer module system over ``nn.Module`` (the JAX package's
``nn/layer.py``).

``Layer`` is an ``nn.Module``: torch keeps the registries
(``_parameters``, ``_modules``, ``_buffers``), the forward hooks (Paddle's
pre- and post-hooks have torch's signatures; ``register_forward_post_hook``
is ``register_forward_hook``), ``train`` / ``eval`` and the
recursion.  ``Layer`` adds Paddle's names: ``parameters()`` and
``buffers()`` as lists, ``include_sublayers=``, ``sublayers``,
``full_name``, ``state_dict(include_sublayers=, structured_name_prefix=,
use_hook=)`` beside torch's ``destination=`` / ``prefix=`` /
``keep_vars=``, ``set_state_dict``, ``register_buffer(persistable=)``,
``to(device=, dtype=, blocking=)`` beside torch's positional forms,
``astype``, ``create_parameter``, ``functional_state`` and
:func:`functional_call`.  Every override also takes the keywords torch
passes itself, since torch calls them while it recurses and inside
``torch.func``.

``Layer.__call__`` unwraps Paddle ``Tensor`` inputs to their payloads
and runs ``nn.Module.__call__``; it wraps the outputs in ``Tensor`` only
when an input was a ``Tensor``.  Torch callers (the engine, the train
steps) pass and get torch tensors and pay one inline scan of the
arguments, no extra Python frame; sublayers called inside ``forward``
see torch tensors.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn

from ..core import device as device_mod
from ..core.dtype import DType, convert_dtype, dtype_name
from ..core.tensor import Tensor, _as_payload, _unwrap, _wrap

_name_counter: Dict[str, int] = {}


def _to_device_dtype(args, kwargs):
    """Paddle's ``to(device=None, dtype=None, blocking=None)`` beside
    torch's positional forms -> (device, dtype, torch's other
    keywords)."""
    device = kwargs.pop("device", None)
    dtype = kwargs.pop("dtype", None)
    kwargs.pop("blocking", None)
    for a in args:
        if isinstance(a, torch.Tensor):
            device, dtype = a.device, a.dtype
        elif isinstance(a, (torch.dtype, DType)) or (
                isinstance(a, str) and _is_dtype_name(a)):
            dtype = a
        elif a is not None and not isinstance(a, bool):
            device = a
    if device is not None and not isinstance(device, torch.device):
        device = device_mod.to_place(device).torch_device
    return device, convert_dtype(dtype), kwargs


def _is_dtype_name(s: str) -> bool:
    try:
        convert_dtype(s)
        return True
    except ValueError:
        return False


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        cls = name_scope or self.__class__.__name__.lower()
        idx = _name_counter.get(cls, 0)
        _name_counter[cls] = idx + 1
        self._full_name = f"{cls}_{idx}"
        self._dtype = dtype

    # -- call --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        # takes the place of torch's ``_wrapped_call_impl`` (a compiled
        # module's call, else ``_call_impl``), so a call with torch
        # tensors runs as many Python frames as on an nn.Module, plus the
        # inline scan; a helper call here is measurable on the decode tick
        for a in args:
            if isinstance(a, Tensor):
                return self._call_tensors(args, kwargs)
        if kwargs:
            for a in kwargs.values():
                if isinstance(a, Tensor):
                    return self._call_tensors(args, kwargs)
        if self._compiled_call_impl is not None:
            return self._compiled_call_impl(*args, **kwargs)
        return self._call_impl(*args, **kwargs)

    def _call_tensors(self, args, kwargs):
        return _wrap(nn.Module.__call__(self, *_unwrap(args),
                                        **_unwrap(kwargs)))

    # -- registration ------------------------------------------------------
    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None):
        """A buffer (a ``Tensor`` is kept as its payload); not in
        ``state_dict`` when ``persistable`` (torch: ``persistent``) is
        False."""
        keep = persistable if persistent is None else persistent
        if isinstance(tensor, Tensor):
            tensor = tensor._value
        super().register_buffer(name, tensor, persistent=keep)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        from .parameter import ParamAttr, create_parameter
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        return create_parameter(shape, dtype=dtype or self._dtype, attr=attr,
                                is_bias=is_bias,
                                default_initializer=default_initializer,
                                device=device)

    # -- traversal ---------------------------------------------------------
    def parameters(self, include_sublayers: bool = True, recurse=None):
        """The parameters, as a list."""
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, recurse=None,
                         remove_duplicate: bool = True):
        rec = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=rec,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers: bool = True, recurse=None):
        """The buffers, as a list."""
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      recurse=None, remove_duplicate: bool = True):
        rec = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=rec,
                                     remove_duplicate=remove_duplicate)

    def sublayers(self, include_self: bool = False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def full_name(self) -> str:
        return self._full_name

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a non-None return replaces the
        outputs (torch's ``register_forward_hook``)."""
        return self.register_forward_hook(hook)

    # -- state dict --------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *, prefix: str = "", keep_vars: bool = False):
        """Name -> parameter and persistable buffer (detached unless
        ``keep_vars``); ``include_sublayers=False`` keeps this layer's
        own."""
        prefix = structured_name_prefix + prefix
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        dest = OrderedDict() if destination is None else destination
        for name, p in self._parameters.items():
            if p is not None:
                dest[prefix + name] = p if keep_vars else p.detach()
        for name, b in self._buffers.items():
            if b is not None and name not in \
                    self._non_persistent_buffers_set:
                dest[prefix + name] = b if keep_vars else b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s values (``Tensor``s, torch tensors or numpy
        arrays; bf16 may come as ``uint16`` bits) into the matching
        parameters and buffers, cast to their dtypes.  Returns
        ``(missing_keys, unexpected_keys)``; a shape mismatch raises
        ``ValueError``."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        with torch.no_grad():
            for key, value in state_dict.items():
                if key not in own:
                    unexpected.append(key)
                    continue
                target = own[key]
                v = _as_payload(value, target.dtype, target.device)
                if tuple(v.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: loaded "
                        f"{tuple(v.shape)} vs expected "
                        f"{tuple(target.shape)}")
                target.copy_(v)
        for key in own:
            if key not in state_dict:
                missing.append(key)
        return missing, unexpected

    load_dict = set_state_dict

    # -- device / dtype ----------------------------------------------------
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` (Paddle: ``"gpu"``,
        ``"gpu:N"``, ``"cpu"``, a ``Place``) or torch's forms
        (``to(torch.bfloat16)``, ``to(device)``, ``to(tensor)``); a dtype
        casts the floating parameters and buffers."""
        dev, dt, rest = _to_device_dtype(args, dict(kwargs))
        kw = dict(rest)
        if dev is not None:
            kw["device"] = dev
        if dt is not None:
            kw["dtype"] = dt
        out = super().to(**kw)
        if dt is not None and dt.is_floating_point:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = dtype_name(dt)
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    # -- functional view ---------------------------------------------------
    def functional_state(self):
        """``(params, buffers)``: name-keyed dicts of the detached
        payloads (what :func:`functional_call` takes)."""
        params = {k: p.detach() for k, p in self.named_parameters()}
        bufs = {k: b.detach() for k, b in self.named_buffers()}
        return params, bufs


def functional_call(layer: nn.Module, params: dict, args=(), kwargs=None,
                    buffers: Optional[dict] = None,
                    training: Optional[bool] = None):
    """Run ``layer`` with the tensors of ``params`` (and ``buffers``) in
    place of its own, by name (a subset is allowed), through
    ``torch.func.functional_call``: gradients flow to the given tensors.
    Unlike the JAX package (whose tape is off inside, as ``jax.grad``
    supplies the gradients), torch autograd records here, since it is
    the transform.  ``training`` sets train or eval mode for the call.
    Returns torch tensors (``Tensor``s unwrapped)."""
    kwargs = kwargs or {}
    state = {k: _unwrap(v) for k, v in params.items()}
    if buffers:
        state.update({k: _unwrap(v) for k, v in buffers.items()})
    if not isinstance(args, (tuple, list)):
        args = (args,)
    prev = layer.training
    if training is not None and training != prev:
        layer.train(training)
    try:
        out = torch.func.functional_call(layer, state, tuple(args), kwargs)
    finally:
        if training is not None and training != prev:
            layer.train(prev)
    return _unwrap(out)
