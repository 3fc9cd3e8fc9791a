"""The user-facing Tensor (the JAX package's ``core/tensor.py``).

A ``Tensor`` wraps a ``torch.Tensor`` payload, ``_value``, as the JAX
package's wraps a ``jax.Array``; it does not subclass ``torch.Tensor``,
whose names (``shape``, ``size``, ``grad``, ``transpose``...) mean other
things, and whose ``__torch_function__`` would put Python dispatch on
every op.  Torch autograd records on the payloads:

- ``stop_gradient=False`` on a leaf is ``requires_grad_(True)``; setting
  ``stop_gradient=True`` on a recorded tensor rebinds its payload to its
  ``detach()``;
- ``grad`` wraps the payload's ``.grad``; ``backward`` is
  ``torch.autograd.backward`` on the payload; ``register_hook`` wraps
  and unwraps around the torch hook;
- in-place ops (``x[i] = v``, ``set_value``, ``fill_``, the ``<op>_``
  variants of ``ops/inplace.py``) rebind the payload to a new
  out-of-place result, as the JAX package does, so a recorded graph
  keeps the values it saw and never meets torch's "modified by an
  inplace operation".  A grad-carrying leaf payload replaced this way is
  kept (weakly) as an alias: gradients that later reach it through an
  earlier graph land on this tensor, in ``grad`` and in ``paddle.grad``.

Integer tensors are int32 and float64 input becomes float32, as in the
JAX package with JAX's 64-bit types off (``core/dtype.py`` ``narrow``).
``numpy()`` of a bf16 tensor is its ``uint16`` bit view, Paddle 2.3's own
answer (numpy has no bf16 and the port does not import ``ml_dtypes``).
Most math methods are patched onto this class by ``ops/__init__.py``.
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional

import numpy as np
import torch

from . import autograd, device
from .dtype import convert_dtype, narrow, to_paddle


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    v = v.detach()
    if v.device.type != "cpu":
        v = v.cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.uint16)
    return v.numpy()


class Tensor:
    __slots__ = ("_value", "_sg", "name", "persistable", "_aliases",
                 "__weakref__")

    def __init__(self, value, stop_gradient: bool = True,
                 name: Optional[str] = None):
        if isinstance(value, Tensor):
            value = value._value
        elif not isinstance(value, torch.Tensor):
            value = _as_payload(value, None, device.current_device())
        if narrow(value.dtype) is not value.dtype:
            value = value.to(narrow(value.dtype))
        if value.requires_grad:
            value = value.detach()
        self._value = value
        self._sg = True
        self.name = name
        self.persistable = False
        self._aliases = None
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, value: torch.Tensor) -> "Tensor":
        """Wrap an op's output (no copy; 64-bit dtypes narrowed)."""
        t = cls.__new__(cls)
        if value.dtype in (torch.int64, torch.float64, torch.complex128):
            value = value.to(narrow(value.dtype))
        t._value = value
        t._sg = True
        t.name = None
        t.persistable = False
        t._aliases = None
        return t

    # -- metadata ----------------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return to_paddle(self._value.dtype)

    @property
    def size(self):
        return self._value.numel()

    @property
    def place(self):
        return device.to_place(self._value.device)

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    @property
    def _grad_node(self):
        """The payload's ``grad_fn`` (None for a leaf)."""
        return self._value.grad_fn

    def numel(self) -> int:
        return self.size

    # -- autograd state ----------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        v = self._value
        if v.is_floating_point() or v.is_complex():
            return not v.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        value = bool(value)
        self._sg = value
        v = self._value
        if not (v.is_floating_point() or v.is_complex()):
            return
        # a new alias of the payload, never the payload itself changed:
        # another holder of it (a Parameter the op wrapped) keeps its flag
        if value and v.requires_grad:
            new = v.detach()
            if v.grad_fn is None:
                new.grad = v.grad
            self._value = new
        elif not value and not v.requires_grad:
            self._value = v.detach().requires_grad_(True)

    def _live_aliases(self):
        if not self._aliases:
            return []
        live = [a() for a in self._aliases]
        live = [a for a in live if a is not None]
        self._aliases = [weakref.ref(a) for a in live] or None
        return live

    def _rebind(self, value: torch.Tensor) -> None:
        """Point this tensor at a new payload (an in-place op's result).
        A grad-carrying leaf payload is kept as an alias, with its
        gradient moved onto the new payload where that is a leaf."""
        old = self._value
        if old.requires_grad and old.grad_fn is None:
            if self._aliases is None:
                self._aliases = []
            self._aliases.append(weakref.ref(old))
            g = old.grad
            if g is not None and value.grad_fn is None and \
                    value.requires_grad and g.shape == value.shape and \
                    g.dtype == value.dtype and g.device == value.device:
                value.grad, old.grad = g, None
        if value.dtype in (torch.int64, torch.float64, torch.complex128):
            value = value.to(narrow(value.dtype))
        self._value = value

    def _set_leaf(self, value: torch.Tensor) -> None:
        """Rebind to a new leaf payload holding ``value``, keeping this
        tensor's ``stop_gradient``."""
        stop = self.stop_gradient
        value = value.detach()
        if not stop and (value.is_floating_point() or value.is_complex()):
            value = value.requires_grad_(True)
        self._rebind(value)

    # -- conversion --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """The values as numpy (a copy off the card); bf16 as its
        ``uint16`` bit view."""
        return _to_numpy(self._value)

    def item(self, *args):
        """A python number: the only element, or the one at ``args`` (a
        flat index, or one index per axis), as numpy's ``item``."""
        v = self._value.detach()
        if not args:
            return v.item()
        return (v[args] if len(args) > 1 else v.reshape(-1)[args[0]]).item()

    def tolist(self):
        return self._value.detach().cpu().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype) -> "Tensor":
        d = convert_dtype(dtype)
        return autograd.apply_op("cast", lambda x: x.to(d), [self])

    cast = astype

    # -- autograd ----------------------------------------------------------
    @property
    def grad(self) -> Optional["Tensor"]:
        g = self._grad_payload()
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        self._clear_alias_grads()
        self._value.grad = None if value is None else \
            _as_payload(value, self._value.dtype, self._value.device)

    def _grad_payload(self):
        """The accumulated gradient: the payload's ``.grad`` (a leaf), with
        what backward left on live aliases folded in."""
        v = self._value
        fold = v.grad_fn is None and v.requires_grad
        g = v.grad if v.grad_fn is None else None
        for a in self._live_aliases():
            if a.grad is None:
                continue
            g = a.grad if g is None else g + a.grad
            if fold:
                v.grad, a.grad = g, None
        return g

    def _clear_alias_grads(self):
        for a in self._live_aliases():
            a.grad = None

    def backward(self, grad_tensor=None, retain_graph: bool = False) -> None:
        """Accumulate the gradients of this tensor into the leaves it
        depends on (``grad_tensor`` seeds it; default ones)."""
        autograd.run_backward([self], [grad_tensor],
                              retain_graph=retain_graph)

    def clear_grad(self) -> None:
        self._clear_alias_grads()
        if self._value.grad_fn is None:
            self._value.grad = None

    def clear_gradient(self, set_to_zero: bool = False) -> None:
        g = self._grad_payload()
        if set_to_zero and g is not None:
            g.zero_()
        else:
            self.clear_grad()

    def detach(self) -> "Tensor":
        return Tensor(self._value.detach(), stop_gradient=True,
                      name=self.name)

    def clone(self) -> "Tensor":
        return autograd.apply_op("clone", lambda x: x.clone(), [self])

    def register_hook(self, hook) -> "_HookHandle":
        """Gradient hook: ``hook(grad)`` gets the gradient arriving at this
        tensor as a ``Tensor`` and may return a replacement."""
        v = self._value
        if not v.requires_grad:
            return _HookHandle(None)

        def run(g):
            out = hook(Tensor._wrap(g))
            if out is None:
                return None
            return out._value if isinstance(out, Tensor) else out
        return _HookHandle(v.register_hook(run))

    # -- in-place (rebinding) ----------------------------------------------
    def _set_value(self, value) -> None:
        """Replace the payload (an optimizer's update path)."""
        self._set_leaf(_as_payload(value, None, self._value.device))

    def set_value(self, value) -> None:
        v = _as_payload(value, self._value.dtype, self._value.device)
        self._set_leaf(v.reshape(self._value.shape))

    def copy_(self, other, blocking: bool = True) -> None:
        self.set_value(other)

    def fill_(self, value) -> "Tensor":
        self._set_leaf(torch.full_like(self._value.detach(), value))
        return self

    def zero_(self) -> "Tensor":
        self._set_leaf(torch.zeros_like(self._value.detach()))
        return self

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, idx) -> "Tensor":
        idx = _unwrap_index(idx)
        return autograd.apply_op("slice", lambda x: x[idx], [self])

    def __setitem__(self, idx, value) -> None:
        idx = _unwrap_index(idx)
        if not isinstance(value, Tensor):
            value = Tensor(_as_payload(value, self._value.dtype,
                                       self._value.device))
        out = autograd.apply_op("set_value",
                                functools.partial(_setitem, idx=idx),
                                [self, value])
        # in-place rebind: this tensor now refers to the scatter's result,
        # recorded against its old payload (paddle set_value semantics)
        self._rebind(out._value)

    # -- python protocol ---------------------------------------------------
    def __len__(self):
        if self._value.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __iter__(self):
        if self._value.dim() == 0:
            raise TypeError("iteration over a 0-d tensor")
        return (self[i] for i in range(self._value.shape[0]))

    def __bool__(self):
        return bool(self._value)

    def __int__(self):
        return int(self._value)

    def __float__(self):
        return float(self._value)

    def __index__(self):
        return int(self._value)

    def __repr__(self):
        v = self._value.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        val = np.array2string(v.numpy(), precision=4, separator=", ")
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},"
                f"\n       {val})")

    def __hash__(self):
        return id(self)

    # -- dunder math (the fuller set is patched in ops/__init__.py) --------
    def _binop(self, other, fn, name):
        if not isinstance(other, Tensor):
            other = _scalar_like(other, self._value)
        return autograd.apply_op(name, fn, [self, other])

    def __add__(self, o):
        return self._binop(o, torch.add, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, torch.sub, "subtract")

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a, "rsubtract")

    def __mul__(self, o):
        return self._binop(o, torch.mul, "multiply")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, torch.true_divide, "divide")

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: torch.true_divide(b, a), "rdivide")

    def __floordiv__(self, o):
        return self._binop(o, torch.floor_divide, "floor_divide")

    def __mod__(self, o):
        return self._binop(o, torch.remainder, "remainder")

    def __pow__(self, o):
        return self._binop(o, torch.pow, "pow")

    def __rpow__(self, o):
        return self._binop(o, lambda a, b: torch.pow(b, a), "rpow")

    def __and__(self, o):
        return self._binop(o, torch.bitwise_and, "bitwise_and")

    def __or__(self, o):
        return self._binop(o, torch.bitwise_or, "bitwise_or")

    def __xor__(self, o):
        return self._binop(o, torch.bitwise_xor, "bitwise_xor")

    def __matmul__(self, o):
        return self._binop(o, torch.matmul, "matmul")

    def __neg__(self):
        return autograd.apply_op("neg", torch.neg, [self])

    def __abs__(self):
        return autograd.apply_op("abs", torch.abs, [self])

    def _cmp(self, other, fn, name):
        if not isinstance(other, Tensor):
            other = _scalar_like(other, self._value)
        with autograd.no_grad():
            return autograd.apply_op(name, fn, [self, other])

    def __eq__(self, o):
        return self._cmp(o, torch.eq, "equal")

    def __ne__(self, o):
        return self._cmp(o, torch.ne, "not_equal")

    def __lt__(self, o):
        return self._cmp(o, torch.lt, "less_than")

    def __le__(self, o):
        return self._cmp(o, torch.le, "less_equal")

    def __gt__(self, o):
        return self._cmp(o, torch.gt, "greater_than")

    def __ge__(self, o):
        return self._cmp(o, torch.ge, "greater_equal")

    def __invert__(self):
        # logical not for bool, bitwise not for ints (jnp's ``~``)
        with autograd.no_grad():
            return autograd.apply_op("logical_not", torch.bitwise_not, [self])


class _HookHandle:
    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        if self._handle is not None:
            self._handle.remove()
            self._handle = None


def _setitem(x, v, idx):
    out = x.clone()
    out[idx] = v.to(x.dtype)
    return out


def _unwrap_index(idx):
    if isinstance(idx, Tensor):
        return idx._value
    if isinstance(idx, tuple):
        return tuple(i._value if isinstance(i, Tensor) else i for i in idx)
    return idx


def _as_payload(data, dtype, dev) -> torch.Tensor:
    """Anything array-like -> a torch tensor (of ``dtype`` on ``dev`` where
    given).  numpy float64 with no dtype asked becomes float32; a
    ``uint16`` array asked for as bf16 is read as its bit view."""
    if isinstance(data, Tensor):
        v = data._value
    elif isinstance(data, torch.Tensor):
        v = data
    else:
        if isinstance(data, (list, tuple)):
            data = np.asarray([_to_numpy(d._value) if isinstance(d, Tensor)
                               else d for d in data])
        if isinstance(data, np.ndarray) or np.isscalar(data) or \
                isinstance(data, np.generic):
            arr = np.asarray(data)
            if dtype == torch.bfloat16 and arr.dtype == np.uint16:
                v = torch.from_numpy(np.ascontiguousarray(arr)
                                     .view(np.int16)).view(torch.bfloat16)
            else:
                if arr.dtype == np.float64 and dtype is None:
                    arr = arr.astype(np.float32)
                if not arr.flags.writeable or not arr.flags.c_contiguous:
                    arr = np.ascontiguousarray(arr).copy()
                v = torch.from_numpy(arr) if arr.dtype != object \
                    else torch.as_tensor(arr.tolist())
        else:
            v = torch.as_tensor(data)
    if dtype is not None or dev is not None:
        v = v.to(device=dev, dtype=narrow(dtype) if dtype is not None
                 else None)
    return v


def _scalar_like(x, ref: torch.Tensor) -> "Tensor":
    """A python number (or array-like) as a ``Tensor`` on ``ref``'s
    device, to meet ``ref`` in a binary op."""
    return Tensor._wrap(_as_payload(x, None, ref.device))


autograd._set_tensor_class(Tensor)


def _unwrap(x):
    """``Tensor``s (in tuples, lists and dicts) -> their payloads."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (tuple, list)):
        if hasattr(x, "_fields"):            # a namedtuple (a layer's cache)
            return type(x)(*(_unwrap(v) for v in x))
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def _wrap(x):
    """torch tensors (in tuples, lists and dicts) -> ``Tensor``s."""
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(x, (tuple, list)):
        if hasattr(x, "_fields"):
            return type(x)(*(_wrap(v) for v in x))
        return type(x)(_wrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _wrap(v) for k, v in x.items()}
    return x


def takes_tensors(fn):
    """Let a torch function take Paddle ``Tensor``s: they are unwrapped,
    and the output is wrapped in ``Tensor`` only when an argument was
    one (torch callers pay one inline scan of the arguments)."""
    def tensors(args, kwargs):
        return _wrap(fn(*_unwrap(args), **_unwrap(kwargs)))

    @functools.wraps(fn)
    def run(*args, **kwargs):
        for a in args:
            if isinstance(a, Tensor):
                return tensors(args, kwargs)
        if kwargs:
            for a in kwargs.values():
                if isinstance(a, Tensor):
                    return tensors(args, kwargs)
        return fn(*args, **kwargs)
    return run


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: a copy of ``data`` on ``place`` (default the
    current place: the card unless ``set_device("cpu")``).  Lists and
    numpy float64 become float32 and integers int32 (64-bit types off, as
    in the JAX package); a ``uint16`` array asked for as ``"bfloat16"``
    is read as its bit view."""
    dev = device.to_place(place).torch_device if place is not None \
        else device.current_device()
    d = convert_dtype(dtype)
    if isinstance(data, Tensor):
        v = data._value.detach().clone()
    elif isinstance(data, torch.Tensor):
        v = data.detach().clone()
    else:
        v = _as_payload(data, d, None)
    v = v.to(device=dev, dtype=narrow(d) if d is not None else
             narrow(v.dtype))
    if v.dtype == torch.float64:
        v = v.float()
    return Tensor(v, stop_gradient=stop_gradient)
