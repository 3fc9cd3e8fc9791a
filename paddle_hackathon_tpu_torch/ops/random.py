"""Random ops (the JAX package's ``ops/random.py``), drawing from the
device's default generator (``core/random.py``) on the current place.
Torch's generators cannot reproduce JAX's draws: the two packages agree
in shape, dtype, range and distribution, and ``paddle.seed`` repeats a
port's draws."""

from __future__ import annotations

import torch

from ..core.autograd import apply_op
from ..core.dtype import convert_dtype, narrow
from ..core.random import default_generator as _gen
from ..core.tensor import Tensor
from ._common import dev as _dev
from ._common import dt as _dt
from ._common import ints as _shape
from ._common import to_t as _t


def rand(shape, dtype=None, name=None) -> Tensor:
    d = _dev()
    return Tensor._wrap(torch.rand(_shape(shape), generator=_gen(d),
                                   dtype=_dt(dtype), device=d))


def randn(shape, dtype=None, name=None) -> Tensor:
    d = _dev()
    return Tensor._wrap(torch.randn(_shape(shape), generator=_gen(d),
                                    dtype=_dt(dtype), device=d))


def standard_normal(shape, dtype=None, name=None) -> Tensor:
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        ref = mean if isinstance(mean, Tensor) else std
        d = ref._value.device
        m = mean._value if isinstance(mean, Tensor) else mean
        s = std._value if isinstance(std, Tensor) else std
        shp = torch.broadcast_shapes(torch.as_tensor(m).shape,
                                     torch.as_tensor(s).shape) \
            if shape is None else _shape(shape)
        z = torch.randn(shp, generator=_gen(d), dtype=_dt(None), device=d)
        return Tensor._wrap(z * s + m)
    d = _dev()
    z = torch.randn(_shape(shape or [1]), generator=_gen(d), dtype=_dt(None),
                    device=d)
    return Tensor._wrap(z * std + mean)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None) -> Tensor:
    d = _dev()
    gen = _gen(d)
    if seed:
        gen = torch.Generator(device=d)
        gen.manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=d)
    return Tensor._wrap(out.uniform_(min, max, generator=gen))


def randint(low=0, high=None, shape=(1,), dtype="int64",
            name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    d = _dev()
    return Tensor._wrap(torch.randint(
        low, high, _shape(shape), generator=_gen(d),
        dtype=narrow(convert_dtype(dtype)), device=d))


def randint_like(x, low=0, high=None, dtype=None, name=None) -> Tensor:
    shape = x.shape if isinstance(x, Tensor) else list(torch.as_tensor(x)
                                                       .shape)
    return randint(low, high, shape, dtype or "int32")


def randperm(n, dtype="int64", name=None) -> Tensor:
    d = _dev()
    return Tensor._wrap(torch.randperm(n, generator=_gen(d), device=d)
                        .to(narrow(convert_dtype(dtype))))


def bernoulli(x, name=None) -> Tensor:
    return apply_op("bernoulli", lambda p: torch.bernoulli(
        p.detach(), generator=_gen(p.device)), [_t(x)])


def poisson(x, name=None) -> Tensor:
    return apply_op("poisson", lambda lam: torch.poisson(
        lam.detach(), generator=_gen(lam.device)), [_t(x)])


def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    t = _t(x)
    p = t._value.detach()
    out = torch.multinomial(p, num_samples, replacement,
                            generator=_gen(p.device))
    return Tensor._wrap(out.to(torch.int32))


def exponential_(x, lam=1.0, name=None) -> Tensor:
    v = x._value.detach()
    x._set_value(torch.empty_like(v).exponential_(lam,
                                                  generator=_gen(v.device)))
    return x


def normal_(x, mean=0.0, std=1.0, name=None) -> Tensor:
    v = x._value.detach()
    x._set_value(torch.empty_like(v).normal_(mean, std,
                                             generator=_gen(v.device)))
    return x


def uniform_(x, min=-1.0, max=1.0, name=None) -> Tensor:  # noqa: A002
    v = x._value.detach()
    x._set_value(torch.empty_like(v).uniform_(min, max,
                                              generator=_gen(v.device)))
    return x
