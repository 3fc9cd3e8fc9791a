"""paddle.hapi (the JAX package's ``hapi/``): Keras-like ``Model.fit``
(ref ``python/paddle/hapi/``)."""

from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401
