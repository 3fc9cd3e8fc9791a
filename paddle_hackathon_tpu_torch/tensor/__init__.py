"""paddle.tensor: the op library under the reference's module layout
(the JAX package's ``tensor/__init__.py``).  The ops live in ``..ops``;
this package re-exports them so that ``import paddle.tensor`` and
``paddle.tensor.math``-style access work."""

import sys as _sys

from .. import ops as _ops
from ..ops import creation, linalg, manipulation, math, random, search  # noqa: F401
from ..ops import *  # noqa: F401,F403

# the reference's submodule names -> the ops modules (stat, logic,
# attribute and einsum functions live inside math here)
stat = math
logic = math
attribute = math
einsum = math

for _name, _mod in (("creation", creation), ("linalg", linalg),
                    ("manipulation", manipulation), ("math", math),
                    ("random", random), ("search", search),
                    ("stat", stat), ("logic", logic),
                    ("attribute", attribute), ("einsum", einsum)):
    _sys.modules.setdefault(f"{__name__}.{_name}", _mod)

__all__ = list(_ops.__all__)
