"""The functional op library (the JAX package's ``ops/__init__.py``):
each op a torch composition through ``core.autograd.apply_op``, and the
registry ``OP_TABLE`` of the op surface (296 names, as the JAX
package's).  This module also patches the op methods onto ``Tensor``.
"""

from . import creation, linalg, manipulation, math, random, search
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

from ..core.tensor import Tensor

# Registry of every public op, used by tests to assert surface coverage.
OP_TABLE = {}
for _mod in (creation, math, manipulation, linalg, random, search):
    for _name in dir(_mod):
        if _name.startswith("_"):
            continue
        _fn = getattr(_mod, _name)
        if callable(_fn) and getattr(_fn, "__module__", "").startswith(
                "paddle_hackathon_tpu_torch.ops"):
            OP_TABLE.setdefault(_name, _fn)

# the op methods of Tensor (the JAX package's list)
TENSOR_METHODS = [
    # math
    "exp", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "abs",
    "sign", "floor", "ceil", "round", "trunc", "sin", "cos", "tan",
    "tanh", "sinh", "cosh", "asin", "acos", "atan", "reciprocal",
    "square", "erf", "erfinv", "add", "subtract", "multiply", "divide",
    "pow", "maximum", "minimum", "remainder", "mod", "floor_divide",
    "scale", "clip", "lerp", "isnan", "isinf", "isfinite", "isclose",
    "allclose", "equal_all", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "nan_to_num",
    # reductions
    "sum", "mean", "prod", "max", "min", "amax", "amin", "all", "any",
    "std", "var", "median", "cumsum", "cumprod", "logsumexp", "trace",
    "count_nonzero",
    # manipulation
    "reshape", "flatten", "transpose", "t", "squeeze", "unsqueeze",
    "tile", "expand", "expand_as", "broadcast_to", "flip", "roll",
    "cast", "gather", "gather_nd", "take_along_axis", "put_along_axis",
    "scatter", "scatter_nd_add", "index_select", "index_sample",
    "index_add", "masked_select", "masked_fill", "where", "nonzero",
    "unique", "split", "chunk", "unbind", "repeat_interleave",
    "moveaxis", "swapaxes", "tril", "triu", "diag",
    "unstack", "strided_slice",
    # linalg
    "matmul", "mm", "bmm", "dot", "norm", "dist", "cross", "cholesky",
    "inverse", "solve", "matrix_power", "det", "qr", "svd",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "bincount", "histogram",
    # random in-place
    "exponential_", "normal_", "uniform_",
]


def _namespace():
    ns = {}
    for mod in (math, manipulation, linalg, search, creation, random):
        for name in dir(mod):
            if not name.startswith("_"):
                ns.setdefault(name, getattr(mod, name))
    return ns


def _patch_tensor_methods():
    """Attach the op methods to Tensor."""
    ns = _namespace()
    for m in TENSOR_METHODS:
        fn = ns.get(m)
        if fn is not None and not hasattr(Tensor, m):
            setattr(Tensor, m, fn)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    import torch
    from ..core.autograd import apply_op
    from ._common import to_t
    return apply_op("diagonal", lambda v: torch.diagonal(
        v, offset, axis1, axis2), [to_t(x)])


OP_TABLE["diagonal"] = diagonal
_patch_tensor_methods()
Tensor.diagonal = diagonal

# In-place variants (<op>_), built from the out-of-place table and patched
# onto Tensor.
from . import inplace as _inplace_mod  # noqa: E402

for _name, _fn in _inplace_mod.install(_namespace()).items():
    globals()[_name] = _fn
    OP_TABLE.setdefault(_name, _fn)

for _name in ("cond", "lu", "lu_unpack", "tensordot", "logit", "stanh",
              "rad2deg", "deg2rad", "logcumsumexp", "renorm", "nanmedian",
              "nanquantile", "tolist", "is_complex", "is_integer",
              "is_floating_point", "is_empty", "rank", "increment"):
    _fn = globals().get(_name) or OP_TABLE.get(_name)
    if _fn is not None and not hasattr(Tensor, _name):
        setattr(Tensor, _name, _fn)
        OP_TABLE.setdefault(_name, _fn)

# what ``from .ops import *`` brings into ``paddle`` and ``paddle.tensor``:
# the ops, not this package's own imports
__all__ = sorted(OP_TABLE)
