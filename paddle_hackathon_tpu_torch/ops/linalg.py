"""Linear algebra ops (the JAX package's ``ops/linalg.py``): ``matmul``
stays ``torch.matmul`` (the JAX package leaves it to XLA), the
decompositions ride ``torch.linalg``.
"""

from __future__ import annotations

import torch

from ..core import autograd
from ..core.autograd import apply_op
from ..core.tensor import Tensor
from ._common import to_t as _t


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, each operand's last two axes swapped first when asked."""
    def fn(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op("matmul", fn, [_t(x), _t(y)])


def mm(input, mat2, name=None):  # noqa: A002
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    return apply_op("dot", lambda a, b: torch.sum(a * b, dim=-1),
                    [_t(x), _t(y)])


def mv(x, vec, name=None):
    return apply_op("mv", lambda a, v: a @ v, [_t(x), _t(vec)])


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """``"fro"`` / 2 over everything when ``axis`` is None; else the
    p-norm over ``axis`` (inf, -inf, 0 and any other p)."""
    def fn(v):
        if axis is None and p in ("fro", 2):
            return torch.sqrt(torch.sum(torch.square(v)))
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        if ax is None:
            ax = tuple(range(v.dim()))
        if p == "fro":
            return torch.sqrt(torch.sum(torch.square(v), dim=ax,
                                        keepdim=keepdim))
        if p == float("inf"):
            return torch.amax(torch.abs(v), dim=ax, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(v), dim=ax, keepdim=keepdim)
        if p == 0:
            return torch.sum((v != 0).to(v.dtype), dim=ax, keepdim=keepdim)
        return torch.sum(torch.abs(v) ** p, dim=ax, keepdim=keepdim) \
            ** (1.0 / p)
    return apply_op("p_norm", fn, [_t(x)])


def dist(x, y, p=2, name=None):
    diff = apply_op("subtract", torch.sub, [_t(x), _t(y)])
    return norm(diff, p=float(p) if p not in ("fro",) else p)


def cross(x, y, axis=9, name=None):
    """The cross product over ``axis`` (default: the first axis of size
    3)."""
    def fn(a, b):
        ax = axis if axis != 9 else next(
            (i for i, s in enumerate(a.shape) if s == 3), -1)
        return torch.linalg.cross(a, b, dim=ax)
    return apply_op("cross", fn, [_t(x), _t(y)])


def einsum(equation, *operands):
    tensors = [_t(o) for o in operands]
    return apply_op("einsum", lambda *vs: torch.einsum(equation, *vs),
                    tensors)


def cholesky(x, upper=False, name=None):
    def fn(v):
        c = torch.linalg.cholesky(v)
        return c.transpose(-1, -2) if upper else c
    return apply_op("cholesky", fn, [_t(x)])


def _cho_solve(b, c, upper):
    """Solve ``A @ out = b`` for ``A = L @ L.T`` (``c`` = L, lower) or
    ``U.T @ U`` (``c`` = U): two triangular solves, reading only ``c``'s
    triangle (``jax.scipy.linalg.cho_solve``)."""
    lower = c.transpose(-1, -2) if upper else c
    y = torch.linalg.solve_triangular(lower, b, upper=False)
    return torch.linalg.solve_triangular(lower.transpose(-1, -2), y,
                                         upper=True)


def cholesky_solve(x, y, upper=False, name=None):
    return apply_op("cholesky_solve", lambda b, c: _cho_solve(b, c, upper),
                    [_t(x), _t(y)])


def qr(x, mode="reduced", name=None):
    return apply_op("qr", lambda v: tuple(torch.linalg.qr(v, mode=mode)),
                    [_t(x)])


def svd(x, full_matrices=False, name=None):
    return apply_op("svd", lambda v: tuple(
        torch.linalg.svd(v, full_matrices=full_matrices)), [_t(x)])


def eig(x, name=None):
    """Eigenvalues and vectors of a general matrix (complex; not
    recorded, as in the JAX package)."""
    with autograd.no_grad():
        w, v = torch.linalg.eig(_t(x)._value)
    return Tensor._wrap(w), Tensor._wrap(v)


def eigh(x, UPLO="L", name=None):
    return apply_op("eigh", lambda v: tuple(torch.linalg.eigh(v, UPLO=UPLO)),
                    [_t(x)])


def eigvals(x, name=None):
    with autograd.no_grad():
        return Tensor._wrap(torch.linalg.eigvals(_t(x)._value))


def eigvalsh(x, UPLO="L", name=None):
    return apply_op("eigvalsh", lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO),
                    [_t(x)])


def inverse(x, name=None):
    return apply_op("inverse", torch.linalg.inv, [_t(x)])


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op("pinv", lambda v: torch.linalg.pinv(
        v, rtol=rcond, hermitian=hermitian), [_t(x)])


def solve(x, y, name=None):
    return apply_op("solve", torch.linalg.solve, [_t(x), _t(y)])


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve ``op(x) @ out = y`` for triangular ``x`` (``op`` the
    transpose when ``transpose``)."""
    def fn(a, b):
        vec = b.dim() == a.dim() - 1
        bb = b.unsqueeze(-1) if vec else b
        aa, up = (a.transpose(-1, -2), not upper) if transpose else \
            (a, upper)
        out = torch.linalg.solve_triangular(aa, bb, upper=up,
                                            unitriangular=unitriangular)
        return out.squeeze(-1) if vec else out
    return apply_op("triangular_solve", fn, [_t(x), _t(y)])


def _lstsq(a, b, rcond):
    """``jnp.linalg.lstsq``'s SVD solution: (x, residuals |b - a x|^2 per
    column, rank, singular values)."""
    vec = b.dim() == 1
    bb = b[:, None] if vec else b
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(a.shape[-2], a.shape[-1])
    mask = s >= rcond * s[0]
    rank = mask.sum().to(torch.int32)
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1.0 / safe, torch.zeros_like(s))[:, None]
    sol = vt.transpose(-1, -2) @ (s_inv * (u.transpose(-1, -2) @ bb))
    resid = torch.sum(torch.square(bb - a @ sol), dim=0)
    if vec:
        sol, resid = sol[:, 0], resid[0]
    return sol, resid, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    return apply_op("lstsq", lambda a, b: _lstsq(a, b, rcond),
                    [_t(x), _t(y)])


def matrix_power(x, n, name=None):
    return apply_op("matrix_power",
                    lambda v: torch.linalg.matrix_power(v, n), [_t(x)])


def matrix_rank(x, tol=None, hermitian=False, name=None):
    with autograd.no_grad():
        return apply_op("matrix_rank", lambda v: torch.linalg.matrix_rank(
            v, rtol=tol, hermitian=hermitian), [_t(x)])


def det(x, name=None):
    return apply_op("determinant", torch.linalg.det, [_t(x)])


def slogdet(x, name=None):
    return apply_op("slogdet", lambda v: tuple(torch.linalg.slogdet(v)),
                    [_t(x)])


def multi_dot(x, name=None):
    tensors = [_t(v) for v in x]
    return apply_op("multi_dot", lambda *vs: torch.linalg.multi_dot(vs),
                    tensors)


def householder_product(x, tau, name=None):
    return apply_op("householder_product", torch.linalg.householder_product,
                    [_t(x), _t(tau)])


def corrcoef(x, rowvar=True, name=None):
    return apply_op("corrcoef", lambda v: torch.corrcoef(
        v if rowvar else v.transpose(-1, -2)), [_t(x)])


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply_op("cov", lambda v: torch.cov(
        v if rowvar else v.transpose(-1, -2), correction=1 if ddof else 0),
        [_t(x)])


def cond(x, p=None, name=None):
    """Condition number; ``p`` in {None, 'fro', 'nuc', 1, -1, 2, -2, inf,
    -inf}."""
    def fn(a):
        pp = 2 if p is None else p
        if pp == "fro":
            return (torch.linalg.norm(a, "fro", dim=(-2, -1))
                    * torch.linalg.norm(torch.linalg.inv(a), "fro",
                                        dim=(-2, -1)))
        if pp == "nuc":
            s = torch.linalg.svdvals(a)
            si = torch.linalg.svdvals(torch.linalg.inv(a))
            return s.sum(-1) * si.sum(-1)
        if not isinstance(pp, (int, float)):
            raise ValueError(f"unsupported p={p!r}")
        if pp in (2, -2):
            s = torch.linalg.svdvals(a)
            r = s[..., 0] / s[..., -1]
            return r if pp == 2 else 1.0 / r
        return (torch.linalg.matrix_norm(a, pp)
                * torch.linalg.matrix_norm(torch.linalg.inv(a), pp))
    return apply_op("cond", fn, [_t(x)])


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factorization and its 1-based pivots (int32)
    [, zero infos]."""
    x = _t(x)

    def fn(a):
        lu_, piv = torch.linalg.lu_factor(a)
        return lu_, piv.to(torch.int32)
    out, piv = apply_op("lu", fn, [x], n_outputs=2)
    if get_infos:
        infos = Tensor._wrap(torch.zeros(tuple(x._value.shape[:-2]) or (1,),
                                         dtype=torch.int32,
                                         device=x._value.device))
        return out, piv, infos
    return out, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``lu()``'s outputs -> P, L, U with ``x = P @ L @ U``."""
    return apply_op("lu_unpack", lambda lu_, piv: tuple(
        torch.lu_unpack(lu_, piv)), [_t(x), _t(y)], n_outputs=3)
