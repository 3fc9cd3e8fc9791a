"""Common functionals (the JAX package's ``nn/functional/common.py``):
linear, the dropout family, embedding, one_hot, normalize, pad, resize,
pixel and channel shuffles, unfold/fold, the sampling grids, bilinear,
diag_embed, temporal_shift, gather_tree and sparse_attention.

Torch compositions with the JAX package's formulas; the entry points take
torch tensors or Paddle ``Tensor``s (``core/tensor.takes_tensors``).
Where the JAX package departs from Paddle the port follows it (ROADMAP,
faults in the reference):

- :func:`interpolate` is ``jax.image.resize``: half-pixel centres, the
  separable scale-and-translate weights (a triangle for the linear modes,
  Keys' cubic with a = -0.5 for ``"bicubic"``), an antialiasing filter
  when it shrinks a dim, ``"area"`` as linear, and ``align_corners`` /
  ``align_mode`` ignored.  It is written here with those weights, not
  with ``torch.nn.functional.interpolate``, which differs on each point.
- ``dropout(mode="downscale_in_infer")`` returns ``x`` unscaled at
  inference.

The masks are drawn from the default generator of the input's device
(``core/random.py``).  A matrix product of two floating types promotes
both to their common type, as ``jnp.matmul`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as _F

from ...core.random import default_generator
from ...core.tensor import takes_tensors

__all__ = ["affine_grid", "alpha_dropout", "bilinear", "channel_shuffle",
           "cosine_similarity", "diag_embed", "dropout", "dropout2d",
           "dropout3d", "embedding", "fold", "gather_tree", "grid_sample",
           "interpolate", "label_smooth", "linear", "normalize", "one_hot",
           "pad", "pixel_shuffle", "pixel_unshuffle", "sparse_attention",
           "temporal_shift", "unfold", "upsample", "zeropad2d"]


def promote(*xs):
    """The tensors (None passes through) cast to their common type where
    they differ (a bf16 activation and an f32 weight meet in f32, as in
    JAX)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        if x is not None:
            dt = torch.promote_types(dt, x.dtype)
    return tuple(x if x is None or x.dtype == dt else x.to(dt) for x in xs)


@takes_tensors
def linear(x, weight, bias=None, name=None):
    """``y = x @ W + b`` with ``W`` of shape ``(in, out)``, matmul then
    add (not ``addmm``, which rounds the sum differently)."""
    if x.dtype != weight.dtype:
        x, weight = promote(x, weight)
    y = x @ weight
    return y if bias is None else y + bias


def _keep(shape, p, device):
    """The keep mask: ``rand >= p`` from the device's default generator
    (the draw ``Dropout`` has always made)."""
    return torch.rand(shape, generator=default_generator(device),
                      device=device) >= p


@takes_tensors
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout.  ``axis`` (an int or a list) draws one mask entry per
    index of those dims, broadcast over the others.  ``"upscale_in_train"``
    scales kept entries by ``1 / (1 - p)`` in training;
    ``"downscale_in_infer"`` keeps them unscaled.  At inference (or
    ``p == 0``) ``x`` comes back as it is, in either mode."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be upscale_in_train or "
                         f"downscale_in_infer, got {mode!r}")
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = x.shape
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = _keep(shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@takes_tensors
def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped entries take ``-alpha * scale``, then an
    affine map restores the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _keep(x.shape, p, x.device)
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


@takes_tensors
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; rows looked up at ``padding_idx`` come
    out zero (the index is compared as given, as in JAX).  ``sparse`` has
    no effect."""
    out = _F.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


@takes_tensors
def one_hot(x, num_classes, name=None):
    """f32 one-hot rows; an index outside ``[0, num_classes)`` gives a
    zero row (``jax.nn.one_hot``)."""
    ar = torch.arange(num_classes, device=x.device)
    return (x[..., None] == ar).to(torch.float32)


@takes_tensors
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@takes_tensors
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    if p == 2:
        n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


@takes_tensors
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    na = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    nb = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(na * nb, eps)


@takes_tensors
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """``ops.pad``: every dim, or the trailing spatial dims of
    ``data_format`` (Paddle's order)."""
    from ...ops.manipulation import pad as _pad_op
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    return _pad_op(x, pad, mode=mode, value=value,
                   data_format=data_format)._value


# -- resize (jax.image.resize) ------------------------------------------------

def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 on ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(out), out)


def _weight_mat(m, n, kernel, antialias, device):
    """The (m, n) weights that map a dim of ``m`` samples to ``n``:
    ``jax.image``'s ``compute_weight_mat`` at scale n / m, translation 0,
    in f32."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = (torch.abs(sample_f[None, :]
                   - torch.arange(m, dtype=torch.float32,
                                  device=device)[:, None]) / kernel_scale)
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(v, out_shape, method):
    """``jax.image.resize(v, out_shape, method)`` with its defaults
    (``antialias=True``)."""
    dims = [d for d in range(v.dim()) if v.shape[d] != out_shape[d]]
    if method == "nearest":
        for d in dims:
            m, n = v.shape[d], out_shape[d]
            off = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=v.device) + 0.5)
                              * m / n).to(torch.long)
            v = v.index_select(d, off)
        return v
    if not (v.dtype.is_floating_point or v.dtype.is_complex):
        v = v.to(torch.float32)
    kernel = _triangle if method == "linear" else _keys_cubic
    for d in dims:
        w = _weight_mat(v.shape[d], out_shape[d], kernel, True,
                        v.device).to(v.dtype)
        v = torch.movedim(torch.tensordot(v, w, dims=([d], [0])), -1, d)
    return v


_RESIZE_METHODS = {"nearest": "nearest", "bilinear": "linear",
                   "linear": "linear", "bicubic": "cubic",
                   "trilinear": "linear", "area": "linear"}


@takes_tensors
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims of ``data_format`` to ``size`` (or each
    ``int(dim * scale_factor)``), as ``jax.image.resize`` does (see the
    module's docstring): ``align_corners`` and ``align_mode`` are
    ignored."""
    nd = x.dim()
    channel_last = data_format[-1] == "C"
    spatial = list(range(1, nd - 1)) if channel_last else list(range(2, nd))
    in_sizes = [x.shape[i] for i in spatial]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_sizes = [int(s) for s in size]
    else:
        if isinstance(scale_factor, torch.Tensor):
            scale_factor = scale_factor.tolist()
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        out_sizes = [int(s * f) for s, f in zip(in_sizes, scale_factor)]
    full = list(x.shape)
    for dim, s in zip(spatial, out_sizes):
        full[dim] = s
    return _resize(x, full, _RESIZE_METHODS[mode])


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@takes_tensors
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


@takes_tensors
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    v = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h // r, w // r, c * r * r)


@takes_tensors
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, groups, c // groups, h, w)
        return v.permute(0, 2, 1, 3, 4).reshape(n, c, h, w)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, groups, c // groups)
    return v.permute(0, 1, 2, 4, 3).reshape(n, h, w, c)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _paddings(paddings):
    """(top, bottom, left, right) from an int, a pair or four values."""
    p = _pair(paddings) if isinstance(paddings, int) or len(paddings) == 2 \
        else tuple(paddings)
    if len(p) == 2:
        return p[0], p[0], p[1], p[1]
    return tuple(p)


@takes_tensors
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``(n, c * kh * kw, oh * ow)``, channel-major, after padding
    ``(top, bottom, left, right)``."""
    pt, pb, pl, pr = _paddings(paddings)
    v = _F.pad(x, (pl, pr, pt, pb))
    return _F.unfold(v, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))


@takes_tensors
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold` (overlaps summed): fold onto
    the padded image, then crop the padding."""
    oh, ow = _pair(output_sizes)
    pt, pb, pl, pr = _paddings(paddings)
    img = _F.fold(x, (oh + pt + pb, ow + pl + pr), _pair(kernel_sizes),
                  dilation=_pair(dilations), stride=_pair(strides))
    return img[:, :, pt:pt + oh, pl:pl + ow]


@takes_tensors
def affine_grid(theta, out_shape, align_corners=True, name=None):
    n = theta.shape[0]
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = out_shape
    kw = dict(dtype=theta.dtype, device=theta.device)
    ys = torch.linspace(-1, 1, h, **kw) if align_corners else \
        (torch.arange(h, **kw) * 2 + 1) / h - 1
    xs = torch.linspace(-1, 1, w, **kw) if align_corners else \
        (torch.arange(w, **kw) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(1, h * w, 3)
    return (base @ theta.transpose(1, 2)).reshape(n, h, w, 2)


def _sample(v, yy, xx):
    """``v[b, :, yy, xx]`` (zero outside the image) as (n, c, ho, wo)."""
    n, c, h, w = v.shape
    valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    xc = torch.clamp(xx, 0, w - 1).to(torch.long)
    yc = torch.clamp(yy, 0, h - 1).to(torch.long)
    bi = torch.arange(n, device=v.device)[:, None, None]
    vals = v.permute(0, 2, 3, 1)[bi, yc, xc].permute(0, 3, 1, 2)
    return torch.where(valid[:, None], vals, torch.zeros_like(vals))


@takes_tensors
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` (n, c, h, w) at ``grid`` (n, ho, wo, 2) in [-1, 1]:
    bilinear or nearest (rounded half to even), zero outside the image
    (``padding_mode`` is not read, as in JAX)."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1) * (w - 1) / 2
        iy = (gy + 1) * (h - 1) / 2
    else:
        ix = ((gx + 1) * w - 1) / 2
        iy = ((gy + 1) * h - 1) / 2
    if mode == "nearest":
        return _sample(x, torch.round(iy), torch.round(ix))
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1, y0 + 1
    wa = ((x1 - ix) * (y1 - iy))[:, None]
    wb = ((x1 - ix) * (iy - y0))[:, None]
    wc = ((ix - x0) * (y1 - iy))[:, None]
    wd = ((ix - x0) * (iy - y0))[:, None]
    return (_sample(x, y0, x0) * wa + _sample(x, y1, x0) * wb
            + _sample(x, y0, x1) * wc + _sample(x, y1, x1) * wd)


@takes_tensors
def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bm,omn,bn->bo", x1, weight, x2)
    return out if bias is None else out + bias


@takes_tensors
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    """Batch diagonal embed: the last dim of ``input`` on the ``offset``
    diagonal of new trailing (n, n) matrices, moved to ``(dim1, dim2)``."""
    v = input
    n = v.shape[-1] + abs(offset)
    i = torch.arange(v.shape[-1], device=v.device)
    r = i + max(-offset, 0)
    c = i + max(offset, 0)
    out = v.new_zeros(tuple(v.shape[:-1]) + (n, n))
    out[..., r, c] = v
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    perm = [ax for ax in range(nd) if ax not in (nd - 2, nd - 1)]
    for pos, src in sorted([(d1, nd - 2), (d2, nd - 1)]):
        perm.insert(pos, src)
    return out.permute(perm)


@takes_tensors
def zeropad2d(x, padding, data_format="NCHW", name=None):
    if isinstance(padding, torch.Tensor):
        padding = padding.tolist()
    l, r, top, bot = list(padding)
    if data_format == "NCHW":
        return _F.pad(x, (l, r, top, bot))
    return _F.pad(x, (0, 0, l, r, top, bot))


@takes_tensors
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """Temporal Shift Module: a fraction of the channels shifted one
    segment back, the next fraction one forward, zero-filled."""
    v = torch.movedim(x, -1, 1) if data_format == "NHWC" else x
    nt, c, h, w = v.shape
    v5 = v.reshape(nt // seg_num, seg_num, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    back = _F.pad(v5[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    fwd = _F.pad(v5[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([back, fwd, v5[:, :, c2:]], 2).reshape(nt, c, h, w)
    return torch.movedim(out, 1, -1) if data_format == "NHWC" else out


@takes_tensors
def gather_tree(ids, parents):
    """Beam-search backtrace over (max_time, batch, beam) int tensors:
    walk the parent pointers from the last step back, emitting the full
    id sequence of every final beam."""
    t_len, b, w = ids.shape
    beams = torch.arange(w, dtype=parents.dtype,
                         device=parents.device).expand(b, w)
    outs = []
    with torch.no_grad():
        for t in range(t_len - 1, -1, -1):
            outs.append(torch.gather(ids[t], 1, beams.long()))
            beams = torch.gather(parents[t], 1, beams.long())
    return torch.stack(outs[::-1])


@takes_tensors
def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over (b, h, s, d) restricted to a CSR pattern: dense
    scores with the pairs outside the pattern at -1e30 (the masks are not
    read, as in JAX)."""
    b, h, s, d = query.shape
    logits = torch.einsum("bhsd,bhtd->bhst", query, key) / (d ** 0.5)
    cols = sparse_csr_columns.long()
    offset = sparse_csr_offset.contiguous()
    pos = torch.arange(cols.shape[-1], dtype=offset.dtype,
                       device=cols.device).expand(b, h, cols.shape[-1])
    pos = pos.contiguous()
    row = torch.clamp(torch.searchsorted(offset, pos, right=True) - 1,
                      0, s - 1)
    mask = torch.zeros(b, h, s, s, dtype=torch.bool, device=query.device)
    bi = torch.arange(b, device=cols.device)[:, None, None]
    hi = torch.arange(h, device=cols.device)[None, :, None]
    mask[bi, hi, row, cols] = True
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, -1), value)
