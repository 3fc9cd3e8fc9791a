"""Loss functionals (the JAX package's ``nn/functional/loss.py``).

The entry points take torch tensors or Paddle ``Tensor``s
(``core/tensor.takes_tensors``) and follow the JAX package's formulas
term for term.  ``margin_cross_entropy`` and ``class_center_sample``
compute on one device: their model-parallel ``group`` is ROADMAP Queue 1
item 12.  ``class_center_sample`` draws its negatives from the default
generator of the label's device, so it samples other classes than the
JAX package from the same seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ...core.random import default_generator
from ...core.tensor import takes_tensors

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "class_center_sample", "cosine_embedding_loss", "cross_entropy",
           "ctc_loss", "dice_loss", "fused_softmax_ce_rows",
           "hinge_embedding_loss", "hsigmoid_loss", "kl_div", "l1_loss",
           "log_loss", "margin_cross_entropy", "margin_ranking_loss",
           "mse_loss", "multi_label_soft_margin_loss", "nll_loss",
           "npair_loss", "sigmoid_focal_loss", "smooth_l1_loss",
           "soft_margin_loss", "softmax_with_cross_entropy",
           "square_error_cost", "triplet_margin_loss",
           "triplet_margin_with_distance_loss"]

# the f32 bytes of one chunk of rows: each f32 temporary of the loss (the
# cast logits, their shifted exponentials) stays near 256 MiB
_CHUNK_BYTES = 1 << 28


def _chunks(rows, vocab):
    step = max(1, _CHUNK_BYTES // (4 * vocab))
    return [slice(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)]


class _SoftmaxCERows(torch.autograd.Function):
    """``logsumexp(x.f32) - x[label].f32`` over the rows of a 2-D ``x``,
    without an f32 copy of ``x``: the forward takes the logsumexp a chunk
    of rows at a time and saves only ``x``, the labels and the f32
    logsumexp per row; the backward recomputes the softmax chunk by chunk.

    The gradient keeps the rounding points autograd gives the unchunked
    form: ``(g * exp(x.f32 - lse))`` cast to ``x``'s dtype, plus ``-g``
    cast to that dtype at each row's label, added in that dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        rows, vocab = logits.shape
        lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
        for sl in _chunks(rows, vocab):
            lse[sl] = torch.logsumexp(logits[sl].float(), dim=1)
        tgt = logits.gather(1, labels[:, None]).squeeze(1).float()
        ctx.save_for_backward(logits, labels, lse)
        return lse - tgt

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for sl in _chunks(*logits.shape):
            p = logits[sl].float() - lse[sl, None]
            grad[sl].copy_(g[sl, None] * p.exp_())
        idx = labels[:, None]
        grad.scatter_(1, idx, grad.gather(1, idx)
                      + (-g).to(logits.dtype)[:, None])
        return grad, None


@takes_tensors
def fused_softmax_ce_rows(logits, labels, axis=-1):
    """Per-row ``-log softmax(logits)[label]`` as f32: the logsumexp of the
    logits taken in f32, minus the gathered logit cast to f32.  No f32
    copy of the logits is made or kept for the backward (the JAX package
    leaves that to XLA's fusion); see :class:`_SoftmaxCERows`."""
    x = logits.movedim(axis, -1)
    out = _SoftmaxCERows.apply(x.reshape(-1, x.shape[-1]),
                               labels.long().reshape(-1))
    return out.reshape(x.shape[:-1])


@takes_tensors
def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy.

    Hard labels without smoothing take the fused rows
    (``fused_softmax_ce_rows``); soft labels, ``label_smoothing`` and
    ``use_softmax=False`` (the input already probabilities) take the
    log-probability matrix, as the JAX package's non-fused branch does.
    Hard labels: rows whose label is ``ignore_index`` count zero; the row
    losses and their sums are f32 and the result takes the logits' dtype;
    ``"mean"`` divides by the count of kept rows (at least 1), or with
    ``weight`` (a per-class vector) by the kept rows' weight sum (at least
    1e-12).  Soft labels (``label`` a distribution over ``axis``, smoothed
    towards uniform by ``label_smoothing``) reduce every row, with no
    ignore mask, in the log-probabilities' dtype.  ``reduction`` is
    ``"mean"``, ``"sum"`` or ``"none"``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    fused = use_softmax and not soft_label and label_smoothing == 0.0
    lp = None
    if not fused:
        lp = torch.log_softmax(input, dim=axis) if use_softmax else \
            torch.log(torch.clamp_min(input, 1e-30))
    if soft_label:
        tgt = label.to(lp.dtype)
        if label_smoothing > 0.0:
            tgt = tgt * (1 - label_smoothing) + \
                label_smoothing / lp.shape[axis]
        return _reduce_f32(-torch.sum(tgt * lp, dim=axis), reduction)
    lbl = label.long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(axis)
    mask = lbl != ignore_index
    safe = torch.where(mask, lbl, 0)
    if label_smoothing > 0.0:
        k = lp.shape[axis]
        onehot = torch.nn.functional.one_hot(safe, k).to(lp.dtype)
        onehot = onehot.movedim(-1, axis % input.dim())
        tgt = onehot * (1 - label_smoothing) + label_smoothing / k
        loss = -torch.sum(tgt * lp, dim=axis)
    elif fused:
        loss = fused_softmax_ce_rows(input, safe, axis=axis)
    else:
        loss = -lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(mask, loss.float(), 0.0)
    out_dtype = input.dtype if input.dtype.is_floating_point else loss.dtype
    if weight is not None:
        w = weight[safe]
        loss = loss * torch.where(mask, w, 0.0)
        if reduction == "mean":
            den = torch.where(mask, w.to(loss.dtype), 0.0).sum()
            return (loss.sum() / den.clamp_min(1e-12)).to(out_dtype)
    elif reduction == "mean":
        return (loss.sum() / mask.sum().float().clamp_min(1.0)).to(out_dtype)
    if reduction == "sum":
        return loss.sum().to(out_dtype)
    return loss.to(out_dtype)


def _reduce_f32(loss, reduction):
    """``mean`` / ``sum`` / ``none`` of the soft-label rows, the sum taken
    in f32 and returned in the rows' dtype."""
    if reduction == "mean":
        return loss.float().mean().to(loss.dtype)
    if reduction == "sum":
        return loss.float().sum().to(loss.dtype)
    return loss


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


@takes_tensors
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


@takes_tensors
def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    lbl = label.long()
    mask = lbl != ignore_index
    loss = -input.gather(1, torch.where(mask, lbl, 0).unsqueeze(1)) \
        .squeeze(1)
    loss = torch.where(mask, loss, 0.0)
    if weight is not None:
        w = weight[torch.clamp_min(lbl, 0)]
        loss = loss * torch.where(mask, w, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.where(mask, w, 0.0).sum() \
                .clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / mask.to(input.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


@takes_tensors
def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


@takes_tensors
def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


@takes_tensors
def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@takes_tensors
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    p = torch.clamp(input, 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@takes_tensors
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, y = logit, label
    # stable: max(z,0) - z*y + log(1+exp(-|z|))
    base = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        base = -(pos_weight * y * F.logsigmoid(z)
                 + (1 - y) * F.logsigmoid(-z))
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


@takes_tensors
def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    loss = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@takes_tensors
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    loss = torch.where(label == 1, input, torch.clamp_min(margin - input, 0.0))
    return _reduce(loss, reduction)


@takes_tensors
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    loss = torch.clamp_min(-label * (input - other) + margin, 0.0)
    return _reduce(loss, reduction)


@takes_tensors
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = torch.sum(input1 * input2, -1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0))
    return _reduce(loss, reduction)


@takes_tensors
def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2, epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.sum(torch.abs(a - b) ** p, -1) ** (1.0 / p)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


@takes_tensors
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss (ref ``warpctc_op``): the forward recursion in log space
    over time, ``log_probs`` in Paddle's ``(T, B, C)`` layout."""
    lp = log_probs
    T, B, _ = lp.shape
    S = labels.shape[1]
    ext = torch.full((B, 2 * S + 1), blank, dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = labels.long()
    neg_inf = torch.tensor(-1e30, dtype=lp.dtype, device=lp.device)
    alpha = torch.full((B, 2 * S + 1), -1e30, dtype=lp.dtype,
                       device=lp.device)
    alpha = torch.cat([lp[0, :, blank][:, None],
                       lp[0].gather(1, ext[:, 1:2]), alpha[:, 2:]], dim=1)
    same = torch.cat([torch.ones((B, 2), dtype=torch.bool, device=lp.device),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    in_len = input_lengths.to(lp.device)
    for t in range(1, T):
        shift1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], dim=1)
        a1 = torch.logaddexp(alpha, shift1)
        cand = torch.where(same, a1, torch.logaddexp(a1, shift2))
        new = cand + lp[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = 2 * label_lengths.long().to(lp.device)
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    loss = -torch.logaddexp(a_last, a_prev)
    if reduction == "mean":
        return torch.mean(loss / torch.clamp_min(
            label_lengths.to(device=lp.device, dtype=lp.dtype), 1.0))
    return _reduce(loss, reduction)


@takes_tensors
def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


@takes_tensors
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y = logit, label
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@takes_tensors
def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """Dice loss for segmentation (ref phi DiceLossKernel): ``label`` is
    integer class ids with a trailing dim of 1."""
    y1 = F.one_hot(label.long().squeeze(-1), input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.dim()))
    inter = torch.sum(input * y1, dim=red)
    union = torch.sum(input, dim=red) + torch.sum(y1, dim=red)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


@takes_tensors
def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    """Negative log loss of a binary probability (ref log_loss_op)."""
    return -label * torch.log(input + epsilon) - \
        (1.0 - label) * torch.log(1.0 - input + epsilon)


@takes_tensors
def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


@takes_tensors
def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    loss = -(label * F.logsigmoid(input)
             + (1 - label) * F.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(torch.mean(loss, dim=-1), reduction)


@takes_tensors
def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dfn = distance_function
    if dfn is None:
        def dfn(a, b):
            return torch.sqrt(torch.sum(torch.square(a - b), dim=-1))
    dp, dn = dfn(input, positive), dfn(input, negative)
    if swap:
        dn = torch.minimum(dn, dfn(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


@takes_tensors
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """N-pair loss: softmax CE over ``anchor @ positive.T`` with same-label
    targets, plus the L2 term."""
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, -1))
                    + torch.mean(torch.sum(positive * positive, -1))) * 0.25
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = same / torch.sum(same, -1, keepdim=True)
    ce = torch.mean(torch.sum(-tgt * torch.log_softmax(sim, -1), -1))
    return ce + reg


def _default_tree(num_classes, device):
    """The complete binary tree's (path_table, path_code) over
    ``num_classes`` leaves, padded with node id -1 (masked)."""
    code_len = max(int(math.ceil(math.log2(max(num_classes, 2)))), 1)
    tab, code = [], []
    for c in range(num_classes):
        node, bits = [], []
        idx = c + num_classes  # heap position of the leaf
        while idx > 1:
            parent = idx // 2
            node.append(parent - 1)      # internal node id
            bits.append(idx & 1)         # which child we are
            idx = parent
        node = node[::-1] + [-1] * (code_len - len(node))
        bits = bits[::-1] + [0] * (code_len - len(bits))
        tab.append(node[:code_len])
        code.append(bits[:code_len])
    return (torch.tensor(tab, dtype=torch.long, device=device),
            torch.tensor(code, dtype=torch.long, device=device))


@takes_tensors
def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss (ref phi HSigmoidLossKernel): the complete
    binary tree over ``num_classes`` leaves, or a custom tree through
    ``path_table`` (node ids per step) and ``path_code`` (0/1 per step)."""
    if path_table is None:
        path_table, path_code = _default_tree(num_classes, input.device)
    y = label.reshape(-1).long()
    nodes = path_table.long()[y]                  # (B, L) internal node ids
    valid = (nodes >= 0).to(input.dtype)          # padded steps count 0
    nodes = torch.clamp_min(nodes, 0)
    bits = path_code[y].to(input.dtype)           # (B, L) 0/1
    logits = torch.einsum("bld,bd->bl", weight[nodes], input)
    if bias is not None:
        logits = logits + bias.reshape(-1)[nodes]
    sgn = 2.0 * bits - 1.0
    return torch.mean(-torch.sum(F.logsigmoid(sgn * logits) * valid, -1))


def _check_group(group, fn):
    if group is not None and group is not False:
        raise NotImplementedError(f"{fn} over a model-parallel group "
                                  f"{_DISTRIBUTED}")


@takes_tensors
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace/CosFace-style margin softmax CE (ref
    ``operators/margin_cross_entropy_op.cu``): ``logits`` are cosines; the
    target class's becomes ``cos(m1 * theta + m2) - m3``, then all are
    scaled.  One device only (``group`` raises)."""
    _check_group(group, "margin_cross_entropy")
    y = label.reshape(-1).long()
    onehot = F.one_hot(y, logits.shape[-1]).to(logits.dtype)
    theta = torch.arccos(torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7))
    tgt = torch.cos(margin1 * theta + margin2) - margin3
    out = torch.where(onehot > 0, tgt, logits) * scale
    logp = torch.log_softmax(out, -1)
    loss = _reduce(-torch.sum(onehot * logp, -1), reduction)
    return (loss, torch.exp(logp)) if return_softmax else loss


@takes_tensors
def class_center_sample(label, num_classes, num_samples, group=None):
    """Sample class centers (ref class_center_sample_op): returns
    ``(remapped_label, sampled_class_indices)``.  Every positive class is
    kept; negatives fill up to ``num_samples`` in a random order from the
    label device's default generator.  One device only (``group``
    raises)."""
    _check_group(group, "class_center_sample")
    with torch.no_grad():
        y = label.reshape(-1).long()
        pos = torch.unique(y)
        gen = default_generator(y.device)
        perm = torch.randperm(num_classes, generator=gen,
                              device=gen.device).to(y.device)
        ispos = torch.isin(perm, pos)
        order = torch.argsort((~ispos).to(torch.int8), stable=True)
        sampled = torch.sort(perm[order][:num_samples]).values
        remap = torch.searchsorted(sampled, y)
        return (remap.reshape(label.shape).to(label.dtype),
                sampled.to(label.dtype))
