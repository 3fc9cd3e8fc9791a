"""Loss functionals (the JAX package's ``nn/functional/loss.py``): softmax
cross entropy.  The entry points take torch tensors or Paddle ``Tensor``s
(``core/tensor.takes_tensors``)."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...core.tensor import takes_tensors

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
