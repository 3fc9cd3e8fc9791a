"""Loss functionals (the JAX package's ``nn/functional/loss.py``): softmax
cross entropy with hard labels."""

from __future__ import annotations

import torch


def fused_softmax_ce_rows(logits, labels, axis=-1):
    """Per-row ``-log softmax(logits)[label]`` as f32: the logsumexp of the
    logits taken in f32, minus the gathered logit cast to f32."""
    lse = torch.logsumexp(logits.float(), dim=axis)
    tgt = logits.gather(axis, labels.long().unsqueeze(axis)) \
        .squeeze(axis).float()
    return lse - tgt


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over hard labels (``fused_softmax_ce_rows``);
    rows whose label is ``ignore_index`` count zero and, for ``"mean"``,
    are left out of the count.  The sums run in f32 and the result takes
    the logits' dtype.  ``reduction`` is ``"mean"``, ``"sum"`` or
    ``"none"``.  Soft labels, ``weight``, ``label_smoothing`` and
    ``use_softmax=False`` raise ``NotImplementedError`` (ROADMAP Queue 1
    item 3)."""
    if soft_label or weight is not None or label_smoothing or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: soft labels, class weights, label smoothing and "
            "use_softmax=False are not ported yet: ROADMAP Queue 1 item 3")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    lbl = label.long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(axis)
    mask = lbl != ignore_index
    loss = fused_softmax_ce_rows(input, torch.where(mask, lbl, 0), axis=axis)
    loss = torch.where(mask, loss, 0.0)
    out_dtype = input.dtype if input.dtype.is_floating_point else loss.dtype
    if reduction == "mean":
        return (loss.sum() / mask.sum().float().clamp_min(1.0)).to(out_dtype)
    if reduction == "sum":
        return loss.sum().to(out_dtype)
    return loss.to(out_dtype)
