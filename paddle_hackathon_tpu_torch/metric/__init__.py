"""paddle.metric (the JAX package's ``metric/``; ref
``python/paddle/metric/metrics.py``).

``accuracy`` and ``Accuracy.compute`` work on torch tensors (a ``Tensor``,
a torch tensor or an array) on the predictions' device; the metrics'
accumulators are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, _to_numpy


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return _to_numpy(x)
    return np.asarray(x)


def _torch(x):
    if isinstance(x, Tensor):
        return x._value.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(x))


def _topk_hits(pred, label, k):
    """``(..., k)`` bool: whether each of the ``k`` largest predictions
    (in descending order) is the label."""
    idx = torch.argsort(-pred, dim=-1, stable=True)[..., :k]
    return idx == label.to(idx.device).long()[..., None]


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name


def accuracy(input, label, k=1):  # noqa: A002
    """Functional top-k accuracy (ref ``paddle.metric.accuracy``): a 0-d
    f32 ``Tensor`` on the predictions' device."""
    pred = _torch(input)
    lbl = _torch(label).reshape(-1)
    hits = _topk_hits(pred.reshape(len(lbl), -1), lbl, k)
    return Tensor._wrap(hits.any(dim=1).float().mean())


class Accuracy(Metric):
    def __init__(self, topk=(1,), name="acc"):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        """``(..., maxk)`` f32 hits of the top-k predictions, a ``Tensor``
        on the predictions' device."""
        pred = _torch(pred)
        lbl = _torch(label)
        if lbl.dim() == pred.dim() and lbl.shape[-1] == 1:
            lbl = lbl[..., 0]
        return Tensor._wrap(_topk_hits(pred, lbl, max(self.topk)).float())

    def update(self, correct):
        c = _np(correct)
        batch = c.reshape(-1, c.shape[-1])
        for i, k in enumerate(self.topk):
            self.total[i] += batch[:, :k].any(axis=1).sum()
            self.count[i] += batch.shape[0]
        return self.total[0] / max(self.count[0], 1)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        l = _np(labels).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)
