"""Gradient clipping (the JAX package's ``nn/clip.py``, after Paddle's
``fluid/clip.py``: ``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``).

A clip object maps a list of gradient tensors to a list of clipped ones
(``_clip``), which the optimizer runs in its update; ``__call__`` takes
Paddle's ``[(param, grad), ...]`` form.  The rounding points are the
reference's: norms in f32, each gradient scaled in f32 and cast back to
its dtype, and the global norm's per-tensor sums added in list order.
"""

from __future__ import annotations

import torch


class ClipGradBase:
    def _clip(self, grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        """``[(param, grad), ...]`` -> the same pairs with clipped grads."""
        clipped = self._clip([g for _, g in params_grads])
        return [(p, g) for (p, _), g in zip(params_grads, clipped)]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


def _sq_norm(g):
    g32 = g.float()
    return (g32 * g32).sum()


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradByNorm(ClipGradBase):
    """Each gradient alone scaled to a norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, grads):
        out = []
        for g in grads:
            norm = _sq_norm(g).sqrt()
            limit = torch.full_like(norm, self.clip_norm)
            scale = torch.where(norm > self.clip_norm,
                                limit / torch.clamp_min(norm, 1e-12), 1.0)
            out.append(_scaled(g, scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm over the whole list."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _clip(self, grads):
        if not grads:
            return grads
        global_norm = sum(_sq_norm(g) for g in grads).sqrt()
        limit = torch.full_like(global_norm, self.clip_norm)
        scale = limit / torch.clamp_min(global_norm, self.clip_norm)
        return [_scaled(g, scale) for g in grads]
