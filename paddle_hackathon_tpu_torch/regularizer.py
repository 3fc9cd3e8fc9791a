"""``paddle.regularizer``: weight decay as a penalty the optimizer couples
into the gradient, re-exported from the optimizer module that reads the
coefficients."""

from .optimizer.optimizer import L1Decay, L2Decay

__all__ = ["L1Decay", "L2Decay"]
