"""Quantization statistics (the JAX package's ``nn/quant/quant_layers.py``).

Only :func:`channel_absmax`, the per-channel statistic the weight-only
serving quantizer (``weight_only.py``) measures, is ported.  The QAT
fake-quantization layers (``FakeQuantAbsMax`` ... ``QuantizedLinear``)
wait for a later slice: ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import torch


def channel_absmax(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-channel absolute maximum over every other axis, in f32."""
    axis = axis % v.dim()
    other = tuple(i for i in range(v.dim()) if i != axis)
    # amax over an empty dim tuple would reduce every axis
    a = v.abs().amax(dim=other) if other else v.abs()
    return a.to(torch.float32)
