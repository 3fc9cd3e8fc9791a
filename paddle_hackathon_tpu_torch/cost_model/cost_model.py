"""The analytic accounting behind the trainers' MFU gauge (the JAX
package's ``cost_model/cost_model.py:30-95``).

:func:`train_flops_per_token` is the PaLM-appendix ``6 N (+ 12 L h s)``
and :func:`device_peak_flops` the card's peak for its dense bf16 matmuls,
so ``Model.fit``'s ``train_mfu`` divides by one denominator.  The op-level
``CostModel`` and its bundled table of per-op times (``static_cost_data``)
are ROADMAP Queue 1 item 13: that table holds times measured on another
device, and calling them raises.
"""

from __future__ import annotations

import os

__all__ = ["CostModel", "train_flops_per_token", "device_peak_flops"]

_NOT_PORTED = "is not ported yet: ROADMAP Queue 1 item 13"


def train_flops_per_token(network, seqlen=None) -> float:
    """Analytic training FLOPs per token: ``6 * N`` (forward and backward,
    the PaLM MFU accounting; ``N`` counts each parameter once, a tied
    embedding once) plus the attention score/value term ``12 * L * h * s``
    when ``seqlen`` and a GPT-shaped ``network.config`` are known.  Host
    shape math only.  The port's GPT has no MoE layers (ROADMAP Queue 1
    item 11), so every parameter is active."""
    flops = 6.0 * float(sum(p.numel() for p in network.parameters()))
    cfg = getattr(network, "config", None)
    layers = getattr(cfg, "num_layers", None)
    hidden = getattr(cfg, "hidden_size", None)
    if seqlen and layers and hidden:
        # QK^T + AV are 4*L*h*s MACs/token fwd -> x3 for fwd+bwd
        flops += 12.0 * float(layers) * float(hidden) * float(seqlen)
    return flops


# The card's peak dense bf16 matmul FLOP/s by (lowercased) device name,
# substring match on torch.cuda.get_device_name(): the H100 SXM's
# 989 TFLOP/s (the vendor's dense, non-sparse figure).
_PEAK_FLOPS_BY_NAME = (
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
)


def device_peak_flops():
    """Peak FLOP/s of the current CUDA device for MFU accounting, or None
    when unknown (the MFU gauge is then left unset).  ``PHT_PEAK_FLOPS``
    overrides the table (a card held below its power limit, or a fixed
    denominator in a test)."""
    env = os.environ.get("PHT_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            import warnings
            warnings.warn(
                f"PHT_PEAK_FLOPS={env!r} is not a number; falling back "
                "to the device table", stacklevel=2)
    import torch
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name().lower()
    for key, peak in _PEAK_FLOPS_BY_NAME:
        if key in name:
            return peak
    return None


class CostModel:
    """The op-level cost model (ref ``python/paddle/cost_model``)."""

    def __init__(self):
        raise NotImplementedError(f"CostModel {_NOT_PORTED}")

    @staticmethod
    def static_cost_data():
        raise NotImplementedError(f"CostModel.static_cost_data {_NOT_PORTED}")
