"""Fused functionals (the JAX package's ``incubate/nn/functional/``): the
packed-qkv flash attention that GPT's attention layers call."""

from __future__ import annotations

import math

import torch

from ....core.random import default_generator
from ..kernels import flash_attention_packed as _fap


def flash_attention_qkv_packed(qkv, num_heads, causal=True, sm_scale=None,
                               dropout_p=0.0, seed=None):
    """Flash attention directly on the fused qkv projection output
    ``(b, s, 3*num_heads*head_dim)``; returns ``(b, s, num_heads*head_dim)``
    ready for the output projection.  Raises ``ValueError`` when the shape
    or dtype does not qualify (``flash_attention_packed.supported``).
    With ``dropout_p > 0`` and no ``seed``, the int32 seed is drawn from
    the default generator of qkv's device (``core/random.py``)."""
    b, s, hd3 = qkv.shape
    head_dim = hd3 // 3 // num_heads
    if not _fap.supported(s, s, num_heads, head_dim, qkv.dtype):
        raise ValueError(
            f"packed flash kernel unsupported for seq {s}, heads {num_heads}, "
            f"head_dim {head_dim}, dtype {qkv.dtype}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    if dropout_p and seed is None:
        seed = torch.randint(-2**31, 2**31 - 1, (1,), dtype=torch.int32,
                             device=qkv.device,
                             generator=default_generator(qkv.device))
    return _fap.flash_attention_packed(qkv, num_heads, causal, scale,
                                       float(dropout_p), seed)


__all__ = ["flash_attention_qkv_packed"]
