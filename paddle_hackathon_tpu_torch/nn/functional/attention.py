"""Attention functionals (the JAX package's ``nn/functional/attention.py``).

:func:`scaled_dot_product_attention` dispatches as the JAX package does:
the bhd flash kernels (K2, through ``incubate.nn.functional
.flash_attention_bshd``) where flash is asked for, there is no additive
mask and their gate takes the shape; else the plain softmax(QK^T)V
composition in PyTorch.
"""

from __future__ import annotations

import math

import torch

from ...core import flags
from ...core.random import default_generator
from ...core.tensor import takes_tensors
from ...incubate.nn.functional import flash_attention_bshd
from .common import promote

_NEG_INF = -1e30


@takes_tensors
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_flash=None, name=None):
    """SDPA over ``(batch, seq, heads, head_dim)`` tensors (paddle layout).

    Flash is asked for by ``use_flash`` when set, else by the
    ``use_fused_kernels`` flag at ``sq >= flash_attention_min_seqlen``.
    ``attn_mask`` is additive and broadcasts to ``(b, h, sq, skv)`` (an f32
    mask on bf16/f16 scores makes them, and the output, f32, as in JAX); causal
    masking is top-left aligned.  Dropout (``training`` only) drops the
    probabilities: inside the kernels by their positional hash, in the plain
    composition by the device's default generator."""
    if use_flash is None:   # auto: flash only at long sequences
        flash_ok = (flags.flag("use_fused_kernels") and query.shape[1]
                    >= flags.flag("flash_attention_min_seqlen"))
    else:
        flash_ok = use_flash
    if flash_ok and attn_mask is None:
        try:
            return flash_attention_bshd(query, key, value, causal=is_causal,
                                        dropout_p=dropout_p if training
                                        else 0.0)
        except ValueError:
            # the gate's signal that the kernels do not take these lengths:
            # a shape gate, not a fallback.  A kernel that fails to build
            # or to launch raises RuntimeError, which propagates.
            pass

    scale = 1.0 / math.sqrt(query.shape[-1])
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if is_causal:
        s, t = logits.shape[-2:]
        causal = torch.ones(s, t, dtype=torch.bool,
                            device=logits.device).tril()
        logits = logits.masked_fill(~causal, _NEG_INF)
    if attn_mask is not None:
        logits = logits + attn_mask
    probs = torch.softmax(logits, -1)
    if dropout_p > 0.0 and training:
        keep = torch.rand(probs.shape, device=probs.device,
                          generator=default_generator(probs.device)) \
            >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    if v.dtype != probs.dtype:
        # an f32 mask made bf16/f16 scores f32: the product is f32, as
        # jnp.einsum promotes it
        probs, v = promote(probs, v)
    return torch.einsum("bhst,bhtd->bhsd", probs, v).transpose(1, 2)


@takes_tensors
def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """``(n, maxlen)`` mask, 1 where the position is below the row's
    length; ``maxlen`` defaults to the longest length."""
    lengths = torch.as_tensor(lengths)
    n = maxlen or int(lengths.max())
    ar = torch.arange(n, device=lengths.device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return (ar[None, :] < lengths[:, None]).to(dt)
