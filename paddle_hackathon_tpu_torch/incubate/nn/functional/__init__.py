"""Fused functionals (the JAX package's ``incubate/nn/functional/``): the
flash-attention entry points.  ``flash_attention_bshd`` and
``flash_attention`` run the bhd kernels (K2) over paddle-layout
``(batch, seq, heads, head_dim)`` tensors; ``flash_attention_qkv_packed``
runs the packed kernels (K1) on GPT's fused qkv projection.  Each raises
``ValueError`` when its kernels' gate refuses the shape: the signal on
which callers take their plain path."""

from __future__ import annotations

import math

import torch

from ....core.random import default_generator
from ..kernels import flash_attention as _fa
from ..kernels import flash_attention_packed as _fap


def _draw_seed(device) -> torch.Tensor:
    """A (1,) int32 dropout seed from the default generator of ``device``
    (``core/random.py``), drawn on the device (no host copy)."""
    return torch.randint(-2**31, 2**31 - 1, (1,), dtype=torch.int32,
                         device=device, generator=default_generator(device))


def flash_attention_bshd(query, key, value, causal=False, sm_scale=None,
                         dropout_p=0.0, seed=None):
    """Flash attention over paddle-layout ``(batch, seq, heads, head_dim)``
    tensors; returns ``(batch, sq, heads, head_dim)``.

    The heads are moved next to the batch, ``(b, s, h, d) -> (b*h, s, d)``
    (so the dropout mask's head index is ``b*H + h``), and the bhd kernels
    run over them.  ``dropout_p`` drops attention probabilities inside the
    kernel; with no ``seed`` the int32 seed is drawn from the default
    generator of the query's device.  Raises ``ValueError`` before any
    launch when the gate (``flash_attention.supported``) refuses the
    sequence lengths."""
    b, sq, h, d = query.shape
    skv = key.shape[1]
    if not _fa.supported(sq, skv):
        raise ValueError(f"flash kernel unsupported for seq ({sq},{skv})")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if dropout_p and seed is None:
        seed = _draw_seed(query.device)

    def to_bhd(x, s):
        # at b == 1 (or h == 1) the reshape can return a strided view, not
        # a copy; the kernels take contiguous tensors only
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out = _fa.flash_attention_bhd(to_bhd(query, sq), to_bhd(key, skv),
                                  to_bhd(value, skv), causal, scale,
                                  float(dropout_p), seed)
    return out.reshape(b, h, sq, d).transpose(1, 2)


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
        seed = _draw_seed(qkv.device)
    return _fap.flash_attention_packed(qkv, num_heads, causal, scale,
                                       float(dropout_p), seed)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None):
    """The paddle.incubate ``flash_attention`` API: ``(out, None)``.  The
    kernels never materialise the softmax, so ``return_softmax`` must be
    False; ``name`` is paddle's operator name, unused."""
    if return_softmax:
        raise ValueError("the flash kernels never materialise the softmax: "
                         "return_softmax must be False")
    out = flash_attention_bshd(query, key, value, causal=causal,
                               dropout_p=dropout)
    return out, None


__all__ = ["flash_attention", "flash_attention_bshd",
           "flash_attention_qkv_packed"]
