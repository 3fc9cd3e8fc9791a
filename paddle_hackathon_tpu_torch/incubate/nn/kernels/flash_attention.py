"""The bhd flash-attention family (the JAX package's
``incubate/nn/kernels/flash_attention.py``): only what the packed kernels
and the GPT dispatch need yet.

- ``_NEG_INF``, the finite mask value shared with the packed kernels;
- the shape gate of the bhd kernels (``_block_sizes``/``supported``), so
  that ``models/gpt.py`` dispatches exactly as the JAX package does;
- :func:`dropout_keep`, the positional-hash dropout mask, bit for bit.

The bhd kernels themselves (K2: forward, dK/dV and dQ over
``(batch*heads, seq, head_dim)``) are not ported yet: ROADMAP Queue 2.
A caller that the JAX package would send to them raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # large-but-finite: keeps exp()=0 without inf-inf NaNs

_BLOCK_CANDIDATES = (1024, 512, 256, 128, 64, 32, 16, 8)


def _vmem_cap(dtype=torch.bfloat16) -> int:
    """The largest block edge the JAX kernels admit for ``dtype``."""
    return 1024 if torch.empty((), dtype=dtype).element_size() <= 2 else 512


def _block_sizes(sq: int, skv: int, dtype=torch.bfloat16):
    """(block_q, block_kv) of the bhd kernels, or None when no candidate
    edge divides the sequence lengths (the JAX default, without its
    autotune cache)."""
    cap = _vmem_cap(dtype)
    bq = next((b for b in _BLOCK_CANDIDATES
               if b <= min(sq, cap) and sq % b == 0), None)
    bkv = next((b for b in _BLOCK_CANDIDATES
                if b <= min(skv, cap) and skv % b == 0), None)
    if bq is None or bkv is None:
        return None
    return bq, bkv


def supported(sq: int, skv: int) -> bool:
    """Whether the bhd kernels take these sequence lengths."""
    return _block_sizes(sq, skv) is not None


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (two's
    complement wrap), still as int64."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def dropout_keep(seed, bh, q_pos, k_pos, keep_prob: float) -> torch.Tensor:
    """The JAX kernels' dropout mask: a murmur-style hash of (seed,
    batch*head, q position, k position), bit-exact with
    ``_dropout_keep``.  Arguments are int32 values (ints or tensors that
    broadcast); the arithmetic runs in int64 with an explicit 32-bit wrap
    after every product and sum, and ``>>`` is the arithmetic shift of
    the int32 value, as in JAX.  Returns a bool tensor."""
    t = lambda v: torch.as_tensor(v).to(torch.int64)  # noqa: E731
    h = _wrap32(t(seed) ^ _wrap32(t(bh) * -2048144789))      # 0x85EBCA6B
    h = _wrap32((h ^ (h >> 16)) * -1640531527)               # 0x9E3779B9
    h = _wrap32(h + _wrap32(t(q_pos) * -1028477387))         # 0xC2B2AE35
    h = _wrap32((h ^ (h >> 13)) * 668265261)                 # 0x27D4EB2D
    h = _wrap32(h + _wrap32(t(k_pos) * 461845907))           # 0x1B873593
    h = _wrap32((h ^ (h >> 16)) * -2048144789)
    h = h ^ (h >> 13)
    bits23 = h & 0x7FFFFF
    return bits23 < keep_threshold(keep_prob)


def keep_threshold(keep_prob: float) -> int:
    """The 23-bit keep threshold, computed in Python exactly as the JAX
    kernel computes it."""
    return int(keep_prob * float(0x800000))
