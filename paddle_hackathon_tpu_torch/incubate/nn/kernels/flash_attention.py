"""Flash attention over ``(batch*heads, seq, head_dim)`` tensors: the port
of the JAX package's ``incubate/nn/kernels/flash_attention.py`` (kernels
K2), and what the packed kernels share with it.

- ``_block_sizes`` / :func:`supported`: the JAX shape gate (without its
  autotune cache).  Callers dispatch on it exactly as the JAX package
  does; it is not the CUDA kernels' tile size.
- :func:`dropout_keep`: the positional-hash dropout mask, bit for bit.
- :func:`flash_fwd_ref` / :func:`flash_bwd_pair_ref`: the plain versions,
  on whole score matrices, with the JAX kernels' rounding points and mask.
  CPU tensors take them.  A float64 input runs them in float64 (the
  reference of the f32 kernels on the card).
- :func:`flash_fwd_kernel`, :func:`flash_dkdv_kernel`,
  :func:`flash_dq_kernel`: the wrappers of the three Hopper kernels in
  ``csrc/flash_attention.cu``.  A CUDA tensor launches them or raises;
  there is no fallback to the plain version on the card.
- ``_fwd`` (O and LSE), ``_bwd_pair`` (dq, dk, dv of one q-chunk x
  kv-chunk pair, given the global LSE and Δ: the unit of ring attention)
  and ``_bwd``, with the JAX names and signatures; each takes the kernels
  on CUDA and the plain versions on the CPU.
- :class:`FlashAttentionBHD` (``torch.autograd.Function``) and
  :func:`flash_attention_bhd`, the counterpart of the JAX ``custom_vjp``
  function.

The LSE is ``(B*H, sq)`` f32 (the JAX kernels keep it as ``(B*H, 8, sq)``
for the TPU's sublanes).  Causal masking is top-left aligned
(``q_pos >= k_pos``, both from 0) also when ``sq != skv``.  ``seed`` is a
``(1,)`` int32 tensor on the input's device (or an int), read only when
``dropout_p > 0``.  The wrappers raise ``NotImplementedError`` for what
the CUDA kernels do not cover and ``RuntimeError`` for a tensor they
cannot take, never ``ValueError``: that is the gate's signal, on which
``scaled_dot_product_attention`` takes its plain path.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30  # large-but-finite: keeps exp()=0 without inf-inf NaNs

_BLOCK_CANDIDATES = (1024, 512, 256, 128, 64, 32, 16, 8)
MAX_HEAD_DIM = 256   # the CUDA kernels' widest instance
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the last reset, one count per kernel (the smoke
# run reads them to prove the train step went through the kernels)
launches = {"fwd": 0, "dkdv": 0, "dq": 0}


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


def _seed_int(seed) -> int:
    if seed is None:
        return 0
    return int(seed.reshape(-1)[0]) if isinstance(seed, torch.Tensor) \
        else int(seed)


_zero_seeds = {}


def _seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` as a (1,) int32 tensor on ``device``; made by fill kernels
    (no host copy), so a launch can be captured into a CUDA graph."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(1)
    if seed is None:
        if device not in _zero_seeds:
            _zero_seeds[device] = torch.zeros(1, dtype=torch.int32,
                                              device=device)
        return _zero_seeds[device]
    return torch.full((1,), int(seed), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def _acc(dtype) -> torch.dtype:
    """The type the plain versions sum in: f64 for f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _causal(sq, skv, device) -> torch.Tensor:
    """Top-left aligned: query i sees keys 0..i."""
    return torch.ones(sq, skv, dtype=torch.bool, device=device).tril()


def _drop_mask(bh, sq, skv, seed, dropout_p, device) -> torch.Tensor:
    """The kernels' (bh, sq, skv) keep mask."""
    return dropout_keep(_seed_int(seed),
                        torch.arange(bh, device=device)[:, None, None],
                        torch.arange(sq, device=device)[:, None],
                        torch.arange(skv, device=device)[None, :],
                        1.0 - dropout_p)


def flash_fwd_ref(q, k, v, causal, sm_scale, dropout_p=0.0, seed=None):
    """Plain forward: ``(o (bh, sq, D) in q's dtype, lse (bh, sq))``.
    Scores ``(q . k^T) * sm_scale`` and the softmax in f32 (f64 for f64),
    masked scores at -1e30 before the max, ``l`` over the undropped p, the
    dropped p rounded to q's dtype before P.V, as in the kernel."""
    dt, acc = q.dtype, _acc(q.dtype)
    bh, sq, _ = q.shape
    skv = k.shape[1]
    sc = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) * sm_scale
    if causal:
        mask = _causal(sq, skv, q.device)
        sc = sc.masked_fill(~mask, _NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    if dropout_p > 0.0:
        keep = _drop_mask(bh, sq, skv, seed, dropout_p, q.device)
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    o = torch.einsum("bqk,bkd->bqd", p.to(dt).to(acc), v.to(acc))
    out = (o / torch.where(l == 0.0, 1.0, l)).to(dt)
    lse = (m + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return out, lse


def flash_bwd_pair_ref(q, k, v, do, lse, delta_row, causal, sm_scale,
                       dropout_p=0.0, seed=None):
    """Plain backward of one q-chunk x kv-chunk pair: ``(dq, dk, dv)`` in
    q's dtype, from the global ``lse`` and ``delta_row`` (bh, sq).  P from
    the LSE; dV from the dropped P; dS = P (dP - Δ) sm_scale from the
    undropped P and the dropped dP, rounded to q's dtype before dS^T.q and
    dS.k, as in the kernels."""
    dt, acc = q.dtype, _acc(q.dtype)
    bh, sq, _ = q.shape
    skv = k.shape[1]
    qa, ka, doa = q.to(acc), k.to(acc), do.to(acc)
    sc = torch.einsum("bqd,bkd->bqk", qa, ka) * sm_scale
    p = torch.exp(sc - lse.to(acc)[..., None])
    if causal:
        p = p.masked_fill(~_causal(sq, skv, q.device), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", doa, v.to(acc))
    pv = p
    if dropout_p > 0.0:
        keep = _drop_mask(bh, sq, skv, seed, dropout_p, q.device)
        pv = torch.where(keep, p / (1.0 - dropout_p), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout_p), 0.0)
    dv = torch.einsum("bqk,bqd->bkd", pv.to(dt).to(acc), doa)
    ds = (p * (dp - delta_row.to(acc)[..., None]) * sm_scale).to(dt).to(acc)
    dk = torch.einsum("bqk,bqd->bkd", ds, qa)
    dq = torch.einsum("bqk,bkd->bqd", ds, ka)
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ---------------------------------------------------------------------------
# The Hopper kernels
# ---------------------------------------------------------------------------

_fns = {}


def _lib(head_dim, dtype):
    """The three C entry points of the library of ``head_dim``'s padded
    width (64, 128 or 256) and ``dtype``'s family (f32, or bf16/f16),
    built and bound at first use."""
    from ._build import load, padded_width
    key = (padded_width(head_dim), "f32" if dtype == torch.float32 else "h")
    if key not in _fns:
        lib = load("flash_attention_w{}_{}".format(*key))
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ci, ci, ci, ci, ci, cf, ci, cf, ci, vp]
        lib.flash_bhd_fwd.argtypes = [ci] + [vp] * 6 + tail
        lib.flash_bhd_dkdv.argtypes = [ci] + [vp] * 9 + tail
        lib.flash_bhd_dq.argtypes = [ci] + [vp] * 8 + tail
        fns = _fns[key] = {}
        for name in ("fwd", "dkdv", "dq"):
            fn = getattr(lib, f"flash_bhd_{name}")
            fn.restype = ctypes.c_int
            fns[name] = fn
    return _fns[key]


def check_geometry(q_shape, kv_shape, dtype) -> None:
    """Raise unless the kernels take ``q`` of ``q_shape (bh, sq, D)`` and
    ``k, v`` of ``kv_shape (bh, skv, D)`` in ``dtype`` (a pure function of
    the shapes, which the CPU tests call): ``NotImplementedError`` for a
    dtype or head width the CUDA kernels do not cover (any D from 1 to
    256 is covered), ``RuntimeError`` for ranks, shapes or lengths the gate
    refuses."""
    if len(q_shape) != 3 or len(kv_shape) != 3 \
            or kv_shape[0] != q_shape[0] or kv_shape[2] != q_shape[2]:
        raise RuntimeError(f"q must be (bh, sq, D) and k, v (bh, skv, D), "
                           f"got {tuple(q_shape)}, {tuple(kv_shape)}")
    if dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"the bhd flash kernels take f32/bf16/f16, got {dtype}: ROADMAP "
            f"Queue 2")
    bh, sq, d = q_shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the bhd flash kernels take head widths up to {MAX_HEAD_DIM}, "
            f"got {d}: ROADMAP Queue 3")
    if not supported(sq, kv_shape[1]):
        raise RuntimeError(f"the bhd flash gate refuses seq ({sq}, "
                           f"{kv_shape[1]})")


def check_kernel_args(q, k, v, *others) -> None:
    """Raise unless the kernels take ``q (bh, sq, D)``, ``k, v (bh, skv,
    D)`` and the other tensors of a launch: :func:`check_geometry`, then
    ``RuntimeError`` for the device or the layout."""
    if q.device.type != "cuda":
        raise RuntimeError(f"the bhd flash kernels run on CUDA tensors, got "
                           f"{q.device}")
    if k.shape != v.shape:
        raise RuntimeError(f"k and v must have one shape, got "
                           f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"the bhd flash kernels take q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}: ROADMAP Queue 2")
    check_geometry(tuple(q.shape), tuple(k.shape), q.dtype)
    for t in (q, k, v) + others:
        if t.device != q.device:
            raise RuntimeError(f"tensor on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise RuntimeError("the bhd flash kernels take contiguous, "
                               "16-byte aligned tensors")


def _geo(q, k, causal, sm_scale, dropout_p):
    keep = 1.0 - dropout_p
    bh, sq, d = q.shape
    return (bh, sq, k.shape[1], d, int(bool(causal)), float(sm_scale),
            int(dropout_p > 0.0), keep, keep_threshold(keep))


def _launch(name, q, k, v, ptrs, causal, sm_scale, dropout_p):
    fn = _lib(q.shape[-1], q.dtype)[name]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), *ptrs,
                 *_geo(q, k, causal, sm_scale, dropout_p), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {name} kernel launch failed: "
                           f"CUDA error {err}")
    launches[name] += 1


def flash_fwd_kernel(q, k, v, causal, sm_scale, dropout_p=0.0, seed=None):
    """Launch the forward kernel on PyTorch's current stream; returns
    ``(out (bh, sq, D) in q's dtype, lse (bh, sq) f32)``."""
    check_kernel_args(q, k, v)
    bh, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    seed_t = _seed_tensor(seed, q.device)
    _launch("fwd", q, k, v, (out.data_ptr(), lse.data_ptr(),
                             seed_t.data_ptr()),
            causal, sm_scale, dropout_p)
    return out, lse


def _check_bwd(q, k, v, do, lse, delta_row):
    check_kernel_args(q, k, v, do, lse, delta_row)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise RuntimeError("do must be shaped and typed as q")
    for t in (lse, delta_row):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise RuntimeError("lse and delta_row must be (bh, sq) float32")


def flash_dkdv_kernel(q, k, v, do, lse, delta_row, causal, sm_scale,
                      dropout_p=0.0, seed=None):
    """Launch the dK/dV kernel; returns ``(dk, dv)`` (bh, skv, D)."""
    _check_bwd(q, k, v, do, lse, delta_row)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    seed_t = _seed_tensor(seed, q.device)
    _launch("dkdv", q, k, v, (do.data_ptr(), lse.data_ptr(),
                              delta_row.data_ptr(), seed_t.data_ptr(),
                              dk.data_ptr(), dv.data_ptr()),
            causal, sm_scale, dropout_p)
    return dk, dv


def flash_dq_kernel(q, k, v, do, lse, delta_row, causal, sm_scale,
                    dropout_p=0.0, seed=None):
    """Launch the dQ kernel; returns ``dq`` (bh, sq, D)."""
    _check_bwd(q, k, v, do, lse, delta_row)
    dq = torch.empty_like(q)
    seed_t = _seed_tensor(seed, q.device)
    _launch("dq", q, k, v, (do.data_ptr(), lse.data_ptr(),
                            delta_row.data_ptr(), seed_t.data_ptr(),
                            dq.data_ptr()),
            causal, sm_scale, dropout_p)
    return dq


# ---------------------------------------------------------------------------
# The JAX entry points
# ---------------------------------------------------------------------------

def _on_cpu(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise RuntimeError(f"flash_attention: unsupported device {x.device}")


def _fwd(q, k, v, causal, sm_scale, dropout_p=0.0, seed=None):
    """``(o, lse)``: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    fwd = flash_fwd_ref if _on_cpu(q) else flash_fwd_kernel
    return fwd(q, k, v, causal, sm_scale, dropout_p, seed)


def _bwd_pair(q, k, v, do, lse, delta_row, causal, sm_scale, dropout_p=0.0,
              seed=None):
    """``(dq, dk, dv)`` for one q-chunk x kv-chunk pair, given the *global*
    softmax statistics of the q rows: ``lse`` and ``delta_row = rowsum(dO *
    O_final)``, both (bh, sq).  The whole-sequence backward when the pair
    covers the full sequence, and the per-step unit of ring attention, where
    the same q rows pair with a rotating kv chunk: with the global lse and
    delta the per-pair gradients sum exactly to the full-attention
    gradient."""
    args = (q, k, v, do, lse, delta_row, causal, sm_scale, dropout_p, seed)
    if _on_cpu(q):
        return flash_bwd_pair_ref(*args)
    dk, dv = flash_dkdv_kernel(*args)
    return flash_dq_kernel(*args), dk, dv


def _bwd(causal, sm_scale, dropout_p, res, do):
    """Δ = rowsum(dO * O) in f32 (f64 for f64) in plain torch, as JAX
    computes it outside Pallas, then :func:`_bwd_pair`."""
    q, k, v, out, lse, seed = res
    acc = _acc(q.dtype)
    delta_row = (do.to(acc) * out.to(acc)).sum(-1)
    return _bwd_pair(q, k, v, do.contiguous(), lse, delta_row, causal,
                     sm_scale, dropout_p, seed)


class FlashAttentionBHD(torch.autograd.Function):
    """Forward and backward by device: the plain versions for CPU
    tensors, the Hopper kernels for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, dropout_p, seed):
        out, lse = _fwd(q, k, v, causal, sm_scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        causal, sm_scale, dropout_p, seed = ctx.args
        res = (*ctx.saved_tensors, seed)
        dq, dk, dv = _bwd(causal, sm_scale, dropout_p, res, do)
        return dq, dk, dv, None, None, None, None


def flash_attention_bhd(q, k, v, causal, sm_scale, dropout_p=0.0, seed=None):
    """Flash attention over (batch*heads, seq, head_dim) tensors.

    ``dropout_p`` drops attention probabilities inside the kernel (the
    mask is a positional hash of ``seed``, regenerated, never stored, in
    the backward).  ``seed`` is a (1,) int32 tensor or an int; required
    when ``dropout_p > 0``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionBHD.apply(q, k, v, bool(causal), float(sm_scale),
                                   float(dropout_p), seed)
