"""Packed-heads flash attention: the port of the JAX package's
``incubate/nn/kernels/flash_attention_packed.py`` (kernels K1).

Attention is read straight from the fused qkv projection ``(b, s, 3*H*D)``
and written as ``(b, s, H*D)``, ready for the output projection; no head
split or transpose exists in device memory.

- :func:`_plan` / :func:`supported`: the JAX package's shape gate, copied
  in logic (without its autotune cache), so that the GPT dispatch takes
  this path exactly where JAX does.
- :func:`flash_packed_fwd_ref` / :func:`flash_packed_bwd_ref`: the plain
  versions, on whole ``(s, s)`` score matrices, with the JAX kernels'
  rounding points and dropout mask.  CPU tensors take them.
- :func:`flash_packed_fwd_kernel`, :func:`flash_packed_dkdv_kernel`,
  :func:`flash_packed_dq_kernel`: the wrappers of the three Hopper kernels
  in ``csrc/flash_attention_packed.cu`` (forward; dK/dV; dQ).  A CUDA
  tensor launches them or raises; there is no fallback to the plain
  version on the card.  They take any length: the JAX gate is the
  dispatchers' (``supported``), the wrappers check what the kernels take.
- :func:`scale_folds`: whether the kernels apply ``sm_scale`` to their
  f32 products instead of rewriting the q and k tiles.
- :func:`check_geometry`: the head widths and types the kernels take (a
  pure function of the shape, which the CPU tests call), and
  :func:`check_kernel_args`, which adds the device and layout checks.
- :class:`FlashAttentionPacked` (``torch.autograd.Function``) and
  :func:`flash_attention_packed`, the counterpart of the JAX
  ``custom_vjp`` function.

The LSE is ``(b, H, s)`` f32 (the JAX kernels keep it as ``(b, H, 8, s)``
for the TPU's sublanes).  ``seed`` is a ``(1,)`` int32 tensor on the
input's device (or an int), read only when ``dropout_p > 0``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import (_NEG_INF, _seed_int, _seed_tensor,
                              dropout_keep, keep_threshold)

_LANES = 128
# The JAX estimator's scoped-VMEM budget: part of the gate, kept so that
# supported() answers as the JAX package does.
_VMEM_BUDGET = 13 * 2**20
MAX_HEAD_DIM = 256   # the CUDA kernels' widest instance
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the last reset, one count per kernel (the smoke
# run reads them to prove the train step went through the kernels)
launches = {"fwd": 0, "dkdv": 0, "dq": 0}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _plan(sq, skv, heads, head_dim, dtype=torch.bfloat16):
    """(block_q, block_kv, group) of the JAX kernels, or None: the largest
    block edge that divides both lengths, then the largest head group
    whose worst-case cell fits the JAX budget."""
    isz = _itemsize(dtype)

    def est(b, g):
        gd = g * head_dim
        return (2 * 4 * b * gd * isz + 2 * 2 * b * gd * isz
                + 2 * g * b * head_dim * 4 + 2 * b * b * 4)

    groups = [g for g in range(heads, 0, -1) if heads % g == 0
              and (g * head_dim) % _LANES == 0]
    for b in (512, 256, 128, 64, 32, 16, 8):
        if sq % b or skv % b or b > sq or b > skv:
            continue
        for g in groups:
            if est(b, g) <= _VMEM_BUDGET:
                return (b, b, g)
    return None


def supported(sq, skv, heads, head_dim, dtype) -> bool:
    """The JAX gate: bf16/f16 only, D a multiple of 8, and a plan."""
    if head_dim % 8 != 0:
        return False
    if _itemsize(dtype) > 2:
        return False
    return _plan(sq, skv, heads, head_dim, dtype) is not None


def scale_folds(dtype, sm_scale) -> bool:
    """True where the kernels may apply ``sm_scale`` to their f32 products
    (S, dK, dQ) and read q and k unscaled: bf16 and a rounded scale that is
    a power of two (``1/sqrt(D)`` at D = 16, 64 and 256).  Then
    ``(q * scale).to(bf16)`` is ``q * scale`` (bf16 has f32's exponent
    range; only results below its smallest normal, 2**-126, could round),
    and a power of two commutes with every rounding of an f32 sum.  f16's
    exponent range is narrow, so f16 always scales the tiles."""
    if dtype != torch.bfloat16:
        return False
    r = float(torch.tensor(sm_scale, dtype=dtype))
    return r > 0.0 and math.frexp(r)[0] == 0.5


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, s, H*D) -> (b, H, s, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def _split(qkv: torch.Tensor, heads: int):
    hd = qkv.shape[-1] // 3
    return (_heads(qkv[..., :hd], heads), _heads(qkv[..., hd:2 * hd], heads),
            _heads(qkv[..., 2 * hd:], heads))


def _drop_mask(b, heads, s, seed, dropout_p, device) -> torch.Tensor:
    """The kernels' (b, H, s_q, s_k) keep mask."""
    bh = torch.arange(b * heads, device=device).reshape(b, heads, 1, 1)
    pos = torch.arange(s, device=device)
    return dropout_keep(_seed_int(seed), bh, pos[:, None], pos[None, :],
                        1.0 - dropout_p)


def _causal(s, device) -> torch.Tensor:
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def flash_packed_fwd_ref(qkv, heads, causal, sm_scale, dropout_p=0.0,
                         seed=None):
    """Plain forward: ``(out (b, s, H*D) in qkv's dtype, lse (b, H, s)
    f32)``.  q is scaled in qkv's dtype, scores and softmax in f32, the
    causal mask at -1e30 before the max, ``l`` over the undropped p, and
    the dropped p rounded to qkv's dtype before P.V, as in the kernel."""
    dt = qkv.dtype
    q, k, v = _split(qkv, heads)
    b, H, s, D = q.shape
    qs = q * torch.tensor(sm_scale, dtype=dt)
    sc = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    if causal:
        mask = _causal(s, qkv.device)
        sc = sc.masked_fill(~mask, _NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    if dropout_p > 0.0:
        keep = _drop_mask(b, H, s, seed, dropout_p, qkv.device)
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(dt).float(), v.float())
    l = torch.where(l == 0.0, 1.0, l)
    out = (o / l).to(dt).transpose(1, 2).reshape(b, s, H * D)
    lse = (m + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return out, lse


def _delta(out, dout, heads) -> torch.Tensor:
    """Δ = rowsum(dO * O) per head, f32, (b, H, s)."""
    b, s, hd = out.shape
    prod = dout.float().reshape(b, s, heads, hd // heads) \
        * out.float().reshape(b, s, heads, hd // heads)
    return prod.sum(-1).transpose(1, 2).contiguous()


def flash_packed_bwd_ref(qkv, out, lse, dout, heads, causal, sm_scale,
                         dropout_p=0.0, seed=None):
    """Plain backward: dqkv ``(b, s, 3*H*D)`` in qkv's dtype.  P^T from
    the saved LSE; dV from the dropped P, dS from the undropped P and the
    dropped dP; dS rounded to qkv's dtype before the dK / dQ products, q
    and k scaled in qkv's dtype, as in the kernels."""
    dt = qkv.dtype
    q, k, v = _split(qkv, heads)
    b, H, s, D = q.shape
    scale = torch.tensor(sm_scale, dtype=dt)
    qs, ks = q * scale, k * scale
    do = _heads(dout, heads).float()
    delta = _delta(out, dout, heads)
    sc = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    p = torch.exp(sc - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal(s, qkv.device), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
    pv = p
    if dropout_p > 0.0:
        keep = _drop_mask(b, H, s, seed, dropout_p, qkv.device)
        pv = torch.where(keep, p / (1.0 - dropout_p), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout_p), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", pv.to(dt).float(), do)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, ks.float())
    grads = torch.stack([dq, dk, dv], 2)              # (b, H, 3, s, D)
    return grads.permute(0, 3, 2, 1, 4).reshape(b, s, 3 * H * D).to(dt)


# ---------------------------------------------------------------------------
# The Hopper kernels
# ---------------------------------------------------------------------------

_fns = {}


def _lib(head_dim):
    """The three C entry points of the library of ``head_dim``'s padded
    width (64, 128 or 256), built and bound at first use."""
    from ._build import load, padded_width
    dp = padded_width(head_dim)
    if dp not in _fns:
        lib = load(f"flash_attention_packed_w{dp}")
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        geo = [ci, ci, ci, ci, ci, cf, ci, cf, ci]
        fwd = lib.flash_packed_fwd
        fwd.argtypes = [ci, vp, vp, vp, vp] + geo + [ci, vp]   # + fold
        bwd = [ci, vp, vp, vp, vp, vp, vp] + geo + [ci, vp]
        for name in ("dkdv", "dq"):
            fn = getattr(lib, f"flash_packed_{name}")
            fn.argtypes = bwd
        for fn in (fwd, lib.flash_packed_dkdv, lib.flash_packed_dq):
            fn.restype = ctypes.c_int
        _fns[dp] = dict(fwd=fwd, dkdv=lib.flash_packed_dkdv,
                        dq=lib.flash_packed_dq)
    return _fns[dp]


def check_geometry(shape, heads, dtype) -> None:
    """Raise ``ValueError`` unless the kernels take a qkv of ``shape`` and
    ``dtype``: ``(b, s, 3*H*D)`` bf16/f16 with D a multiple of 8 up to
    256 (any s)."""
    if len(shape) != 3 or shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (b, s, 3*H*D) with H={heads}, got "
                         f"{tuple(shape)}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the packed flash kernels take bf16/f16, got "
                         f"{dtype}")
    b, s, hd3 = shape
    D = hd3 // 3 // heads
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM or s < 1:
        raise ValueError(f"packed flash kernel unsupported for seq {s}, "
                         f"heads {heads}, head_dim {D}, dtype {dtype}")


def check_kernel_args(qkv, heads, *others) -> None:
    """Raise ``ValueError`` unless the kernels take ``qkv`` (and the other
    tensors of a backward launch): a CUDA tensor of a geometry
    :func:`check_geometry` takes, contiguous and 16-byte aligned."""
    if qkv.device.type != "cuda":
        raise ValueError(f"the packed flash kernels run on CUDA tensors, "
                         f"got {qkv.device}")
    check_geometry(tuple(qkv.shape), heads, qkv.dtype)
    for t in (qkv,) + others:
        if not t.is_contiguous():
            raise ValueError("the packed flash kernels take contiguous "
                             "tensors")
        if t.device != qkv.device:
            raise ValueError(f"tensor on {t.device}, qkv on {qkv.device}")
        if t.data_ptr() % 16:
            raise ValueError("the packed flash kernels take 16-byte aligned "
                             "tensors")


def _geo(qkv, heads, causal, sm_scale, dropout_p):
    b, s, hd3 = qkv.shape
    keep = 1.0 - dropout_p
    return (b, s, heads, hd3 // 3 // heads, int(bool(causal)),
            float(sm_scale), int(dropout_p > 0.0), keep, keep_threshold(keep))


def _check(err, name):
    if err != 0:
        raise RuntimeError(f"flash_attention_packed {name} kernel launch "
                           f"failed: CUDA error {err}")


def flash_packed_fwd_kernel(qkv, heads, causal, sm_scale, dropout_p=0.0,
                            seed=None):
    """Launch the forward kernel on PyTorch's current stream; returns
    ``(out (b, s, H*D), lse (b, H, s) f32)``."""
    check_kernel_args(qkv, heads)
    b, s, hd3 = qkv.shape
    out = torch.empty(b, s, hd3 // 3, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, heads, s, dtype=torch.float32, device=qkv.device)
    seed_t = _seed_tensor(seed, qkv.device)
    geo = _geo(qkv, heads, causal, sm_scale, dropout_p)
    fn = _lib(geo[3])["fwd"]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODES[qkv.dtype], qkv.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), seed_t.data_ptr(), *geo,
                 int(scale_folds(qkv.dtype, sm_scale)), stream)
    _check(err, "forward")
    launches["fwd"] += 1
    return out, lse


def _bwd_launch(name, qkv, dout, lse, delta, dqkv, heads, causal, sm_scale,
                dropout_p, seed):
    check_kernel_args(qkv, heads, dout, lse, delta, dqkv)
    b, s, hd3 = qkv.shape
    if (dout.shape != (b, s, hd3 // 3) or dout.dtype != qkv.dtype
            or dqkv.shape != qkv.shape or dqkv.dtype != qkv.dtype):
        raise ValueError("dout must be (b, s, H*D) and dqkv (b, s, 3*H*D), "
                         "both in qkv's dtype")
    for t in (lse, delta):
        if t.shape != (b, heads, s) or t.dtype != torch.float32:
            raise ValueError("lse and delta must be (b, H, s) float32")
    seed_t = _seed_tensor(seed, qkv.device)
    geo = _geo(qkv, heads, causal, sm_scale, dropout_p)
    fn = _lib(geo[3])[name]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODES[qkv.dtype], qkv.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), seed_t.data_ptr(),
                 dqkv.data_ptr(), *geo,
                 int(scale_folds(qkv.dtype, sm_scale)), stream)
    _check(err, name)
    launches[name] += 1


def flash_packed_dkdv_kernel(qkv, dout, lse, delta, dqkv, heads, causal,
                             sm_scale, dropout_p=0.0, seed=None):
    """Launch the dK/dV kernel: writes the k and v column slices of
    ``dqkv`` (b, s, 3*H*D)."""
    _bwd_launch("dkdv", qkv, dout, lse, delta, dqkv, heads, causal,
                sm_scale, dropout_p, seed)


def flash_packed_dq_kernel(qkv, dout, lse, delta, dqkv, heads, causal,
                           sm_scale, dropout_p=0.0, seed=None):
    """Launch the dQ kernel: writes the q column slice of ``dqkv``."""
    _bwd_launch("dq", qkv, dout, lse, delta, dqkv, heads, causal, sm_scale,
                dropout_p, seed)


def flash_packed_bwd_kernel(qkv, out, lse, dout, heads, causal, sm_scale,
                            dropout_p=0.0, seed=None):
    """Δ in torch (f32, as JAX computes it outside Pallas), then the dK/dV
    and dQ kernels into one ``torch.empty`` dqkv."""
    dout = dout.contiguous()
    delta = _delta(out, dout, heads)
    dqkv = torch.empty_like(qkv)
    args = (heads, causal, sm_scale, dropout_p, seed)
    flash_packed_dkdv_kernel(qkv, dout, lse, delta, dqkv, *args)
    flash_packed_dq_kernel(qkv, dout, lse, delta, dqkv, *args)
    return dqkv


def _by_device(x, cpu_fn, cuda_fn):
    if x.device.type == "cpu":
        return cpu_fn
    if x.device.type == "cuda":
        return cuda_fn
    raise ValueError(f"flash_attention_packed: unsupported device {x.device}")


class FlashAttentionPacked(torch.autograd.Function):
    """Forward and backward by device: the plain versions for CPU
    tensors, the Hopper kernels for CUDA tensors."""

    @staticmethod
    def forward(ctx, qkv, heads, causal, sm_scale, dropout_p, seed):
        fwd = _by_device(qkv, flash_packed_fwd_ref, flash_packed_fwd_kernel)
        out, lse = fwd(qkv, heads, causal, sm_scale, dropout_p, seed)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (heads, causal, sm_scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        bwd = _by_device(qkv, flash_packed_bwd_ref, flash_packed_bwd_kernel)
        dqkv = bwd(qkv, out, lse, dout, *ctx.args)
        return dqkv, None, None, None, None, None


def flash_attention_packed(qkv, heads, causal, sm_scale, dropout_p=0.0,
                           seed=None):
    """Flash attention over a packed ``(b, s, 3*H*D)`` qkv projection;
    returns ``(b, s, H*D)``.  ``seed`` (a ``(1,)`` int32 tensor or an int)
    keys the dropout mask when ``dropout_p > 0``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(qkv.shape[-1] // 3 // heads)
    return FlashAttentionPacked.apply(qkv, heads, bool(causal),
                                      float(sm_scale), float(dropout_p), seed)
