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
  there is no fallback to the plain version on the card.  Where a kernel
  reads its rows by TMA (f32 at every width, bf16/f16 past 256) and a row
  is not a multiple of 16 bytes, the wrapper zero-pads the head width to
  :func:`padded_width` and cuts the outputs back (zero columns of q, k and
  dO add exact zeros to every score).  The forward is one of three kernels
  by dtype and width (:data:`FWD_KERNELS`, counted apart in
  :data:`fwd_launches`), dK/dV and dQ one of four (:data:`BWD_ROUTES`,
  counted in :data:`bwd_launches`); :func:`fwd_route`, :func:`bwd_route`,
  :func:`wide_fwd_plan` and :func:`wide_bwd_plan` mirror those choices
  and the launch plans of the tensor-core kernels past 256 in pure Python
  (the counters are keyed by the mirrors; the smoke run holds them to the
  libraries' own ``flash_bhd_fwd_route`` / ``flash_bhd_bwd_route``).
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
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the last reset, one count per kernel (the smoke
# run reads them to prove the train step went through the kernels)
launches = {"fwd": 0, "dkdv": 0, "dq": 0}
# The forward kernels, in the order of the libraries' flash_bhd_fwd_route:
# bf16/f16 up to 256 on mma.sync, f32 up to 256 on 3xTF32 wgmma, past 256
# on the tensor cores (wgmma: bf16/f16, or 3xTF32 for f32).  Each forward
# launch counts once here, under its kernel, and once in
# ``launches["fwd"]``.
FWD_KERNELS = ("fwd_mma", "fwd_tc", "wide_fwd_tc")
fwd_launches = dict.fromkeys(FWD_KERNELS, 0)
# The dK/dV and dQ kernels, in the order of flash_bhd_bwd_route: bf16/f16
# up to 256 on mma.sync (``mma``), f32 up to 256 on 3xTF32 wgmma (``tc``),
# bf16/f16 past 256 on wgmma (``wide_tc``: flash_wide.cuh's dkdv_tc /
# dq_tc) and f32 past 256 on 3xTF32 wgmma (``wide_tc_f32``: the run-time
# width instances bhd_dkdv_tc<0> / bhd_dq_tc<0>).  Each launch counts once
# in ``bwd_launches["<dkdv|dq>_<route>"]`` and once in ``launches``.
BWD_ROUTES = ("mma", "tc", "wide_tc", "wide_tc_f32")
bwd_launches = {f"{k}_{r}": 0 for r in BWD_ROUTES for k in ("dkdv", "dq")}

# The launch plans of the tensor-core kernels past 256, as
# csrc/flash_wide.cuh (bf16, f16: fwd_tc, dkdv_tc, dq_tc, also K1's) and
# csrc/flash_attention.cu (f32: fwd_tc_f32) lay them out; the CPU tests
# hold them to the card's limits.
SMEM_LIMIT = 232_448          # dynamic shared memory a block may take
_BOX_BYTES = 64 * 128         # a [64 rows][128 bytes] TMA box
_WIDE_TC = {                  # per element size: threads, slice and chunk
    2: dict(threads=160, slice_cols=64, chunk_cols=256),
    4: dict(threads=256, slice_cols=32, chunk_cols=128),
}
_Q_RESIDENT_MAX_D = 1024      # bf16/f16: q's slices stay up to this width
# the backward past 256 (tcb:: in flash_wide.cuh): two consumer warpgroups
# and a producer warpgroup, 64-column slices in a ring of 4 entries of four
# boxes, 256-column chunks, P handed over as a 64 x 64 f32 tile
_WIDE_BWD = dict(threads=384, slice_cols=64, chunk_cols=256, stages=4)
# the f32 backward past 256 (tc:: in flash_attention.cu): the same three
# warpgroups, 32-column slices in a ring of 2 entries of up to four [64][32]
# f32 boxes; 128 columns of each of dK and dV a block, 256 of dQ; dynamic
# shared memory as tc::kSmemDkdv / kSmemDq (the ring, two split buffers a
# warpgroup, the A operand tiles, the 64 x 64 exchange, the barriers),
# which the library exports (library_bwd_smem) for a check on the card
_WIDE_BWD_F32 = dict(threads=384, slice_cols=32, stages=2,
                     chunk_cols={"dkdv": 128, "dq": 256},
                     smem={"dkdv": 1024 + (8 + 8 + 8 + 2) * _BOX_BYTES + 32,
                           "dq": 1024 + (8 + 8 + 4 + 2) * _BOX_BYTES + 32})


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


def tf32_split(x: torch.Tensor):
    """The f32 kernels' 3xTF32 operand split: ``(hi, lo)`` with ``hi`` x
    rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
    zero (``cvt.rna.tf32.f32``), and ``lo`` the same rounding of
    ``x - hi``; a product a.b is taken as al.bh + ah.bl + ah.bh.  Plain
    torch on f32 tensors, for the tests and the smoke run."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x.float())
    return hi, rna(x.float() - hi)


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

def _elem(dtype) -> int:
    return 4 if dtype == torch.float32 else 2


def padded_width(head_dim: int, dtype) -> int:
    """The head width the kernels (forward, dK/dV and dQ alike) run
    ``head_dim`` at: the least width whose rows TMA addresses (a multiple
    of 16 bytes: 4 f32, 8 bf16/f16 elements) where the kernels read rows
    by TMA -- f32 at every width and bf16/f16 past 256 -- else
    ``head_dim`` itself (mma.sync reads any row)."""
    if dtype == torch.float32:
        return -(-head_dim // 4) * 4
    return -(-head_dim // 8) * 8 if head_dim > 256 else head_dim


def fwd_route(head_dim: int, dtype) -> str:
    """The forward kernel that runs ``head_dim`` in ``dtype`` (one of
    :data:`FWD_KERNELS`, at :func:`padded_width`): the pure-Python mirror
    of the libraries' ``flash_bhd_fwd_route``."""
    if padded_width(head_dim, dtype) > 256:
        return "wide_fwd_tc"
    return "fwd_tc" if dtype == torch.float32 else "fwd_mma"


def bwd_route(head_dim: int, dtype) -> str:
    """The dK/dV and dQ kernels that run ``head_dim`` in ``dtype`` (one of
    :data:`BWD_ROUTES`, at :func:`padded_width`): the mirror of the
    libraries' ``flash_bhd_bwd_route``."""
    f32 = dtype == torch.float32
    if padded_width(head_dim, dtype) > 256:
        return "wide_tc_f32" if f32 else "wide_tc"
    return "tc" if f32 else "mma"


def _plan_common(route, bh, sq, d, e, geo, row_elems):
    sl, nc = geo["slice_cols"], geo["chunk_cols"]
    chunks = -(-d // nc)
    return dict(route=route, threads=geo["threads"],
                grid=(-(-sq // 64) * bh * chunks, 1, 1), slice_cols=sl,
                chunk_cols=nc, slices=-(-d // sl), chunks=chunks,
                tail=d % sl, box=(sl, 64), box_bytes=sl * e, head_dim=d,
                row_elems=d if row_elems is None else row_elems)


def wide_fwd_plan(bh: int, sq: int, head_dim: int, dtype,
                  row_elems: int = None) -> dict:
    """The launch plan of the tensor-core forward that takes ``head_dim``
    past 256 in ``dtype``, at :func:`padded_width` (``ValueError`` for a
    width the narrower forwards take): ``route``, ``threads``, ``grid``
    (64-row q tiles x bh x chunks in grid.x), ``smem`` (dynamic shared
    memory, bytes), the TMA boxes (``box``: columns, rows;
    ``box_bytes``: a box row's bytes, 128 under the 128-byte swizzle), the
    width the kernel runs (``head_dim``) and the row stride the maps take
    (``row_elems``: that width for (bh, s, D) tensors, 3 H D for K1's
    packed qkv), the slice and chunk widths, the slices, the live columns
    of the last slice (``tail``, 0 when whole), whether q's slices stay
    resident (bf16/f16 up to D = 1024) and the ring stages.  Mirrors
    ``wide::tcw::smem_of`` and ``wide::tcf32::kSmem``."""
    route = fwd_route(head_dim, dtype)
    if route != "wide_fwd_tc":
        raise ValueError(f"D={head_dim} in {dtype} runs {route}")
    head_dim = padded_width(head_dim, dtype)
    e = _elem(dtype)
    plan = _plan_common(route, bh, sq, head_dim, e, _WIDE_TC[e], row_elems)
    nc = plan["chunk_cols"]
    if e == 2:
        resident = head_dim <= _Q_RESIDENT_MAX_D
        k_entry = _BOX_BYTES * (1 if resident else 2)
        k0 = plan["slices"] * _BOX_BYTES if resident else 0
        stages_k, stages_v = 4, 2
        v_bytes = nc // 64 * _BOX_BYTES
        bars = k0 + stages_k * k_entry + stages_v * v_bytes
        smem = 1024 + bars + (1 + 2 * stages_k + 2 * stages_v) * 8
        plan.update(q_resident=resident, stages=(stages_k, stages_v),
                    smem=smem)
    else:
        raw, op_slots = 8, 8      # tcf32::kRaw, tcf32::kOps
        smem = 1024 + (raw + 2 * op_slots) * _BOX_BYTES + \
            8 * (raw + 2 * op_slots)
        plan.update(q_resident=False, stages=(raw, op_slots), smem=smem)
    return plan


def wide_bwd_plan(bh: int, s: int, head_dim: int, dtype, kernel: str,
                  row_elems: int = None) -> dict:
    """The launch plan of the dK/dV (``kernel="dkdv"``: grid over kv tiles
    of ``s`` rows) or dQ (``"dq"``: over q tiles) kernel past 256, at
    :func:`padded_width` (``ValueError`` for a width the narrower kernels
    take): bf16/f16 flash_wide.cuh's ``dkdv_tc`` / ``dq_tc`` (route
    ``wide_tc``), f32 the 3xTF32 pair's run-time-width instances (route
    ``wide_tc_f32``).  The keys of :func:`wide_fwd_plan`, ``grid`` (64-row
    tiles x bh x output chunks in grid.x), ``stages`` the slice ring's
    entries (four boxes each), nothing resident (``q_resident`` False:
    every operand streams, so the plan is one size at every width), and
    ``smem``: bf16/f16 as ``wide::tcb::smem_of`` (the ring, the chunk
    entry -- dK/dV: dO and q, four boxes each; dQ: k --, P as 64 x 64 f32
    and the barriers), f32 as ``tc::kSmemDkdv`` / ``kSmemDq``.  f32
    chunks are 128 columns of each of dK and dV, or 256 of dQ (each
    consumer warpgroup 128 of them)."""
    route = bwd_route(head_dim, dtype)
    if route not in ("wide_tc", "wide_tc_f32"):
        raise ValueError(f"D={head_dim} in {dtype} runs {route}")
    if kernel not in ("dkdv", "dq"):
        raise ValueError(f"kernel must be dkdv or dq, got {kernel}")
    head_dim = padded_width(head_dim, dtype)
    if route == "wide_tc_f32":
        geo = dict(_WIDE_BWD_F32, chunk_cols=_WIDE_BWD_F32["chunk_cols"][
            kernel])
        plan = _plan_common(route, bh, s, head_dim, 4, geo, row_elems)
        plan.update(kernel=kernel, q_resident=False,
                    stages=geo["stages"], smem=geo["smem"][kernel])
        return plan
    plan = _plan_common(route, bh, s, head_dim, 2, _WIDE_BWD, row_elems)
    stages = _WIDE_BWD["stages"]
    boxes = plan["chunk_cols"] // 64
    smem = (1024 + stages * 4 * _BOX_BYTES
            + (1 if kernel == "dq" else 2) * boxes * _BOX_BYTES
            + 64 * 64 * 4 + (2 * stages + 2) * 8)
    plan.update(kernel=kernel, q_resident=False, stages=stages, smem=smem)
    return plan


_fns = {}


def _lib(head_dim, dtype):
    """The three C entry points of the library of ``head_dim``'s padded
    width (64, 128 or 256; past 256 the column-chunked library) and
    ``dtype``'s family (f32, or bf16/f16), built and bound at first use."""
    from ._build import load, width_tag
    key = (width_tag(head_dim), "f32" if dtype == torch.float32 else "h")
    if key not in _fns:
        lib = load("flash_attention_{}_{}".format(*key))
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ci, ci, ci, ci, ci, cf, ci, cf, ci, vp]
        lib.flash_bhd_fwd.argtypes = [ci] + [vp] * 6 + tail
        lib.flash_bhd_dkdv.argtypes = [ci] + [vp] * 9 + tail
        lib.flash_bhd_dq.argtypes = [ci] + [vp] * 8 + tail
        for name in ("fwd_route", "bwd_route", "fwd_smem"):
            getattr(lib, f"flash_bhd_{name}").argtypes = [ci, ci]
        lib.flash_bhd_bwd_smem.argtypes = [ci, ci, ci]
        fns = _fns[key] = {}
        for name in ("fwd", "dkdv", "dq", "fwd_route", "bwd_route",
                     "fwd_smem", "bwd_smem"):
            fn = getattr(lib, f"flash_bhd_{name}")
            fn.restype = ctypes.c_int
            fns[name] = fn
    return _fns[key]


def _library_route(name, head_dim, dtype, names) -> str:
    d = padded_width(head_dim, dtype)
    code = _lib(d, dtype)[f"{name}_route"](_DTYPE_CODES[dtype], d)
    if code < 0:
        raise RuntimeError(f"no bhd {name} kernel for D={d}, {dtype}")
    return names[code]


def library_fwd_route(head_dim, dtype) -> str:
    """The forward kernel the library launches for ``head_dim`` (at
    :func:`padded_width`) and ``dtype`` (its ``flash_bhd_fwd_route``;
    builds the library at first use)."""
    return _library_route("fwd", head_dim, dtype, FWD_KERNELS)


def library_bwd_route(head_dim, dtype) -> str:
    """The dK/dV and dQ kernels' route (one of :data:`BWD_ROUTES`) the
    library launches for ``head_dim`` and ``dtype`` (its
    ``flash_bhd_bwd_route``)."""
    return _library_route("bwd", head_dim, dtype, BWD_ROUTES)


def library_fwd_smem(head_dim, dtype) -> int:
    """That forward's dynamic shared memory in bytes, as the library
    computes it."""
    d = padded_width(head_dim, dtype)
    return _lib(d, dtype)["fwd_smem"](_DTYPE_CODES[dtype], d)


def library_bwd_smem(head_dim, dtype, kernel) -> int:
    """The dK/dV (``kernel="dkdv"``) or dQ (``"dq"``) kernel's dynamic
    shared memory in bytes, as the library computes it."""
    d = padded_width(head_dim, dtype)
    return _lib(d, dtype)["bwd_smem"](_DTYPE_CODES[dtype], d,
                                      int(kernel == "dq"))


def check_geometry(q_shape, kv_shape, dtype) -> None:
    """Raise unless the kernels take ``q`` of ``q_shape (bh, sq, D)`` and
    ``k, v`` of ``kv_shape (bh, skv, D)`` in ``dtype`` (a pure function of
    the shapes, which the CPU tests call): ``NotImplementedError`` for a
    dtype the CUDA kernels do not cover (every head width D >= 1 is
    covered: the instances up to 256, the column-chunked kernels past it,
    rows TMA cannot address zero-padded), ``RuntimeError`` for ranks,
    shapes or lengths the gate refuses."""
    if len(q_shape) != 3 or len(kv_shape) != 3 \
            or kv_shape[0] != q_shape[0] or kv_shape[2] != q_shape[2]:
        raise RuntimeError(f"q must be (bh, sq, D) and k, v (bh, skv, D), "
                           f"got {tuple(q_shape)}, {tuple(kv_shape)}")
    if dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"the bhd flash kernels take f32/bf16/f16, got {dtype}: ROADMAP "
            f"Queue 2")
    bh, sq, d = q_shape
    if d < 1:
        raise RuntimeError(f"head width must be >= 1, got {d}")
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


def _pad(x, width):
    """``x`` with its last dim zero-padded to ``width`` (``x`` itself where
    it is that wide already)."""
    d = x.shape[-1]
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def _cut(x, d):
    """``x`` cut back to its first ``d`` columns, contiguous."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _launch(name, q, k, v, ptrs, causal, sm_scale, dropout_p):
    """Launch kernel ``name`` on q, k, v of the width it runs (the caller
    has padded them)."""
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
    if name == "fwd":
        fwd_launches[fwd_route(q.shape[-1], q.dtype)] += 1
    else:
        bwd_launches[f"{name}_{bwd_route(q.shape[-1], q.dtype)}"] += 1


def flash_fwd_kernel(q, k, v, causal, sm_scale, dropout_p=0.0, seed=None):
    """Launch the forward kernel on PyTorch's current stream; returns
    ``(out (bh, sq, D) in q's dtype, lse (bh, sq) f32)``.  Rows TMA
    cannot address run zero-padded to :func:`padded_width`."""
    check_kernel_args(q, k, v)
    bh, sq, d = q.shape
    width = padded_width(d, q.dtype)
    q, k, v = (_pad(t, width) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    seed_t = _seed_tensor(seed, q.device)
    _launch("fwd", q, k, v, (out.data_ptr(), lse.data_ptr(),
                             seed_t.data_ptr()),
            causal, sm_scale, dropout_p)
    return _cut(out, d), lse


def _check_bwd(q, k, v, do, lse, delta_row):
    check_kernel_args(q, k, v, do, lse, delta_row)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise RuntimeError("do must be shaped and typed as q")
    for t in (lse, delta_row):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise RuntimeError("lse and delta_row must be (bh, sq) float32")


def _bwd_inputs(q, k, v, do):
    """q, k, v and dO zero-padded to the width dK/dV and dQ run at (Δ
    comes from the caller, over the real columns)."""
    width = padded_width(q.shape[-1], q.dtype)
    return [_pad(t, width) for t in (q, k, v, do)]


def flash_dkdv_kernel(q, k, v, do, lse, delta_row, causal, sm_scale,
                      dropout_p=0.0, seed=None):
    """Launch the dK/dV kernel; returns ``(dk, dv)`` (bh, skv, D).  Rows
    TMA cannot address run zero-padded to :func:`padded_width`."""
    _check_bwd(q, k, v, do, lse, delta_row)
    d = q.shape[-1]
    q, k, v, do = _bwd_inputs(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    seed_t = _seed_tensor(seed, q.device)
    _launch("dkdv", q, k, v, (do.data_ptr(), lse.data_ptr(),
                              delta_row.data_ptr(), seed_t.data_ptr(),
                              dk.data_ptr(), dv.data_ptr()),
            causal, sm_scale, dropout_p)
    return _cut(dk, d), _cut(dv, d)


def flash_dq_kernel(q, k, v, do, lse, delta_row, causal, sm_scale,
                    dropout_p=0.0, seed=None):
    """Launch the dQ kernel; returns ``dq`` (bh, sq, D), rows padded as
    :func:`flash_dkdv_kernel`'s."""
    _check_bwd(q, k, v, do, lse, delta_row)
    d = q.shape[-1]
    q, k, v, do = _bwd_inputs(q, k, v, do)
    dq = torch.empty_like(q)
    seed_t = _seed_tensor(seed, q.device)
    _launch("dq", q, k, v, (do.data_ptr(), lse.data_ptr(),
                            delta_row.data_ptr(), seed_t.data_ptr(),
                            dq.data_ptr()),
            causal, sm_scale, dropout_p)
    return _cut(dq, d)


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
