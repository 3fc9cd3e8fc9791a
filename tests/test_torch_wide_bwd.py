"""The port's backward past head width 256 and K2's padded rows
(``paddle_hackathon_tpu_torch``) against the JAX package, and the launch
plan of the backward's tensor-core kernels.

On the CPU the port's entry points take the plain versions, so these tests
pin the function the Hopper kernels compute (``csrc/flash_wide.cuh``'s
``dkdv_tc`` and ``dq_tc`` for bf16/f16 past 256, K1 and K2 alike), run the
JAX kernels under the Pallas interpreter as ``test_torch_wide_heads.py``
does, and hold the pure-Python mirror of the kernels' launch plan
(``wide_bwd_plan``, ``bwd_plan``) to the card's 232,448 bytes of dynamic
shared memory and TMA's box rules at every width the JAX gates can send
them.  K2's rows that TMA cannot address (f32 D % 4 != 0, bf16/f16 D % 8
!= 0 past 256) run the tensor-core kernels of the next aligned width on
zero-padded inputs: the plain versions on padded inputs, cut back, equal
them on the unpadded ones, and the padded route's results match the JAX
package's.  The kernels themselves run on the card (``chip_smoke.py``).

Tolerances as ``test_torch_wide_heads.py``: f32 at 1e-5 and bf16 at 1e-2
(the same sums in another order; bf16 rounds P and dS at the same
points)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.incubate.nn.kernels import flash_attention as jfa
from paddle_hackathon_tpu.incubate.nn.kernels import \
    flash_attention_packed as jfap
from paddle_hackathon_tpu_torch.incubate.nn.functional import \
    flash_attention_qkv_packed
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention_packed as tfap

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
SMEM_LIMIT = 232_448
SEED = 31


def _f(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# K1: the packed qkv gradient past 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,d,p", [(2, 384, 0.0), (1, 1024, 0.0),
                                       (2, 320, 0.1)])
def test_k1_wide_grads_match_jax_kernel(heads, d, p):
    """dqkv through ``flash_attention_qkv_packed`` against ``jax.grad`` of
    the JAX packed kernel, bf16, s = 64, batch 2 (b*H + h reaches 3 at two
    heads); with dropout 0.1 the backward regenerates the positional hash
    at the global index."""
    rng = np.random.RandomState(d + heads)
    s, b = 64, 2
    assert jfap.supported(s, s, heads, d, jnp.bfloat16)
    x = (rng.randn(b, s, 3 * heads * d) * 0.5).astype(np.float32)
    cot = rng.randn(b, s, heads * d).astype(np.float32)
    sc = 1.0 / math.sqrt(d)
    jx = jnp.asarray(x, jnp.bfloat16)
    jseed = jnp.asarray([SEED], jnp.int32)
    j_grad = jax.grad(lambda a: jnp.sum(jfap.flash_attention_packed(
        a, heads, True, sc, p, jseed).astype(jnp.float32) * cot))(jx)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = flash_attention_qkv_packed(tx, heads, dropout_p=p,
                                     seed=torch.tensor([SEED],
                                                       dtype=torch.int32))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tx.grad.float().numpy(), _f(j_grad),
                               **TOL["bf16"])


# ---------------------------------------------------------------------------
# K2: bf16 gradients past 256, and the padded rows
# ---------------------------------------------------------------------------

def _bhd(d, dt, sq=64, skv=128, bh=2, seed=0):
    rng = np.random.RandomState(d + seed)
    q, k, v, do = (rng.randn(bh, n, d).astype(np.float32) * 0.5
                   for n in (sq, skv, skv, sq))
    return q, k, v, do


def _k2_against_jax(q, k, v, do, dt, causal=True, p=0.0):
    """The forward (O, LSE) and the gradients of q, k, v through the port's
    ``flash_attention_bhd`` against the JAX package's, in ``dt``."""
    d = q.shape[-1]
    sc = 1.0 / math.sqrt(d)
    tol = TOL["f32" if dt == "float32" else "bf16"]
    jseed = jnp.asarray([SEED], jnp.int32)
    jargs = [jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v)]
    j_out, j_lse = jfa._fwd(*jargs, causal, sc, p, jseed)
    j_grads = jax.grad(lambda a, b, c: jnp.sum(jfa.flash_attention_bhd(
        a, b, c, causal, sc, p, jseed).astype(jnp.float32) * do),
        argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(a).to(getattr(torch, dt)).requires_grad_(True)
             for a in (q, k, v)]
    t_out, t_lse = tfa._fwd(*(t.detach() for t in targs), causal, sc, p,
                            SEED)
    np.testing.assert_allclose(t_out.float().numpy(), _f(j_out), **tol)
    np.testing.assert_allclose(t_lse.numpy(), _f(j_lse)[:, 0, :], **tol)
    out = tfa.flash_attention_bhd(*targs, causal, sc, p, SEED)
    (out.float() * torch.from_numpy(do)).sum().backward()
    for name, t, j in zip("qkv", targs, j_grads):
        assert t.grad.dtype == getattr(torch, dt)
        np.testing.assert_allclose(t.grad.float().numpy(), _f(j),
                                   err_msg=f"d{name}", **tol)


@pytest.mark.parametrize("d", [264, 320, 512])
def test_k2_bf16_wide_grads_match_jax_kernel(d):
    """bf16 past 256 (``dkdv_tc`` / ``dq_tc`` on the card), causal with sq
    != skv: D = 264 ends in a slice of 8 columns and a chunk of 8."""
    _k2_against_jax(*_bhd(d, "bfloat16"), "bfloat16")


@pytest.mark.parametrize("d,dt,p", [(33, "float32", 0.0),
                                    (514, "float32", 0.1),
                                    (514, "bfloat16", 0.0)])
def test_k2_padded_rows_match_jax_kernel(d, dt, p):
    """Rows TMA cannot address: f32 D = 33 (the 3xTF32 kernels at 36) and
    514 (the forward and the 3xTF32 backward at 516), and bf16 D = 514 (the
    tensor-core kernels at 520), forward and gradients against the JAX
    package's at the unpadded width."""
    dtype = getattr(torch, dt)
    assert tfa.padded_width(d, dtype) > d
    _k2_against_jax(*_bhd(d, dt, seed=1), dt, p=p)


@pytest.mark.parametrize("d,dt", [(33, torch.float32), (514, torch.float32),
                                  (514, torch.bfloat16),
                                  (257, torch.float16),
                                  (1030, torch.float32)])
def test_plain_versions_on_padded_inputs_cut_back_are_the_unpadded(d, dt):
    """The padded route's premise, in torch alone: zero columns of q, k and
    dO add exact zeros to every score and to dP, so the plain forward and
    pair on inputs padded to the kernels' width, cut back to D, equal them
    on the unpadded inputs (Δ over the real columns; dropout keyed by
    positions only).  The values are ``dt``'s, run in f64 (the plain
    versions' f64 mode), where only the order of a sum can differ: 1e-12
    relative."""
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.from_numpy(rng.randn(3, 64, d).astype(np.float32)
                                    * 0.5).to(dt).double() for _ in range(4))
    exact = dict(rtol=1e-12, atol=1e-12)
    sc = 1.0 / math.sqrt(d)
    for kernel in ("fwd", "bwd"):
        w = tfa.padded_width(d, dt)
        assert w % (4 if dt == torch.float32 else 8) == 0 and w > d
        padded = [tfa._pad(t, w) for t in (q, k, v, do)]
        assert all(t.shape[-1] == w and t.is_contiguous() for t in padded)
        assert all(torch.equal(t[..., d:], torch.zeros_like(t[..., d:]))
                   for t in padded)
        if kernel == "fwd":
            o, lse = tfa.flash_fwd_ref(q, k, v, True, sc, 0.1, SEED)
            po, plse = tfa.flash_fwd_ref(*padded[:3], True, sc, 0.1, SEED)
            torch.testing.assert_close(tfa._cut(po, d), o, **exact)
            torch.testing.assert_close(plse, lse, **exact)
        else:
            delta = (do * o).sum(-1)
            ref = tfa.flash_bwd_pair_ref(q, k, v, do, lse, delta, True, sc,
                                         0.1, SEED)
            got = tfa.flash_bwd_pair_ref(*padded, lse, delta, True, sc, 0.1,
                                         SEED)
            for g, r in zip(got, ref):
                torch.testing.assert_close(tfa._cut(g, d), r, **exact)


# ---------------------------------------------------------------------------
# Routes and the launch plan of the backward past 256
# ---------------------------------------------------------------------------

def _check_bwd_plan(plan, d, bh, s, kernel, dtype=torch.bfloat16):
    """The rules every plan of the dK/dV and dQ kernels past 256 obeys:
    bf16/f16 ``dkdv_tc`` / ``dq_tc`` (64-column slices, 256-column
    chunks, a ring of 4), f32 ``bhd_dkdv_tc<0>`` / ``bhd_dq_tc<0>``
    (32-column slices, 128 columns of dK and dV or 256 of dQ a block, a
    ring of 2)."""
    f32 = dtype == torch.float32
    e = 4 if f32 else 2
    assert plan["route"] == ("wide_tc_f32" if f32 else "wide_tc")
    assert plan["kernel"] == kernel
    assert plan["smem"] <= SMEM_LIMIT, (d, plan)
    assert plan["threads"] == 384 and plan["stages"] == (2 if f32 else 4)
    assert not plan["q_resident"]
    # a TMA box row is the 128 bytes of the swizzle, each box edge <= 256
    assert plan["box_bytes"] == 128 == plan["box"][0] * e
    assert max(plan["box"]) <= 256
    w = plan["head_dim"]
    assert w == tfa.padded_width(d, dtype)
    assert w * e % 16 == 0 and 0 <= w - d < 16 // e
    assert plan["row_elems"] * e % 16 == 0
    sl = 128 // e
    assert plan["slices"] * sl >= w > (plan["slices"] - 1) * sl
    assert plan["tail"] == w % sl
    cc = (128 if kernel == "dkdv" else 256) if f32 else 256
    assert plan["chunk_cols"] == cc
    assert plan["chunks"] == -(-w // cc)
    assert plan["grid"] == (-(-s // 64) * bh * plan["chunks"], 1, 1)
    assert plan["grid"][0] <= 2 ** 31 - 1


@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_k1_bwd_plan_fits_every_jax_plan_width(s, heads):
    """Every (s, H, D) past 256 the JAX K1 ``_plan`` admits, up to D =
    8192: both backward kernels' plans fit, over rows of 3 H D elements;
    the library past 256 is the column-chunked one."""
    admitted = 0
    for d in range(264, 8193, 8):
        for jd, td in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float16, torch.float16)):
            if jfap._plan(s, s, heads, d, jd) is None:
                continue
            admitted += 1
            assert tfap.bwd_kernel_of(d) == "wide_tc"
            for kernel in ("dkdv", "dq"):
                plan = tfap.bwd_plan(2, s, heads, d, td, kernel)
                _check_bwd_plan(plan, d, 2 * heads, s, kernel)
                assert plan["row_elems"] == 3 * heads * d
    assert admitted > 0
    assert tfap.bwd_kernel_of(256) == "tma"


@pytest.mark.parametrize("dt", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", [257, 264, 320, 516, 1024, 2048])
def test_k2_bwd_plan(d, dt):
    """K2 past 256, unaligned rows at their padded width: bf16/f16 on
    ``dkdv_tc`` / ``dq_tc``, f32 on the 3xTF32 pair's run-time-width
    instances, at every width to the JAX plan's 8192 for f32."""
    dtype = getattr(torch, dt)
    f32 = dtype == torch.float32
    assert tfa.bwd_route(d, dtype) == ("wide_tc_f32" if f32 else "wide_tc")
    for kernel in ("dkdv", "dq"):
        _check_bwd_plan(tfa.wide_bwd_plan(12, 1000, d, dtype, kernel), d,
                        12, 1000, kernel, dtype)
    # dQ's chunk entry holds k alone: 32 KB less than dK/dV's dO and q
    # (f32: its A operand is dS alone, 4 boxes of 8 KB less than P^T and
    # dS^T)
    assert tfa.wide_bwd_plan(1, 64, d, dtype, "dkdv")["smem"] - \
        tfa.wide_bwd_plan(1, 64, d, dtype, "dq")["smem"] == 4 * 64 * 128
    if f32 and d == 257:
        # one plan for every width: nothing resident, the ring streams
        for w in range(257, 8193):
            for kernel in ("dkdv", "dq"):
                plan = tfa.wide_bwd_plan(16, 1024, w, dtype, kernel)
                assert plan["smem"] <= SMEM_LIMIT
                assert plan["head_dim"] == -(-w // 4) * 4
                assert plan["chunks"] == -(-plan["head_dim"] //
                                           plan["chunk_cols"])
                assert plan["grid"][0] == 16 * 16 * plan["chunks"]


def test_routes_name_no_cuda_core_forward():
    """Every width to 1100 in every dtype: the forward is a tensor-core or
    mma.sync kernel and so are dK/dV and dQ (no CUDA-core kernel exists:
    f32 past 256 runs the 3xTF32 pair's run-time-width instances); plans
    refuse other routes."""
    assert "wide" not in tfa.BWD_ROUTES and "wide_fwd" not in \
        tfa.FWD_KERNELS
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for d in range(1, 1101):
            assert tfa.fwd_route(d, dt) in tfa.FWD_KERNELS
            route = tfa.bwd_route(d, dt)
            assert route in tfa.BWD_ROUTES
            if d > 256:
                assert route == ("wide_tc_f32" if dt == torch.float32
                                 else "wide_tc"), (d, dt)
            else:
                assert route == ("tc" if dt == torch.float32 else "mma")
    with pytest.raises(ValueError):
        tfa.wide_bwd_plan(1, 64, 256, torch.float32, "dkdv")
    with pytest.raises(ValueError):
        tfa.wide_bwd_plan(1, 64, 256, torch.bfloat16, "dq")


# ---------------------------------------------------------------------------
# The f32 pair's limit past 256 and its control
# ---------------------------------------------------------------------------

PAIR_REL = 6e-7     # chip_smoke.py's FLASH_F32_PAIR_REL


def _trunc_split(x):
    """``tf32_split`` with truncation in place of rounding to nearest (hi:
    the low 13 mantissa bits cleared, as the tensor core reads raw f32)."""
    def trunc(t):
        return (t.contiguous().view(torch.int32) & ~0x1FFF).view(
            torch.float32)
    hi = trunc(x.float())
    return hi, trunc(x.float() - hi)


def _split_pair(split, q, k, v, do, lse, delta, sc):
    """The plain causal f32 pair with every product taken as the 3xTF32
    kernels take it (al.bh + ah.bl + ah.bh of ``split``'s operands, one
    f32 sum over the three), P and dS split as the kernels split them."""
    def mm(eq, a, b, axis_a, axis_b):
        (ah, al), (bh, bl) = split(a), split(b)
        return torch.einsum(eq, torch.cat([al, ah, ah], axis_a),
                            torch.cat([bh, bl, bh], axis_b))
    sq, skv = q.shape[1], k.shape[1]
    mask = torch.ones(sq, skv, dtype=torch.bool).tril()
    p = torch.exp(mm("bqd,bkd->bqk", q, k, 2, 2) * sc
                  - lse[..., None]).masked_fill(~mask, 0.0)
    dp = mm("bqd,bkd->bqk", do, v, 2, 2)
    ds = p * (dp - delta[..., None]) * sc
    return (mm("bqk,bkd->bqd", ds, k, 2, 1),
            mm("bqk,bqd->bkd", ds, q, 1, 1),
            mm("bqk,bqd->bkd", p, do, 1, 1))


@pytest.mark.parametrize("d", [320, 512])
def test_f32_pair_limit_has_a_control_that_fails_past_256(d):
    """The limit the card holds K2's f32 pair to up to D = 512 (relative
    L2 6e-7 of dq, dk and dv against the f64 plain pair): the plain pair
    on 3xTF32 operands split to nearest, the kernels' arithmetic, is
    under it, and split by truncation (the single rounding the tensor
    core would apply to raw f32) is over it, so the check can fail."""
    rng = np.random.RandomState(7)
    bh, s = 2, 256
    q, k = (torch.from_numpy((rng.randn(bh, s, d) * 0.5).astype(np.float32))
            for _ in "qk")
    v, do = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
             for _ in "vd")
    sc = 1.0 / math.sqrt(d)
    o64, lse64 = tfa.flash_fwd_ref(q.double(), k.double(), v.double(), True,
                                   sc)
    delta64 = (do.double() * o64).sum(-1)
    ref = tfa.flash_bwd_pair_ref(q.double(), k.double(), v.double(),
                                 do.double(), lse64, delta64, True, sc)
    lse, delta = lse64.float(), delta64.float()

    def worst(split):
        got = _split_pair(split, q, k, v, do, lse, delta, sc)
        return max(float((g.double() - r).norm() / r.norm())
                   for g, r in zip(got, ref))
    rna, trunc = worst(tfa.tf32_split), worst(_trunc_split)
    assert rna <= PAIR_REL < trunc, (rna, trunc)
