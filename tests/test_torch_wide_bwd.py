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
    514 (the forward at 516; the backward, on the CUDA cores, at 514), and
    bf16 D = 514 (the tensor-core kernels at 520), forward and gradients
    against the JAX package's at the unpadded width."""
    dtype = getattr(torch, dt)
    assert tfa.padded_width(d, dtype) > d
    _k2_against_jax(*_bhd(d, dt, seed=1), dt, p=p)


@pytest.mark.parametrize("d,dt", [(33, torch.float32), (514, torch.float32),
                                  (514, torch.bfloat16),
                                  (257, torch.float16)])
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
        w = tfa.padded_width(d, dt, kernel)
        assert w % (4 if dt == torch.float32 else 8) == 0 or w == d
        assert w > d or (kernel, dt) == ("bwd", torch.float32)
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

def _check_bwd_plan(plan, d, bh, s, kernel):
    """The rules every plan of ``dkdv_tc`` / ``dq_tc`` obeys."""
    assert plan["route"] == "wide_tc" and plan["kernel"] == kernel
    assert plan["smem"] <= SMEM_LIMIT, (d, plan)
    assert plan["threads"] == 384 and plan["stages"] == 4
    assert not plan["q_resident"]
    # a TMA box row is the 128 bytes of the swizzle, each box edge <= 256
    assert plan["box_bytes"] == 128 == plan["box"][0] * 2
    assert max(plan["box"]) <= 256
    w = plan["head_dim"]
    assert w == tfa.padded_width(d, torch.bfloat16, "bwd")
    assert w % 8 == 0 and 0 <= w - d < 8
    assert plan["row_elems"] * 2 % 16 == 0
    assert plan["slices"] * 64 >= w > (plan["slices"] - 1) * 64
    assert plan["tail"] == w % 64
    assert plan["chunk_cols"] == 256
    assert plan["chunks"] == -(-w // 256)
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


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [257, 264, 320, 516, 1024, 2048])
def test_k2_bwd_plan(d, dt):
    """K2 bf16/f16 past 256, unaligned rows at their padded width."""
    dtype = getattr(torch, dt)
    assert tfa.bwd_route(d, dtype) == "wide_tc"
    for kernel in ("dkdv", "dq"):
        _check_bwd_plan(tfa.wide_bwd_plan(12, 1000, d, dtype, kernel), d,
                        12, 1000, kernel)
    # dQ's chunk entry holds k alone: 32 KB less than dK/dV's dO and q
    assert tfa.wide_bwd_plan(1, 64, d, dtype, "dkdv")["smem"] - \
        tfa.wide_bwd_plan(1, 64, d, dtype, "dq")["smem"] == 4 * 64 * 128


def test_routes_name_no_cuda_core_forward():
    """Every width to 1100 in every dtype: the forward is a tensor-core or
    mma.sync kernel (no CUDA-core forward exists); dK/dV and dQ run on
    the CUDA cores only for f32 past 256; plans refuse other routes."""
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for d in range(1, 1101):
            assert tfa.fwd_route(d, dt) in tfa.FWD_KERNELS
            route = tfa.bwd_route(d, dt)
            if d > 256:
                assert route == ("wide" if dt == torch.float32
                                 else "wide_tc"), (d, dt)
            else:
                assert route == ("tc" if dt == torch.float32 else "mma")
    assert "wide_fwd" not in tfa.FWD_KERNELS
    with pytest.raises(ValueError):
        tfa.wide_bwd_plan(1, 64, 514, torch.float32, "dkdv")
    with pytest.raises(ValueError):
        tfa.wide_bwd_plan(1, 64, 256, torch.bfloat16, "dq")
