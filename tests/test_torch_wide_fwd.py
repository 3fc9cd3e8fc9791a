"""The port's forward past head width 256 (``paddle_hackathon_tpu_torch``)
against the JAX package, and the launch plan of its tensor-core kernel.

On the CPU the port's forward is the plain version, so these tests pin the
function the Hopper kernels compute (``csrc/flash_wide.cuh``'s ``fwd_tc``
for bf16/f16, ``csrc/flash_attention.cu``'s ``fwd_tc_f32`` for f32), the
dropout hash keyed by the global b*H + h index, and the launch plan those
kernels take, mirrored in pure Python (``wide_fwd_plan``): every plan the
JAX gates can send them fits the card's 232,448 bytes of dynamic shared
memory and TMA's box rules, and rows TMA cannot address run the tensor-core
forward of the next aligned width on zero-padded inputs.  The kernels
themselves run on the card (``chip_smoke.py``).

Tolerances as ``test_torch_wide_heads.py``: f32 at 1e-5 and bf16 at 1e-2
(the same sums in another order; bf16 rounds P at the same point)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.incubate.nn.kernels import flash_attention as jfa
from paddle_hackathon_tpu.incubate.nn.kernels import \
    flash_attention_packed as jfap
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention_packed as tfap

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
SMEM_LIMIT = 232_448


def _f(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# K1: the packed qkv forward past 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,d,p", [(2, 320, 0.0), (2, 384, 0.0),
                                       (1, 512, 0.0), (2, 384, 0.1)])
def test_k1_wide_forward_matches_jax_kernel(heads, d, p):
    """O and the LSE of bf16 qkv at widths the JAX plan admits (s = 64,
    batch 2, so b*H + h reaches 3 with two heads); with dropout 0.1 the
    mask is the positional hash at the global index."""
    rng = np.random.RandomState(d + heads)
    s, b = 64, 2
    assert jfap.supported(s, s, heads, d, jnp.bfloat16)
    x = (rng.randn(b, s, 3 * heads * d) * 0.5).astype(np.float32)
    sc = 1.0 / math.sqrt(d)
    seed = 77
    jx = jnp.asarray(x, jnp.bfloat16)
    j_out, j_lse = jfap._fwd(jx, heads, True, sc, p,
                             jnp.asarray([seed], jnp.int32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    fwd = tfap._by_device(tx, tfap.flash_packed_fwd_ref,
                          tfap.flash_packed_fwd_kernel)
    t_out, t_lse = fwd(tx, heads, True, sc, p, seed)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_out.float().numpy(), _f(j_out),
                               **TOL["bf16"])
    np.testing.assert_allclose(t_lse.numpy(), _f(j_lse)[:, :, 0, :],
                               **TOL["bf16"])
    # the public entry point takes the same path
    np.testing.assert_array_equal(
        tfap.flash_attention_packed(tx, heads, True, sc, p, seed)
        .float().numpy(), t_out.float().numpy())


# ---------------------------------------------------------------------------
# K2: the bhd forward past 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [264, 320, 512])
def test_k2_wide_forward_matches_jax_kernel(d, dt):
    """O and the LSE of the bhd forward (``_fwd``) at D = 264 (a tail
    slice), 320 and 512, causal with sq != skv, in f32 and bf16."""
    rng = np.random.RandomState(d)
    q = rng.randn(3, 64, d).astype(np.float32) * 0.5
    k = rng.randn(3, 128, d).astype(np.float32) * 0.5
    v = rng.randn(3, 128, d).astype(np.float32)
    sc = 1.0 / math.sqrt(d)
    tol = TOL["f32" if dt == "float32" else "bf16"]
    jargs = [jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v)]
    j_out, j_lse = jfa._fwd(*jargs, True, sc)
    targs = [torch.from_numpy(a).to(getattr(torch, dt)) for a in (q, k, v)]
    t_out, t_lse = tfa._fwd(*targs, True, sc)
    assert t_out.dtype == getattr(torch, dt)
    np.testing.assert_allclose(t_out.float().numpy(), _f(j_out), **tol)
    np.testing.assert_allclose(t_lse.numpy(), _f(j_lse)[:, 0, :], **tol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_k2_wide_forward_dropout_matches_jax_kernel(dt):
    """Dropout 0.1 at D = 320, four heads: the kept positions and their
    1/(1 - p) scale agree with the JAX kernel's hash at every bh."""
    rng = np.random.RandomState(5)
    d = 320
    q, k, v = (rng.randn(4, 64, d).astype(np.float32) * 0.5
               for _ in range(3))
    sc = 1.0 / math.sqrt(d)
    seed = -9
    tol = TOL["f32" if dt == "float32" else "bf16"]
    jargs = [jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v)]
    j_out, j_lse = jfa._fwd(*jargs, False, sc, 0.1,
                            jnp.asarray([seed], jnp.int32))
    targs = [torch.from_numpy(a).to(getattr(torch, dt)) for a in (q, k, v)]
    t_out, t_lse = tfa._fwd(*targs, False, sc, 0.1, seed)
    np.testing.assert_allclose(t_out.float().numpy(), _f(j_out), **tol)
    np.testing.assert_allclose(t_lse.numpy(), _f(j_lse)[:, 0, :], **tol)
    # dropout moves the result: the hash is not a no-op here
    t_plain, _ = tfa._fwd(*targs, False, sc)
    assert not np.allclose(t_plain.float().numpy(), t_out.float().numpy(),
                           **tol)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

def _check_tc_plan(plan, d, elem, bh, s):
    """The rules every tensor-core plan obeys."""
    assert plan["route"] == "wide_fwd_tc"
    assert plan["smem"] <= SMEM_LIMIT, (d, plan)
    # a TMA box row is the 128 bytes of the swizzle, each box edge <= 256
    assert plan["box_bytes"] == 128 == plan["box"][0] * elem
    assert max(plan["box"]) <= 256
    # the map's row stride is a multiple of 16 bytes
    assert plan["row_elems"] * elem % 16 == 0
    assert plan["slices"] * plan["slice_cols"] >= d
    assert (plan["slices"] - 1) * plan["slice_cols"] < d
    assert plan["tail"] == d % plan["slice_cols"]
    assert plan["chunks"] == -(-d // plan["chunk_cols"])
    assert plan["grid"] == (-(-s // 64) * bh * plan["chunks"], 1, 1)
    assert plan["grid"][0] <= 2 ** 31 - 1


@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_k1_plan_fits_every_jax_plan_width(s, heads):
    """Every (s, H, D) past 256 that the JAX K1 ``_plan`` admits, up to D =
    8192: the tensor-core forward's plan (256-column chunks, 64-column
    slices, q resident up to D = 1024 and streamed past it) fits."""
    admitted = 0
    for d in range(264, 8193, 8):
        for jd, td in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float16, torch.float16)):
            if jfap._plan(s, s, heads, d, jd) is None:
                continue
            admitted += 1
            assert tfap.fwd_kernel_of(d) == "wide_fwd_tc"
            plan = tfap.fwd_plan(2, s, heads, d, td)
            _check_tc_plan(plan, d, 2, 2 * heads, s)
            assert plan["row_elems"] == 3 * heads * d
            assert plan["chunk_cols"] == 256 and plan["slice_cols"] == 64
            assert plan["q_resident"] == (d <= 1024)
            assert plan["threads"] == 160
    assert admitted > 0


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [257, 264, 320, 516, 1024])
def test_k2_plan(d, dt):
    """K2's widths past 256 take the tensor-core forward within the card's
    limits: rows TMA can address (f32 D % 4 == 0, bf16 D % 8 == 0) at
    their width, the others zero-padded to the next such width."""
    dtype = getattr(torch, dt)
    elem = 4 if dt == "float32" else 2
    plan = tfa.wide_fwd_plan(12, 1000, d, dtype)
    width = tfa.padded_width(d, dtype)
    assert width * elem % 16 == 0 and 0 <= width - d < 16 // elem
    assert (width == d) == (d * elem % 16 == 0)
    assert plan["head_dim"] == width
    _check_tc_plan(plan, width, elem, 12, 1000)
    assert plan["chunk_cols"] == (128 if elem == 4 else 256)
    assert plan["threads"] == (256 if elem == 4 else 160)


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
def test_fwd_route_by_alignment(dt):
    """Every width to 1100: past 256 the tensor-core forward, at the width
    itself where a row is a multiple of 16 bytes and else zero-padded to
    the next such width; up to 256 the narrower instances (f32 rows TMA
    cannot address, e.g. D = 33, padded too: the 3xTF32 forward at 36;
    bf16/f16 on mma.sync, which reads any row).  f32 D = 514 runs at
    516."""
    dtype = getattr(torch, dt)
    elem = 4 if dt == "float32" else 2
    for d in range(1, 1101):
        aligned = d * elem % 16 == 0
        route = tfa.fwd_route(d, dtype)
        width = tfa.padded_width(d, dtype)
        if d > 256:
            assert route == "wide_fwd_tc", d
            assert (width == d) == aligned and width * elem % 16 == 0
        elif dt == "float32":
            assert route == "fwd_tc", d
            assert (width == d) == aligned and width <= 256
        else:
            assert route == "fwd_mma" and width == d, d
    assert tfa.fwd_route(514, torch.float32) == "wide_fwd_tc"
    assert tfa.padded_width(514, torch.float32) == 516
    assert tfa.fwd_route(33, torch.float32) == "fwd_tc"
    assert tfa.padded_width(33, torch.float32) == 36
    with pytest.raises(ValueError):
        tfa.wide_fwd_plan(1, 64, 128, torch.bfloat16)
