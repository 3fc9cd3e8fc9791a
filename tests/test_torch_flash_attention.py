"""The port's packed flash attention (``paddle_hackathon_tpu_torch``)
against the JAX package's kernels K1, run under the Pallas interpreter as
``tests/test_incubate.py`` runs them on the CPU: the dropout hash bit for
bit, the shape gates of K1 and K2, the plain forward (O and LSE) and the
gradient through ``FlashAttentionPacked`` against ``jax.grad`` of
``flash_attention_packed`` on the same numpy inputs.

Tolerances: f32 at 1e-5 (the same sums in another order).  bf16 at
rtol=atol=1e-2, tighter than ``test_incubate.py``'s kernel-vs-f32 bounds
(fwd 0.05/0.02, grads 0.1/0.05): at s=128 the JAX plan is one 128-row
block, so both sides round at the same points."""

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


def test_dropout_hash_is_bitwise_jax():
    """Negative seeds, keys past 2**15, positions past 2**15, and the
    keep probabilities the model uses."""
    rng = np.random.RandomState(0)
    seeds = np.asarray([0, 1, -1, 1234, -2**31, 2**31 - 1, 99991], np.int32)
    bh = np.asarray([0, 3, 40000], np.int32)
    q = np.concatenate([np.arange(0, 70), rng.randint(0, 2**20, 30)]
                       ).astype(np.int32)
    k = np.concatenate([np.arange(0, 50), [32767, 32768, 65535, 2**20]]
                       ).astype(np.int32)
    S, B, Q, K = np.meshgrid(seeds, bh, q, k, indexing="ij")
    for keep in (0.9, 0.7, 0.5):
        ref = np.asarray(jfa._dropout_keep(jnp.asarray(S), jnp.asarray(B),
                                           jnp.asarray(Q), jnp.asarray(K),
                                           keep))
        out = tfa.dropout_keep(torch.from_numpy(S), torch.from_numpy(B),
                               torch.from_numpy(Q), torch.from_numpy(K),
                               keep).numpy()
        np.testing.assert_array_equal(out, ref)
        assert 0.4 < out.mean() < 1.0


@pytest.mark.parametrize("shape", [
    (1024, 1024, 12, 64, "bfloat16"), (1024, 1024, 12, 64, "float32"),
    (1003, 1003, 12, 64, "bfloat16"), (1024, 1024, 3, 20, "bfloat16"),
    (1000, 1000, 2, 64, "bfloat16"), (8, 8, 4, 16, "float32"),
    (8, 8, 2, 64, "float16"), (4, 4, 4, 16, "float32"),
    (256, 256, 4, 32, "bfloat16"), (128, 128, 2, 64, "float32")])
def test_shape_gates_match_jax(shape):
    sq, skv, heads, d, dt = shape
    assert tfap.supported(sq, skv, heads, d, getattr(torch, dt)) == \
        jfap.supported(sq, skv, heads, d, getattr(jnp, dt))
    assert tfap._plan(sq, skv, heads, d, getattr(torch, dt)) == \
        jfap._plan(sq, skv, heads, d, getattr(jnp, dt))
    assert tfa.supported(sq, skv) == jfa.supported(sq, skv)
    assert tfa._block_sizes(sq, skv) == jfa._block_sizes(sq, skv)


def _inputs(seed, B=1, S=128, H=2, D=64):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, S, 3 * H * D) * 0.5).astype(np.float32)
    cot = rng.randn(B, S, H * D).astype(np.float32)
    return x, cot


@pytest.mark.parametrize("dt,causal,p", [
    ("f32", True, 0.0), ("f32", False, 0.0), ("f32", True, 0.3),
    ("bf16", True, 0.0), ("bf16", False, 0.0), ("bf16", True, 0.3)])
def test_fwd_and_grad_match_jax_kernel(dt, causal, p):
    _match_jax_kernel(dt, causal, p, *_inputs(1 if causal else 2))


@pytest.mark.parametrize("dt,causal", [("f32", True), ("bf16", True),
                                       ("bf16", False)])
def test_head_dim_256_fwd_and_grad_match_jax_kernel(dt, causal):
    """The widest head the kernels take, D = 256 (JAX plan (64, 64, 1))."""
    _match_jax_kernel(dt, causal, 0.0, *_inputs(3, S=64, H=1, D=256), H=1,
                      D=256)


def _match_jax_kernel(dt, causal, p, x, cot, H=2, D=64):
    seed = -77
    jd, td = (jnp.float32, torch.float32) if dt == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    sc = 1.0 / np.sqrt(D)
    jx = jnp.asarray(x, jd)
    jseed = jnp.asarray([seed], jnp.int32)
    j_out, j_lse = jfap._fwd(jx, H, causal, sc, p, jseed)
    j_grad = jax.grad(lambda a: jnp.sum(jfap.flash_attention_packed(
        a, H, causal, sc, p, jseed).astype(jnp.float32) * cot))(jx)

    tx = torch.from_numpy(x).to(td)
    t_out, t_lse = tfap.flash_packed_fwd_ref(tx, H, causal, sc, p, seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    np.testing.assert_allclose(t_out.float().numpy(), f(j_out), **TOL[dt])
    np.testing.assert_allclose(t_lse.numpy(), f(j_lse)[:, :, 0],
                               **TOL["f32"])
    tx.requires_grad_(True)
    out = tfap.flash_attention_packed(
        tx, H, causal, sc, p, torch.tensor([seed], dtype=torch.int32))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.float().numpy(), f(j_grad),
                               **TOL[dt])


def test_dropout_seed_changes_the_mask_and_is_deterministic():
    x, _ = _inputs(3, S=64)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    a = tfap.flash_attention_packed(tx, 2, True, 0.125, 0.3, 5)
    b = tfap.flash_attention_packed(tx, 2, True, 0.125, 0.3, 5)
    c = tfap.flash_attention_packed(tx, 2, True, 0.125, 0.3, 6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a.float() - c.float()).abs().max() > 0


def test_functional_gate_and_seed_draw():
    x, _ = _inputs(4, S=64)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention_qkv_packed(torch.from_numpy(x), 2)   # f32
    tx = torch.from_numpy(x).to(torch.bfloat16)
    out = flash_attention_qkv_packed(tx, 2, dropout_p=0.2)
    assert out.shape == (1, 64, 128) and torch.isfinite(out.float()).all()
    ref = flash_attention_qkv_packed(tx, 2)
    torch.testing.assert_close(
        ref, tfap.flash_attention_packed(tx, 2, True, 0.125), rtol=0, atol=0)


@pytest.mark.parametrize("H,D,dt", [(1, 256, "bfloat16"),
                                    (2, 192, "float16"), (4, 8, "bfloat16"),
                                    (2, 136, "bfloat16")])
def test_kernel_geometry_takes_heads_up_to_256(H, D, dt):
    tfap.check_geometry((2, 65, 3 * H * D), H, getattr(torch, dt))


@pytest.mark.parametrize("H,D,dt", [(1, 264, "bfloat16"), (2, 36, "bfloat16"),
                                    (1, 64, "float32")])
def test_kernel_geometry_refuses_the_rest(H, D, dt):
    with pytest.raises(ValueError):
        tfap.check_geometry((2, 65, 3 * H * D), H, getattr(torch, dt))


def test_kernel_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(1, 64, 3 * 2 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfap.flash_packed_fwd_kernel(x, 2, True, 0.125)
    with pytest.raises(ValueError, match="device"):
        tfap.flash_attention_packed(x.to("meta"), 2, True, 0.125)


# The backward kernels' scale folding (``scale_folds``): with bf16 and a
# power-of-two rounded scale they read q and k unscaled and apply the scale
# to the f32 products.  That equals the JAX rounding points (q * scale and
# k * scale rounded to bf16 before the products) because (1) the rounding
# is exact: bf16 shares f32's exponent range, so only results below bf16's
# smallest normal (2**-126) lose bits, and (2) a power of two commutes with
# every rounding of an f32 sum.

BF16_MIN_NORMAL = 2.0 ** -126


@pytest.mark.parametrize("scale", [2.0 ** -2, 2.0 ** -3, 2.0 ** -4])
def test_bf16_times_power_of_two_rounds_to_itself(scale):
    """All 65,536 bf16 bit patterns q: bf16(q * scale) == q * scale in f32,
    except where 0 < |q * scale| < 2**-126 (a bf16 subnormal result)."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    q = bits.view(torch.bfloat16).float()
    exact = q * scale                       # f32: exact down to 2**-149
    rounded = exact.to(torch.bfloat16).float()
    same = (rounded == exact) | (torch.isnan(rounded) & torch.isnan(exact))
    exceptions = (exact.abs() > 0) & (exact.abs() < BF16_MIN_NORMAL)
    assert bool((same | exceptions).all())
    # the exceptions are real: some subnormal results do round
    assert bool((~same & exceptions).any())
    assert int(exceptions.sum()) < 2 ** 12


@pytest.mark.parametrize("scale", [2.0 ** -2, 2.0 ** -3])
@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (64, 64, 128),
                                   (128, 64, 40)])
def test_f32_products_scaled_after_the_sum_are_bitwise(scale, m, n, k):
    """(a * scale) @ b == (a @ b) * scale bit for bit in f32 for bf16-valued
    tiles: S^T = K (q*s)^T, dK = dS^T (q*s) and dQ = dS (k*s) as the
    kernels fold them."""
    rng = np.random.RandomState(m + n + k)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32) * 0.5)
    b = torch.from_numpy(rng.randn(k, n).astype(np.float32))
    a, b = (t.to(torch.bfloat16).float() for t in (a, b))
    before = torch.matmul((a * scale).to(torch.bfloat16).float(), b)
    after = torch.matmul(a, b) * scale
    assert torch.equal(before, after)
    # and the scale on the other operand (dQ = dS . (k * s))
    assert torch.equal(torch.matmul(b.T, (a * scale).T),
                       torch.matmul(b.T, a.T) * scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 192, 256])
def test_scale_fold_decision(dtype, d):
    """Only bf16 at a power-of-two rounded 1/sqrt(D) folds: D = 16, 64 and
    256 of the widths the kernels take; f16 always scales its tiles."""
    folds = tfap.scale_folds(getattr(torch, dtype), 1.0 / np.sqrt(d))
    assert folds == (dtype == "bfloat16" and d in (16, 64, 256))
