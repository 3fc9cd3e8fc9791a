"""K2's bf16/f16 kernels up to head width 256 (``csrc/flash_tc.cuh`` with
``PACKED = false``: K1's TMA + wgmma bodies on ``(BH, S, D)`` tensors), as
far as the CPU can pin them.

- Every row runs at :func:`padded_width`: bf16/f16 D = 36 and 100 go to
  40 and 104 with zero columns and come back cut.  The plain forward and
  pair on the padded inputs, with the caller's ``sm_scale`` (1/sqrt of the
  unpadded D), cut back, equal them on the unpadded inputs bit for bit in
  their f32 arithmetic: zero columns add exact zeros to every score and to
  dP.
- The kernels' shared memory (:func:`tc16_smem`, the mirror of
  ``ftc::smem_bytes<DP, false>``, which the card holds to the library's
  export) fits the card's 232,448 bytes at 64, 128 and 256.
- The plain pair in bf16 at D = 128, where 1/sqrt(128) is no power of two,
  against the JAX ``_bwd_pair`` under the Pallas interpreter: both round
  the scaled dS = P (dP - Δ) sm_scale to bf16 before dK and dQ, so they
  agree within one bf16 ulp of each gradient's largest magnitude (the sums
  run in another order)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.incubate.nn.kernels import flash_attention as jfa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa

SEED = 77


def _inputs(d, dt, sq, skv, bh=2, seed=0):
    rng = np.random.RandomState(d + seed)
    return [torch.from_numpy(rng.randn(bh, n, d).astype(np.float32) * 0.5)
            .to(dt) for n in (sq, skv, skv, sq)]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,p", [(36, 0.0), (100, 0.1)])
def test_padded_16bit_rows_cut_back_are_the_unpadded(d, dt, p):
    """bf16/f16 rows TMA cannot address (72 and 200 bytes) at the padded
    width, causal with sq=64 < skv=128: O, the LSE, dq, dk and dv of the
    plain versions on zero-padded inputs, cut back, are those on the
    unpadded inputs, bit for bit, with the caller's scale."""
    w = tfa.padded_width(d, dt)
    assert w == -(-d // 8) * 8 and w > d
    assert tfa.fwd_route(d, dt) == "fwd_tc16"
    assert tfa.bwd_route(d, dt) == "tc16"
    q, k, v, do = _inputs(d, dt, 64, 128)
    sc = 1.0 / math.sqrt(d)
    padded = [tfa._pad(t, w) for t in (q, k, v, do)]
    o, lse = tfa.flash_fwd_ref(q, k, v, True, sc, p, SEED)
    po, plse = tfa.flash_fwd_ref(*padded[:3], True, sc, p, SEED)
    assert torch.equal(tfa._cut(po, d), o) and torch.equal(plse, lse)
    delta = (do.float() * o.float()).sum(-1)
    ref = tfa.flash_bwd_pair_ref(q, k, v, do, lse, delta, True, sc, p, SEED)
    got = tfa.flash_bwd_pair_ref(*padded, lse, delta, True, sc, p, SEED)
    for g, r in zip(got, ref):
        assert g.dtype == dt and torch.equal(tfa._cut(g, d), r)


@pytest.mark.parametrize("d", [8, 64, 100, 128, 200, 256])
def test_tc16_smem_fits_the_card(d):
    """The three kernels' dynamic shared memory at the padded width's
    instance fits a block's 232,448 bytes; the forward keeps two q buffers
    up to 128 columns (one at 256), the backward 128-row blocks up to 128
    (64 at 256); past 256 there is no such instance."""
    dp = next(w for w in (64, 128, 256) if d <= w)
    tile = dp // 64 * 64 * 128
    sizes = {kn: tfa.tc16_smem(d, kn) for kn in ("fwd", "dkdv", "dq")}
    for kn, n in sizes.items():
        assert 0 < n <= tfa.SMEM_LIMIT, (d, kn, n)
    q_bufs = 2 if dp <= 128 else 1
    assert sizes["fwd"] > q_bufs * 2 * tile
    # dK/dV holds 64 LSE and 64 Δ floats a stage more than dQ
    stages = 2 if dp > 128 else 3
    assert sizes["dkdv"] - sizes["dq"] == stages * 2 * 64 * 4
    with pytest.raises(ValueError):
        tfa.tc16_smem(264, "fwd")
    with pytest.raises(ValueError):
        tfa.tc16_smem(64, "dk")


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``x``."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_pair_rounds_the_scaled_ds_as_jax(causal):
    """bf16 at D = 128 (sm_scale = 1/sqrt(128), not a power of two), sq =
    skv = 64 with the JAX forward's LSE and Δ: the plain pair's dq, dk and
    dv within one bf16 ulp of each gradient's scale of the JAX
    ``_bwd_pair``'s."""
    d = 128
    q, k, v, do = _inputs(d, torch.bfloat16, 64, 64, seed=3)
    sc = 1.0 / math.sqrt(d)
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do)]
    j_out, j_lse = jfa._fwd(*j[:3], causal, sc)
    delta = np.sum(np.asarray(j_out, np.float32) * do.float().numpy(), -1)
    j_grads = jfa._bwd_pair(*j, j_lse, jnp.asarray(delta), causal, sc)
    lse = torch.from_numpy(np.ascontiguousarray(
        np.asarray(j_lse, np.float32)[:, 0, :]))
    t_delta = torch.from_numpy(delta)
    t_grads = tfa._bwd_pair(q, k, v, do, lse, t_delta, causal, sc)
    for name, t, jg in zip(("dq", "dk", "dv"), t_grads, j_grads):
        jg = np.asarray(jg, np.float32)
        assert t.dtype == torch.bfloat16
        err = float(np.abs(t.float().numpy() - jg).max())
        assert err <= _bf16_ulp(jg), (name, err, _bf16_ulp(jg))
