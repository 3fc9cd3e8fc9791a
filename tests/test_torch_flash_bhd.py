"""The port's bhd flash attention (``paddle_hackathon_tpu_torch``, K2)
against the JAX package's kernels run under the Pallas interpreter, as
``tests/test_incubate.py`` runs them on the CPU, on the same numpy inputs:
the plain forward (O, and the LSE against JAX's ``lse[:, 0, :]``), the
gradient through ``FlashAttentionBHD`` against ``jax.grad`` of
``flash_attention_bhd``, ``_bwd_pair`` on a kv chunk with the global LSE
and Δ, the ``flash_attention_bshd`` / ``flash_attention`` APIs, the plain
path at 65538 heads, and a plain emulation of the f32 forward kernel's
3xTF32 arithmetic (split operands, 32-column slice sums, 64-row kv tiles)
at 1e-6 relative.

Tolerances: f32 at 1e-5 (the same sums in another order); bf16 at
rtol=atol=1e-2 (both sides round P and dS to bf16 at the same points, but
the JAX kernel tiles the sums).  Dropout cases use a fixed seed: the mask
is the same bits on both sides, so they keep these tolerances.  The JAX
interpreter's grids stay small: s <= 128, and the ragged case at s=40
(8-row blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.core.tensor import Tensor
from paddle_hackathon_tpu.incubate.nn import functional as jF
from paddle_hackathon_tpu.incubate.nn.kernels import flash_attention as jfa
from paddle_hackathon_tpu_torch.incubate.nn import functional as tF
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
SEED = 1234


def _inputs(seed, bh, sq, skv, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, sq, d).astype(np.float32)
    k = rng.randn(bh, skv, d).astype(np.float32)
    v = rng.randn(bh, skv, d).astype(np.float32)
    do = rng.randn(bh, sq, d).astype(np.float32)
    return q, k, v, do


def _f(a):
    return np.asarray(a, np.float32)


# (dtype, causal, sq, skv, dropout): causal and not, sq != skv both ways,
# dropout with a fixed seed, the ragged 8-row-block length
CASES = [("f32", True, 128, 128, 0.0), ("f32", False, 64, 128, 0.0),
         ("f32", True, 64, 128, 0.0), ("f32", True, 128, 64, 0.0),
         ("f32", True, 128, 128, 0.3), ("f32", False, 40, 40, 0.2),
         ("bf16", True, 128, 128, 0.0), ("bf16", False, 128, 64, 0.0),
         ("bf16", True, 64, 128, 0.3)]


@pytest.mark.parametrize("dt,causal,sq,skv,p", CASES)
def test_fwd_matches_jax_kernel(dt, causal, sq, skv, p):
    q, k, v, _ = _inputs(sq + skv, 3, sq, skv, 32)
    jd, td = DT[dt]
    sc = 1.0 / np.sqrt(32)
    j_out, j_lse = jfa._fwd(*(jnp.asarray(x, jd) for x in (q, k, v)),
                            causal, sc, p, jnp.asarray([SEED], jnp.int32))
    t_out, t_lse = tfa._fwd(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                            causal, sc, p, SEED)
    assert t_out.dtype == td and t_lse.shape == (3, sq)
    np.testing.assert_allclose(t_out.float().numpy(), _f(j_out), **TOL[dt])
    np.testing.assert_allclose(t_lse.numpy(), _f(j_lse)[:, 0, :],
                               **TOL["f32"])


@pytest.mark.parametrize("dt,causal,sq,skv,p", CASES)
def test_grads_match_jax_kernel(dt, causal, sq, skv, p):
    q, k, v, do = _inputs(7 + sq, 2, sq, skv, 32)
    jd, td = DT[dt]
    sc = 0.2
    jseed = jnp.asarray([SEED], jnp.int32)
    jargs = [jnp.asarray(x, jd) for x in (q, k, v)]
    j_grads = jax.grad(lambda a, b, c: jnp.sum(jfa.flash_attention_bhd(
        a, b, c, causal, sc, p, jseed).astype(jnp.float32) * do),
        argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(x).to(td).requires_grad_(True)
             for x in (q, k, v)]
    out = tfa.flash_attention_bhd(*targs, causal, sc, p,
                                  torch.tensor([SEED], dtype=torch.int32))
    (out.float() * torch.from_numpy(do)).sum().backward()
    for name, t, j in zip("qkv", targs, j_grads):
        assert t.grad.dtype == td
        np.testing.assert_allclose(t.grad.float().numpy(), _f(j),
                                   err_msg=f"d{name}", **TOL[dt])


@pytest.mark.parametrize("dt,d", [("f32", 36), ("bf16", 36), ("f32", 256),
                                  ("bf16", 256)])
def test_odd_and_wide_head_dims_match_jax_kernel(dt, d):
    """A head width that is not a multiple of 8 and the widest, D = 256:
    forward and gradients, causal, sq != skv."""
    q, k, v, do = _inputs(d, 2, 64, 128, d)
    jd, td = DT[dt]
    sc = 1.0 / np.sqrt(d)
    jargs = [jnp.asarray(x, jd) for x in (q, k, v)]
    j_out, j_lse = jfa._fwd(*jargs, True, sc, 0.0, None)
    j_grads = jax.grad(lambda a, b, c: jnp.sum(jfa.flash_attention_bhd(
        a, b, c, True, sc).astype(jnp.float32) * do),
        argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(x).to(td).requires_grad_(True)
             for x in (q, k, v)]
    t_out, t_lse = tfa._fwd(*(t.detach() for t in targs), True, sc)
    np.testing.assert_allclose(t_out.float().numpy(), _f(j_out), **TOL[dt])
    np.testing.assert_allclose(t_lse.numpy(), _f(j_lse)[:, 0, :],
                               **TOL["f32"])
    out = tfa.flash_attention_bhd(*targs, True, sc)
    (out.float() * torch.from_numpy(do)).sum().backward()
    for name, t, j in zip("qkv", targs, j_grads):
        np.testing.assert_allclose(t.grad.float().numpy(), _f(j),
                                   err_msg=f"d{name}", **TOL[dt])


@pytest.mark.parametrize("d", [1, 36, 100, 129, 256])
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
def test_kernel_geometry_takes_any_head_dim_up_to_256(d, dt):
    tfa.check_geometry((3, 1000, d), (3, 1000, d), getattr(torch, dt))


def test_kernel_geometry_refuses_the_rest():
    # D = 264 is taken now (the column-chunked kernels past 256), as the
    # JAX gate, which reads only the lengths, admits it
    tfa.check_geometry((3, 64, 264), (3, 64, 264), torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.check_geometry((3, 64, 64), (3, 64, 64), torch.float64)
    with pytest.raises(RuntimeError, match="refuses"):
        tfa.check_geometry((3, 1003, 64), (3, 1003, 64), torch.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_pair_on_a_kv_chunk_matches_jax(causal):
    """The ring's unit: q against the second half of kv, with the global
    LSE and Δ of the whole-sequence forward."""
    q, k, v, do = _inputs(5, 2, 64, 128, 32)
    sc = 1.0 / np.sqrt(32)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    j_out, j_lse = jfa._fwd(jq, jk, jv, False, sc)
    delta = np.sum(np.asarray(j_out) * do, -1)
    half = slice(64, 128)
    j_dq, j_dk, j_dv = jfa._bwd_pair(jq, jk[:, half], jv[:, half], jdo,
                                     j_lse, jnp.asarray(delta), causal, sc)
    t = torch.from_numpy
    t_dq, t_dk, t_dv = tfa._bwd_pair(
        t(q), t(k[:, half]), t(v[:, half]), t(do),
        t(np.ascontiguousarray(np.asarray(j_lse)[:, 0, :])), t(delta),
        causal, sc)
    for a, b in ((t_dq, j_dq), (t_dk, j_dk), (t_dv, j_dv)):
        np.testing.assert_allclose(a.numpy(), _f(b), **TOL["f32"])


def test_bwd_pair_chunks_sum_to_the_full_gradient():
    """With the global LSE and Δ, the pair gradients over two kv halves sum
    (dq) and concatenate (dk, dv) to the full backward; and in the causal
    ring layout the second q half sees the first kv half in full and the
    second causally."""
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _inputs(6, 2, 128, 128, 32))
    sc = 0.17
    for causal in (False, True):
        out, lse = tfa._fwd(q, k, v, causal, sc)
        delta = (do * out).sum(-1)
        dq, dk, dv = tfa._bwd_pair(q, k, v, do, lse, delta, causal, sc)
        a, b = slice(0, 64), slice(64, 128)
        if not causal:
            p1 = tfa._bwd_pair(q, k[:, a], v[:, a], do, lse, delta, False, sc)
            p2 = tfa._bwd_pair(q, k[:, b], v[:, b], do, lse, delta, False, sc)
            torch.testing.assert_close(p1[0] + p2[0], dq)
            torch.testing.assert_close(torch.cat([p1[1], p2[1]], 1), dk)
            torch.testing.assert_close(torch.cat([p1[2], p2[2]], 1), dv)
            continue
        rows = (q[:, b], do[:, b], lse[:, b], delta[:, b])
        off = tfa._bwd_pair(rows[0], k[:, a], v[:, a], rows[1], rows[2],
                            rows[3], False, sc)
        diag = tfa._bwd_pair(rows[0], k[:, b], v[:, b], rows[1], rows[2],
                             rows[3], True, sc)
        torch.testing.assert_close(off[0] + diag[0], dq[:, b])
        torch.testing.assert_close(diag[1], dk[:, b])
        torch.testing.assert_close(diag[2], dv[:, b])


@pytest.mark.parametrize("causal,p", [(True, 0.0), (False, 0.0),
                                      (True, 0.25)])
def test_bshd_api_matches_jax(causal, p):
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(2, 64, 3, 16).astype(np.float32) for _ in range(3))
    jseed = jnp.asarray([SEED], jnp.int32)
    j_out = jF.flash_attention_bshd(*(Tensor(jnp.asarray(x))
                                      for x in (q, k, v)),
                                    causal=causal, dropout_p=p, seed=jseed)
    t_out = tF.flash_attention_bshd(*(torch.from_numpy(x)
                                      for x in (q, k, v)),
                                    causal=causal, dropout_p=p,
                                    seed=torch.tensor([SEED],
                                                      dtype=torch.int32))
    assert t_out.shape == (2, 64, 3, 16)
    np.testing.assert_allclose(t_out.numpy(), _f(j_out.numpy()),
                               **TOL["f32"])


def test_flash_attention_api_matches_jax():
    rng = np.random.RandomState(10)
    q, k, v = (rng.randn(1, 32, 2, 16).astype(np.float32) for _ in range(3))
    j_out, j_sm = jF.flash_attention(*(Tensor(jnp.asarray(x))
                                       for x in (q, k, v)), causal=True)
    t_out, t_sm = tF.flash_attention(*(torch.from_numpy(x)
                                       for x in (q, k, v)), causal=True)
    assert j_sm is None and t_sm is None
    np.testing.assert_allclose(t_out.numpy(), _f(j_out.numpy()),
                               **TOL["f32"])
    with pytest.raises(ValueError, match="softmax"):
        tF.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           return_softmax=True)
    # paddle's trailing ``name``, as the JAX package takes it
    j_named, _ = jF.flash_attention(*(Tensor(jnp.asarray(x))
                                      for x in (q, k, v)), 0.0, True, False,
                                    "attn")
    t_named, _ = tF.flash_attention(*(torch.from_numpy(x)
                                      for x in (q, k, v)), 0.0, True, False,
                                    "attn")
    np.testing.assert_allclose(t_named.numpy(), _f(j_named.numpy()),
                               **TOL["f32"])
    torch.testing.assert_close(t_named, t_out, rtol=0, atol=0)


def test_refused_length_raises_value_error():
    x = np.zeros((1, 1003, 2, 16), np.float32)
    assert not tfa.supported(1003, 1003) and not jfa.supported(1003, 1003)
    with pytest.raises(ValueError, match="unsupported"):
        jF.flash_attention_bshd(*(Tensor(jnp.asarray(x)) for _ in range(3)))
    with pytest.raises(ValueError, match="unsupported"):
        tF.flash_attention_bshd(*(torch.from_numpy(x) for _ in range(3)))


@pytest.mark.parametrize("b,h", [(1, 3), (1, 1), (2, 3)])
def test_bshd_hands_the_kernels_contiguous_tensors(monkeypatch, b, h):
    """q, k and v as strided views of one fused (b, s, 3, h, d) projection,
    as GPT's qkv gives them: at b == 1 (or h == 1) the move to (b*h, s, d)
    can be a view, and the kernels take contiguous tensors only."""
    rng = np.random.RandomState(11)
    fused = torch.from_numpy(rng.randn(b, 64, 3, h, 16).astype(np.float32))
    seen = []
    real = tfa.flash_attention_bhd

    def spy(q, k, v, *args):
        seen.extend(t.is_contiguous() for t in (q, k, v))
        return real(q, k, v, *args)

    monkeypatch.setattr(tfa, "flash_attention_bhd", spy)
    views = [fused[:, :, i] for i in range(3)]
    out = tF.flash_attention_bshd(*views, causal=True)
    assert seen == [True] * 3
    ref = tF.flash_attention_bshd(*(x.contiguous() for x in views),
                                  causal=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_dropout_seed_is_drawn_and_keys_the_mask():
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 64, 2, 16)
                         .astype(np.float32))
    a = tF.flash_attention_bshd(x, x, x, dropout_p=0.3, seed=5)
    b = tF.flash_attention_bshd(x, x, x, dropout_p=0.3, seed=5)
    c = tF.flash_attention_bshd(x, x, x, dropout_p=0.3, seed=6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 0
    drawn = tF.flash_attention_bshd(x, x, x, dropout_p=0.3)
    assert drawn.shape == x.shape and torch.isfinite(drawn).all()


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """The wrappers raise RuntimeError (never ValueError, the gate's
    signal) for a tensor they cannot take, and the entry points refuse a
    device that is neither the CPU nor CUDA."""
    x = torch.zeros(2, 64, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_fwd_kernel(x, x, x, True, 0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_dq_kernel(x, x, x, x, x[..., 0], x[..., 0], True, 0.125)
    with pytest.raises(RuntimeError, match="device"):
        tfa.flash_attention_bhd(*(x.to("meta") for _ in range(3)), True,
                                0.125)


def fwd_3xtf32_emulation(q, k, v, causal, sm_scale, terms=3):
    """The f32 forward kernel's arithmetic in plain torch f32: S summed
    over 32-column slices, each slice one sum of al.bh + ah.bl + ah.bh
    (``tfa.tf32_split``'s operands; ``terms=1``: ah.bh alone); the online
    softmax over 64-row kv tiles in log2 units, -1e30 before the max, l
    over p; each tile's P.V (P split as well) per 32-column chunk of O,
    added to the rescaled O.  Returns (O, LSE)."""
    bh, sq, d = q.shape
    skv = k.shape[1]

    def mm(eq, a, b):
        (ah, al), (bh_, bl) = tfa.tf32_split(a), tfa.tf32_split(b)
        if terms == 1:
            return torch.einsum(eq, ah, bh_)
        return (torch.einsum(eq, al, bh_) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, ah, bh_))

    sc = torch.zeros(bh, sq, skv)
    for c0 in range(0, d, 32):
        sc = sc + mm("bqd,bkd->bqk", q[..., c0:c0 + 32], k[..., c0:c0 + 32])
    sc = sc * (sm_scale * 1.4426950408889634)
    rows = torch.arange(sq)[:, None]
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(bh, sq, 1)
    o = torch.zeros(bh, sq, d)
    for j0 in range(0, skv, 64):
        cols = torch.arange(j0, min(j0 + 64, skv))[None, :]
        x = sc[..., j0:j0 + 64]
        if causal:
            x = x.masked_fill(cols > rows, -1e30)
        m_next = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(x - m_next)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.cat([mm("bqk,bkd->bqd", p, v[:, j0:j0 + 64, c0:c0 + 32])
                        for c0 in range(0, d, 32)], -1)
        o = o * alpha + pv
        m = m_next
    lse = m * 0.6931471805599453 + torch.log(l.clamp_min(1e-30))
    return o / torch.where(l == 0.0, 1.0, l), lse.squeeze(-1)


@pytest.mark.parametrize("causal,sq,skv,d", [
    (True, 128, 128, 64), (False, 64, 128, 64), (True, 128, 64, 64),
    (True, 192, 192, 40), (False, 128, 192, 96)])
def test_3xtf32_forward_emulation_matches_jax_kernel(causal, sq, skv, d):
    """O and LSE within 1e-6 relative (L2) of JAX's f32 forward; the same
    emulation with one tf32 product (ah.bh) reads far outside it."""
    q, k, v, _ = _inputs(11 + sq + d, 2, sq, skv, d)
    sc = 1.0 / np.sqrt(d)
    j_out, j_lse = jfa._fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, sc)
    j_out, j_lse = _f(j_out), _f(j_lse)[:, 0, :]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = fwd_3xtf32_emulation(*t, causal, sc)
    assert rel(out.numpy(), j_out) <= 1e-6
    assert rel(lse.numpy(), j_lse) <= 1e-6
    one, _ = fwd_3xtf32_emulation(*t, causal, sc, terms=1)
    assert rel(one.numpy(), j_out) > 1e-5


def test_plain_path_at_65538_heads_matches_jax_kernel():
    """b*H = 65538 (past the 65535 of a grid's y dimension, which the
    kernels no longer use for it): the geometry is taken, and the plain
    forward and dK/dV + dQ pair over all heads agree on the last two with
    the JAX kernels run on those two."""
    bh, s, d = 65538, 8, 8
    for dt in (torch.float32, torch.bfloat16):
        tfa.check_geometry((bh, s, d), (bh, s, d), dt)
    q, k, v, do = _inputs(12, bh, s, s, d)
    sc = 1.0 / np.sqrt(d)
    t = torch.from_numpy
    t_out, t_lse = tfa._fwd(t(q), t(k), t(v), True, sc)
    t_delta = (t_out * t(do)).sum(-1)
    t_grads = tfa._bwd_pair(t(q), t(k), t(v), t(do), t_lse, t_delta, True, sc)
    tail = slice(bh - 2, bh)
    jq, jk, jv, jdo = (jnp.asarray(x[tail]) for x in (q, k, v, do))
    j_out, j_lse = jfa._fwd(jq, jk, jv, True, sc)
    np.testing.assert_allclose(t_out[tail].numpy(), _f(j_out), **TOL["f32"])
    np.testing.assert_allclose(t_lse[tail].numpy(), _f(j_lse)[:, 0, :],
                               **TOL["f32"])
    j_grads = jfa._bwd_pair(jq, jk, jv, jdo, j_lse,
                            jnp.asarray(t_delta[tail].numpy()), True, sc)
    for a, b in zip(t_grads, j_grads):
        np.testing.assert_allclose(a[tail].numpy(), _f(b), **TOL["f32"])
