"""The port's ``nn.functional.scaled_dot_product_attention`` against the
JAX package's on the same numpy inputs (f32, tolerance 1e-5: the same
sums in other orders), for each flash request (``use_flash`` True, None
and False), with and without an additive mask, at a length the bhd gate
takes (64) and one it refuses (60); the flash path runs the JAX kernel
under the Pallas interpreter and the port's plain version on the CPU.
And the dispatch itself: SDPA catches only the gate's ``ValueError``; a
kernel that fails propagates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.core import flags as jflags
from paddle_hackathon_tpu.core.tensor import Tensor
from paddle_hackathon_tpu.nn import functional as jF
from paddle_hackathon_tpu_torch.core import flags as tflags
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa
from paddle_hackathon_tpu_torch.nn import functional as tF

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(s, seed=0, b=2, h=2, d=16):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    mask = np.where(rng.rand(b, 1, s, s) < 0.2, -1e4, 0.0).astype(np.float32)
    return q, k, v, mask


@pytest.mark.parametrize("s", [64, 60])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("use_flash", [True, None, False])
def test_values_match_jax(use_flash, with_mask, s):
    q, k, v, mask = _inputs(s, seed=s)
    jm = Tensor(jnp.asarray(mask)) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None
    ref = jF.scaled_dot_product_attention(
        *(Tensor(jnp.asarray(x)) for x in (q, k, v)), attn_mask=jm,
        is_causal=True, use_flash=use_flash)
    out = tF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), attn_mask=tm,
        is_causal=True, use_flash=use_flash)
    assert out.shape == (2, s, 2, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()), **TOL)


@pytest.fixture
def min_seqlen_64():
    for f in (jflags, tflags):
        f.set_flags({"flash_attention_min_seqlen": 64})
    yield
    for f in (jflags, tflags):
        f.set_flags({"flash_attention_min_seqlen": 1024})


def _count_fwd(monkeypatch):
    calls = []
    real = tfa._fwd

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "_fwd", counted)
    return calls


def test_auto_request_takes_the_kernels_at_the_crossover(min_seqlen_64,
                                                         monkeypatch):
    """use_flash=None asks for flash at s >= flash_attention_min_seqlen,
    as in JAX; below it, or with use_fused_kernels off, the plain path."""
    calls = _count_fwd(monkeypatch)
    q, k, v, _ = _inputs(64, seed=3)
    ref = jF.scaled_dot_product_attention(
        *(Tensor(jnp.asarray(x)) for x in (q, k, v)), is_causal=True)
    out = tF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()), **TOL)
    assert calls == [(4, 64, 16)]
    x = torch.from_numpy(q[:, :56])
    tF.scaled_dot_product_attention(x, x, x, is_causal=True)
    try:
        tflags.set_flags({"use_fused_kernels": False})
        tF.scaled_dot_product_attention(*(torch.from_numpy(a)
                                          for a in (q, k, v)))
    finally:
        tflags.set_flags({"use_fused_kernels": True})
    assert len(calls) == 1


def test_kernel_failure_propagates(monkeypatch):
    """A RuntimeError from the kernel path (a build or launch failure) is
    not caught into the plain composition."""
    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(tfa, "_fwd", broken)
    q, k, v, _ = _inputs(64, seed=4)
    with pytest.raises(RuntimeError, match="launch failed"):
        tF.scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True,
            use_flash=True)


def test_refused_length_takes_the_plain_path(monkeypatch):
    calls = _count_fwd(monkeypatch)
    q, k, v, _ = _inputs(60, seed=5)
    out = tF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True,
        use_flash=True)
    assert calls == [] and out.shape == (2, 60, 2, 16)


def test_plain_dropout_follows_the_default_generator():
    from paddle_hackathon_tpu_torch.core import random as trandom
    q, k, v, _ = _inputs(60, seed=6)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    outs = []
    for _ in range(2):
        trandom.seed(11)
        outs.append(tF.scaled_dot_product_attention(*args, dropout_p=0.5))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    evalo = tF.scaled_dot_product_attention(*args, dropout_p=0.5,
                                            training=False)
    assert (outs[0] - evalo).abs().max() > 0


def test_sequence_mask_matches_jax():
    lengths = np.asarray([0, 3, 5], np.int64)
    ref = jF.sequence_mask(Tensor(jnp.asarray(lengths)), maxlen=6)
    out = tF.sequence_mask(torch.from_numpy(lengths), maxlen=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref.numpy()))
    assert out.dtype == torch.int64
    assert tF.sequence_mask(torch.tensor([2, 4])).shape == (2, 4)
