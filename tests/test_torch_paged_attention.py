"""The port's paged attention (``paddle_hackathon_tpu_torch``) against the
JAX package's: the plain PyTorch version against the jnp reference and
against the Pallas decode kernel run under the Pallas interpreter, the
in-place page write against the functional one, and the wrapper's
argument checks and device dispatch.  f32 throughout, ``rtol=atol=2e-5``
(two frameworks summing the same products in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.incubate.nn.kernels import paged_attention as jpa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, B, s, P, H, D, maxp, lengths):
    """Random pools, a shuffled page table (page 0 never mapped) and
    queries, as numpy."""
    rng = np.random.RandomState(seed)
    N = 1 + B * maxp
    pt = (rng.permutation(N - 1) + 1)[:B * maxp].reshape(B, maxp)
    return dict(
        q=rng.randn(B, s, H, D).astype(np.float32),
        k_pool=rng.randn(N, P, H, D).astype(np.float32),
        v_pool=rng.randn(N, P, H, D).astype(np.float32),
        page_table=pt.astype(np.int32),
        lengths=np.asarray(lengths, np.int32))


def _jax(case):
    return {k: jnp.asarray(v) for k, v in case.items()}


def _torch(case):
    return {k: torch.from_numpy(v.copy()) for k, v in case.items()}


@pytest.mark.parametrize("width,lengths", [
    (1, [5, 13, 0]),          # ragged, an empty slot
    (1, [3, 4, 15]),          # last row of a page, first of the next, last row
    (4, [2, 0, 12]),          # 2..5 straddles the page boundary at 4
    (4, [7, 9, 1]),
])
def test_ref_matches_jax_reference(width, lengths):
    case = _case(0, B=3, s=width, P=4, H=2, D=8, maxp=4, lengths=lengths)
    ref = np.asarray(jpa.paged_attention_ref(**_jax(case)))
    out = tpa.paged_attention_ref(**_torch(case)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("width,P,D", [(128, 128, 16), (65, 16, 36),
                                       (2, 128, 36)])
def test_wide_chunks_and_long_pages_match_jax_reference(width, P, D):
    """A prefill chunk of 128 rows over pages of 128, a width past one
    64-row stage, and a head width that is not a multiple of 8."""
    case = _case(5, B=2, s=width, P=P, H=2, D=D, maxp=3,
                 lengths=[0, 3 * P - width - 5])
    ref = np.asarray(jpa.paged_attention_ref(**_jax(case)))
    out = tpa.paged_attention_ref(**_torch(case)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("lengths", [[11, 0], [7, 23], [8, 16]])
def test_ref_matches_jax_decode_kernel_under_interpreter(lengths):
    """Width 1 against the Pallas kernel itself, as the JAX package's own
    test runs it on the CPU (the Pallas interpreter)."""
    case = _case(1, B=2, s=1, P=8, H=2, D=16, maxp=3, lengths=lengths)
    ref = np.asarray(jpa.paged_attention_decode(**_jax(case)))
    out = tpa.paged_attention_ref(**_torch(case)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("pos", [[3, 0], [6, 9]])
def test_paged_write_matches_jax_exactly(pos):
    """One scatter covers every slot; a window straddling a page boundary
    splits across two physical pages.  Exact."""
    rng = np.random.RandomState(2)
    P, H, D, B, s, maxp = 4, 2, 8, 2, 3, 4
    N = 1 + B * maxp
    pool = rng.randn(N, P, H, D).astype(np.float32)
    pt = (rng.permutation(N - 1) + 1).reshape(B, maxp).astype(np.int32)
    vals = rng.randn(B, s, H, D).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    ref = np.asarray(jpa.paged_write(jnp.asarray(pool), jnp.asarray(vals),
                                     jnp.asarray(pt), jnp.asarray(pos)))
    t_pool = torch.from_numpy(pool.copy())
    out = tpa.paged_write(t_pool, torch.from_numpy(vals),
                          torch.from_numpy(pt), torch.from_numpy(pos))
    assert out is t_pool                       # in place
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cpu_dispatch_takes_the_plain_version():
    case = _torch(_case(3, B=2, s=1, P=8, H=2, D=16, maxp=3,
                        lengths=[9, 2]))
    before = tpa.launches
    out = tpa.paged_attention(**case)
    torch.testing.assert_close(out, tpa.paged_attention_ref(**case),
                               rtol=0, atol=0)
    assert tpa.launches == before              # no kernel launch counted


def test_kernel_refuses_cpu_tensors():
    case = _torch(_case(3, B=2, s=1, P=8, H=2, D=16, maxp=3,
                        lengths=[9, 2]))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_kernel(**case)


def _bad(kind):
    c = _torch(_case(4, B=2, s=2, P=8, H=2, D=16, maxp=3, lengths=[1, 2]))
    if kind == "head_dim_over_256":
        c["q"] = torch.zeros(2, 2, 1, 264)
        c["k_pool"] = c["v_pool"] = torch.zeros(7, 8, 1, 264)
    elif kind == "empty_width":
        c["q"] = torch.zeros(2, 0, 2, 16)
    elif kind == "dtype_mismatch":
        c["k_pool"] = c["k_pool"].to(torch.bfloat16)
    elif kind == "int64_page_table":
        c["page_table"] = c["page_table"].long()
    elif kind == "lengths_shape":
        c["lengths"] = c["lengths"][:1]
    elif kind == "non_contiguous_q":
        c["q"] = c["q"].transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "pool_shape":
        c["v_pool"] = c["v_pool"][:, :4].contiguous()
    return c


@pytest.mark.parametrize("kind", [
    "head_dim_over_256", "empty_width", "dtype_mismatch", "int64_page_table",
    "lengths_shape", "non_contiguous_q", "pool_shape"])
def test_kernel_argument_checks(kind):
    with pytest.raises(ValueError):
        tpa.check_kernel_args(**_bad(kind))


@pytest.mark.parametrize("s,P,D", [(128, 128, 64), (256, 256, 64),
                                   (65, 16, 64), (1, 16, 36), (32, 128, 12),
                                   (1, 8, 256)])
def test_kernel_geometry_takes_any_width_page_and_head_dim(s, P, D):
    """Widths past 64, pages past 64 and head widths that are not a
    multiple of 8 (up to 256): the limits of earlier versions."""
    pool = (7, P, 2, D)
    tpa.check_geometry((2, s, 2, D), (pool, pool), (torch.bfloat16,) * 3,
                       (2, 3), torch.int32, (2,), torch.int32)


def test_kernel_argument_checks_accept_the_serving_shapes():
    q = torch.zeros(16, 32, 12, 64, dtype=torch.bfloat16)
    pool = torch.zeros(257, 16, 12, 64, dtype=torch.bfloat16)
    tpa.check_kernel_args(q, pool, pool.clone(),
                          torch.zeros(16, 32, dtype=torch.int32),
                          torch.zeros(16, dtype=torch.int32))
