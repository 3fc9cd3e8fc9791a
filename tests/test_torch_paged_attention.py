"""The port's paged attention (``paddle_hackathon_tpu_torch``) against the
JAX package's: the plain PyTorch version against the jnp reference and
against the Pallas decode kernel run under the Pallas interpreter, the
in-place page write against the functional one, the wrapper's argument
checks, routing and device dispatch, and a plain emulation of the split
decode kernel's arithmetic (chunks of rows, partials merged in order)
against the JAX kernel and reference.  f32 at ``rtol=atol=2e-5`` (two
frameworks summing the same products in different orders), bf16 at
2e-2."""

import math

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
    before = dict(tpa.launches)
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
    if kind == "zero_head_dim":
        c["q"] = torch.zeros(2, 2, 1, 0)
        c["k_pool"] = c["v_pool"] = torch.zeros(7, 8, 1, 0)
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
    "zero_head_dim", "empty_width", "dtype_mismatch", "int64_page_table",
    "lengths_shape", "non_contiguous_q", "pool_shape"])
def test_kernel_argument_checks(kind):
    with pytest.raises(ValueError):
        tpa.check_kernel_args(**_bad(kind))


@pytest.mark.parametrize("s,P,D", [(128, 128, 64), (256, 256, 64),
                                   (65, 16, 64), (1, 16, 36), (32, 128, 12),
                                   (1, 8, 256), (1, 8, 264), (64, 16, 512)])
def test_kernel_geometry_takes_any_width_page_and_head_dim(s, P, D):
    """Widths past 64, pages past 64, head widths that are not a multiple
    of 8 and past 256: the limits of earlier versions."""
    pool = (7, P, 2, D)
    tpa.check_geometry((2, s, 2, D), (pool, pool), (torch.bfloat16,) * 3,
                       (2, 3), torch.int32, (2,), torch.int32)


def test_kernel_argument_checks_accept_the_serving_shapes():
    q = torch.zeros(16, 32, 12, 64, dtype=torch.bfloat16)
    pool = torch.zeros(257, 16, 12, 64, dtype=torch.bfloat16)
    tpa.check_kernel_args(q, pool, pool.clone(),
                          torch.zeros(16, 32, dtype=torch.int32),
                          torch.zeros(16, dtype=torch.int32))


def test_kernel_geometry_takes_any_slot_count():
    """65538 slots: past the 65535 of a grid's y and z dimensions, which
    the launches no longer use for the slot."""
    pool = (65539, 16, 2, 64)
    tpa.check_geometry((65538, 1, 2, 64), (pool, pool),
                       (torch.bfloat16,) * 3, (65538, 1), torch.int32,
                       (65538,), torch.int32)


@pytest.mark.parametrize("s,D,dtype,split", [
    (1, 64, torch.bfloat16, True), (15, 256, torch.float16, True),
    (1, 64, torch.float32, True), (16, 64, torch.bfloat16, False),
    (1, 36, torch.bfloat16, False), (1, 320, torch.float32, False),
    (2, 4, torch.float32, True)])
def test_routing_sends_decode_widths_to_the_split_kernel(s, D, dtype, split):
    """Widths below 16 with 16-byte rows up to D = 256 take the split
    decode kernel, the rest the tile kernels."""
    assert tpa.uses_split_decode(s, D, dtype) is split


@pytest.mark.parametrize("H,D,dtype,P,maxp,plan", [
    (12, 64, torch.bfloat16, 16, 32, (4, 3, 8)),     # the serving geometry
    (12, 64, torch.float32, 16, 32, (2, 6, 8)),
    (12, 256, torch.bfloat16, 128, 4, (1, 12, 8)),
    (12, 32, torch.bfloat16, 512, 2, (6, 2, 16)),    # 8 a group, balanced
    (3, 8, torch.bfloat16, 3, 5, (3, 1, 1))])
def test_split_plan_groups_heads_into_one_box(H, D, dtype, P, maxp, plan):
    G, groups, chunks = tpa.split_plan(H, D, dtype, P, maxp)
    assert (G, groups, chunks) == plan
    elem = torch.empty((), dtype=dtype).element_size()
    assert G * D <= 256 and G <= 8 and groups * G >= H
    assert G * D * elem <= max(512, D * elem)


def split_decode_emulation(q, k_pool, v_pool, page_table, lengths, rows):
    """The split decode kernel's arithmetic in plain torch, in f32: per
    chunk of ``rows`` logical rows the chunk's max m_c, p = exp(s - m_c)
    (0 where masked), l_c and acc_c; chunks past a slot's last visible row
    skipped; then m = max m_c, l = sum l_c exp(m_c - m), acc = sum acc_c
    exp(m_c - m) in chunk order, out = acc / l (l == 0 -> 1)."""
    N, P, H, D = k_pool.shape
    B, s = q.shape[:2]
    T = page_table.shape[1] * P
    idx = (page_table.long()[:, :, None] * P
           + torch.arange(P)).reshape(B, T)
    kb = k_pool.reshape(N * P, H, D)[idx].float()
    vb = v_pool.reshape(N * P, H, D)[idx].float()
    out = torch.empty(B, s, H, D)
    for b in range(B):
        length = int(lengths[b])
        t_end = min(T, length + s)
        parts = []
        for t0 in range(0, t_end, rows):
            t = torch.arange(t0, min(t0 + rows, t_end))
            sc = torch.einsum("ihd,thd->iht", q[b].float(), kb[b, t])
            sc = sc / math.sqrt(D)
            ok = t[None, None, :] <= length + torch.arange(s)[:, None, None]
            sc = sc.masked_fill(~ok, -1e30)
            m = sc.amax(-1)
            p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
            parts.append((m, p.sum(-1),
                          torch.einsum("iht,thd->ihd", p, vb[b, t])))
        m = torch.stack([c[0] for c in parts]).amax(0)
        l, acc = torch.zeros(s, H), torch.zeros(s, H, D)
        for mc, lc, ac in parts:
            w = torch.exp(mc - m)
            l, acc = l + lc * w, acc + ac * w[..., None]
        out[b] = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(q.dtype)


# lengths (pages of 4, chunks of 8 rows): mid-chunk, the last row of a
# chunk, the first of the next, 0; slot 4 inactive (an all-NULL table row
# and a stale length)
SPLIT_LENGTHS = [13, 7, 8, 0, 20]


def _split_case(dtype, width, seed=6):
    case = _case(seed, B=5, s=width, P=4, H=3, D=8, maxp=8,
                 lengths=SPLIT_LENGTHS)
    case["page_table"][4] = 0
    return case


@pytest.mark.parametrize("dt,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_split_decode_emulation_matches_jax_decode_kernel(dt, tol):
    """Width 1 against the Pallas decode kernel under the interpreter and
    the jnp reference, over several chunks a slot."""
    case = _split_case(np.float32, 1)
    jd = getattr(jnp, dt)
    jcase = {k: jnp.asarray(v).astype(jd) if v.dtype == np.float32
             else jnp.asarray(v) for k, v in case.items()}
    tcase = {k: torch.from_numpy(v.copy()).to(getattr(torch, dt))
             if v.dtype == np.float32 else torch.from_numpy(v.copy())
             for k, v in case.items()}
    out = split_decode_emulation(**tcase, rows=8).float().numpy()
    for ref in (jpa.paged_attention_decode(**jcase),
                jpa.paged_attention_ref(**jcase)):
        np.testing.assert_allclose(out, np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("width", [2, 5])
def test_split_decode_emulation_matches_jax_reference_at_widths(width):
    """Widths up to the split kernel's 15: query i sees rows up to
    lengths + i, so a chunk can hold rows the first queries do not see."""
    case = _split_case(np.float32, width, seed=7)
    ref = np.asarray(jpa.paged_attention_ref(**_jax(case)))
    out = split_decode_emulation(**_torch(case), rows=8).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # the port's plain version (what the CPU takes) agrees as well
    np.testing.assert_allclose(tpa.paged_attention(**_torch(case)).numpy(),
                               ref, **TOL)
