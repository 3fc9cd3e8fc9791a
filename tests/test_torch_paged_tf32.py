"""K3's f32 prefill kernel (``paged_attention_tf32``: paged TMA + 3xTF32
wgmma) on the CPU: its route (``tile_route``) and launch plan
(``tf32_plan``) as the library computes them, and a plain emulation of the
kernel's tile walk -- 64-row kv tiles found through the page table, rows
at or past the visible end zeroed, the online softmax with the serving
mask in log2 units, each product taken as three products of TF32 halves
(``tf32_split``) -- against the JAX package's ``paged_attention_ref``.
f32 at ``rtol=atol=2e-5`` (two frameworks summing the same products in
different orders); the same walk on one TF32 product must miss it."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.incubate.nn.kernels import paged_attention as jpa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)
F32 = torch.float32


@pytest.mark.parametrize("s", [16, 32, 65, 128])
def test_tf32_route_takes_f32_chunks_tma_can_address(s):
    """f32 widths from 16 take the kernel's TMA instance at every D where
    D % 4 == 0 and the page's box rows (the largest power of two dividing
    it, up to 64) are at least 8; the rest its gathered instance."""
    for D in range(1, 300):
        for P in (1, 4, 8, 12, 16, 24, 48, 128, 256):
            want = ("tiles_tf32" if D % 4 == 0 and P % 8 == 0
                    else "tiles_tf32_g")
            assert tpa.tile_route(s, D, F32, P) == want, (s, D, P)
    # bf16 / f16 chunks and every decode width keep their kernels
    assert tpa.tile_route(32, 64, torch.bfloat16, 16) == "tiles_tc"
    assert tpa.tile_route(15, 64, F32, 16) == "split"
    assert tpa.tile_route(1, 36, torch.bfloat16, 16) == "split_g"


@pytest.mark.parametrize("P", [8, 16, 48, 128, 256])
def test_tf32_plan_boxes_stay_in_their_page(P):
    """The launch plan at every f32 width D = 4 ... 256: one block per
    (slot, 64-row q tiles of its consumers, head), two consumers up to 128
    where the chunk has more than one tile, shared memory under the card's
    232,448 bytes; a box of K or V rows never leaves its page and lands
    1024-byte aligned (8-row groups of 128 bytes), a kv tile is whole
    boxes."""
    for D in range(4, 257, 4):
        for s in (16, 32, 64, 65, 128, 200):
            plan = tpa.tf32_plan(16, s, 12, D, P)
            kw = 2 if s > 64 and D <= 128 else 1
            assert plan["consumers"] == kw
            assert plan["dp"] >= D and plan["dp"] in (64, 128, 256)
            assert plan["grid"] == (16 * 12 * -(-s // (64 * kw)), 1, 1)
            assert plan["threads"] == 128 * (1 + kw)
            assert plan["smem"] <= tpa.SMEM_LIMIT, (D, s, plan)
    pb = plan["box_rows"]
    assert P % pb == 0 and 64 % pb == 0 and pb >= 8
    assert plan["boxes"] * pb == 64 and pb * plan["box_bytes"] % 1024 == 0
    for t0 in range(0, 4 * P, 64):            # every box of four pages
        for u in range(plan["boxes"]):
            t = t0 + u * pb
            assert t // P == (t + pb - 1) // P, (t, pb, P)


@pytest.mark.parametrize("s,D,P", [(32, 64, 12), (32, 36, 2), (8, 64, 16),
                                   (32, 264, 12), (32, 38, 16)])
def test_tf32_plan_refuses_what_another_kernel_takes(s, D, P):
    with pytest.raises(ValueError):
        tpa.tf32_plan(2, s, 2, D, P)


def _x3(a, b, terms=3):
    """a @ b^T over the last axis as the kernel takes it: al.bh + ah.bl +
    ah.bh on TF32 halves (``terms=1``: ah.bh alone)."""
    (ah, al), (bh, bl) = tfa.tf32_split(a), tfa.tf32_split(b)
    mm = lambda x, y: torch.einsum("...ik,...jk->...ij", x, y)  # noqa
    return mm(ah, bh) if terms == 1 else mm(al, bh) + mm(ah, bl) + mm(ah, bh)


def tf32_tile_emulation(q, k_pool, v_pool, page_table, lengths, terms=3):
    """``paged_attention_tf32``'s walk in plain torch, f32: per slot and
    64-row q tile, the visible end t_end = min(T, length + min(i0 + 64,
    s)); per 64-row kv tile of the slot's logical rows (through the page
    table) the rows at or past t_end zeroed, S summed over 32-column slices
    of 3xTF32 products, in log2 units, -1e30 where t > length + i or t >=
    t_end, the running max, p = 2^(x - m), l and O rescaled, O += P.V on
    P's and V's TF32 halves (32 columns a chunk); out = O / l."""
    N, P, H, D = k_pool.shape
    B, s = q.shape[:2]
    T = page_table.shape[1] * P
    rows = (page_table.long()[:, :, None] * P
            + torch.arange(P)).reshape(B, T)
    kb = k_pool.reshape(N * P, H, D)[rows].transpose(1, 2)   # (B, H, T, D)
    vb = v_pool.reshape(N * P, H, D)[rows].transpose(1, 2)
    qh = q.transpose(1, 2)                                   # (B, H, s, D)
    scale_log2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    out = torch.empty(B, s, H, D)
    for b in range(B):
        length = int(lengths[b])
        for i0 in range(0, s, 64):
            qt = qh[b, :, i0:i0 + 64]
            n = qt.shape[1]
            t_end = min(T, length + min(i0 + 64, s))
            pos = length + i0 + torch.arange(n)
            m = torch.full((H, n, 1), -1e30)
            l = torch.zeros(H, n, 1)
            o = torch.zeros(H, n, D)
            for k0 in range(0, t_end, 64):
                t = torch.arange(k0, k0 + 64)
                kt, vt = kb[b, :, k0:k0 + 64], vb[b, :, k0:k0 + 64]
                if kt.shape[1] < 64:                     # the table's end
                    pad = torch.zeros(H, 64 - kt.shape[1], D)
                    kt, vt = torch.cat([kt, pad], 1), torch.cat([vt, pad], 1)
                live = (t < t_end)[None, :, None]
                kt = torch.where(live, kt, 0.0)
                vt = torch.where(live, vt, 0.0)
                sc = torch.zeros(H, n, 64)
                for c0 in range(0, D, 32):
                    sc = sc + _x3(qt[..., c0:c0 + 32], kt[..., c0:c0 + 32],
                                  terms)
                x = sc * scale_log2
                ok = (t[None, :] < t_end) & (t[None, :] <= pos[:, None])
                x = torch.where(ok[None], x, -1e30)
                m_next = torch.maximum(m, x.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_next)
                p = torch.exp2(x - m_next)
                l = l * alpha + p.sum(-1, keepdim=True)
                pv = torch.cat([_x3(p, vt[..., c0:c0 + 32].transpose(1, 2),
                                    terms) for c0 in range(0, D, 32)], -1)
                o = o * alpha + pv
                m = m_next
            out[b, i0:i0 + n] = (o / torch.where(l == 0.0, 1.0, l)) \
                .transpose(0, 1)
    return out


def _case(seed, B, s, P, H, D, maxp):
    """Random pools (their rows past each slot's end non-finite, as a
    page's unwritten rows may be), a shuffled page table, lengths at 0,
    page boundaries, mid-page and the table's last rows."""
    rng = np.random.RandomState(seed)
    N = 1 + B * maxp
    T = maxp * P
    pt = (rng.permutation(N - 1) + 1)[:B * maxp].reshape(B, maxp)
    lengths = np.minimum([0, P, P + 3, T - s], T - s).astype(np.int32)[:B]
    k = rng.randn(N, P, H, D).astype(np.float32)
    v = rng.randn(N, P, H, D).astype(np.float32)
    for b in range(B):                       # rows past the slot's end
        for t in range(int(lengths[b]) + s, T):
            k[pt[b, t // P], t % P] = np.inf
            v[pt[b, t // P], t % P] = np.nan
    return dict(q=rng.randn(B, s, H, D).astype(np.float32), k_pool=k,
                v_pool=v, page_table=pt.astype(np.int32), lengths=lengths)


@pytest.mark.parametrize("s", [16, 32, 128])
@pytest.mark.parametrize("P", [8, 16, 48])
def test_tf32_tile_walk_matches_jax_reference(s, P):
    """The emulated walk against the JAX package's reference at 2e-5, over
    pages of 8, 16 and 48 rows (48: boxes of 16) and chunks of 16, 32 and
    128 rows (two q tiles), D = 36 (a slice partly zero); the rows past
    each slot's end hold inf and nan, which the zeroed rows keep out.  A
    walk on one TF32 product (ah.bh) must miss the tolerance."""
    maxp = -(-(s + 2 * P + 70) // P)
    case = _case(s + P, B=4, s=s, P=P, H=2, D=36, maxp=maxp)
    assert tpa.tile_route(s, 36, F32, P) == "tiles_tf32"
    ref = np.asarray(jpa.paged_attention_ref(
        **{k: jnp.asarray(np.nan_to_num(v, nan=0.0, posinf=0.0))
           for k, v in case.items()}))
    t = {k: torch.from_numpy(v.copy()) for k, v in case.items()}
    out = tf32_tile_emulation(**t).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    one = tf32_tile_emulation(**t, terms=1).numpy()
    assert not np.allclose(one, ref, **TOL)
