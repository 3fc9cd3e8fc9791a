"""K3's bf16/f16 prefill kernel on paged TMA + wgmma
(``paged_attention_tc``) on the CPU: its route (``tile_route``) and launch
plan (``tc_plan``) over widths 16-256, head widths 8-264 and pages of 8
to 128 rows, with the shapes its gathered instance takes; the
port's plain version against the JAX package's ``paged_attention_ref`` on
the shapes the kernel takes; a plain emulation of the kernel's walk --
blocks of one or two 64-row q tiles, 64-row kv tiles found through the
page table, V's rows at or past the block's visible end zeroed, the online
softmax with the serving mask in log2 units, P rounded to the input type
before P.V -- against the same reference; and the paged engine at a chunk
width this kernel takes, token-exact against the JAX package's engine on
weights carried by ``load_jax_state``.  bf16/f16 at 2e-2, f32 at 2e-5,
as the other K3 tests."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.incubate.nn.kernels import paged_attention as jpa
from paddle_hackathon_tpu.inference import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    paged_attention as tpa
from paddle_hackathon_tpu_torch.inference import ServingEngine
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

HALF = (torch.bfloat16, torch.float16)
WIDTHS = (16, 32, 64, 65, 128, 256)
HEAD_DIMS = (8, 36, 40, 64, 128, 256, 264)
PAGES = (8, 12, 16, 48, 128)


def _takes(D, P):
    """The new kernel's rule: rows a multiple of 8 elements, pages whose
    box rows (the largest power of two dividing P, up to 64) are 8 or
    more."""
    return D % 8 == 0 and min(P & -P, 64) >= 8


@pytest.mark.parametrize("s", WIDTHS)
@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_route_and_plan_of_the_tma_kernel(dtype, s):
    """Every bf16/f16 chunk up to D = 256 with rows TMA addresses over
    pages of a multiple of 8 rows routes to ``tiles_tc``, past 256 to
    ``tiles_wide_tc`` (the same kernel in 256-column chunks); the rest
    takes the same kernel's gathered instance (``tiles_tc_g``,
    ``tiles_wide_tc_g``), whose shapes the TMA plan refuses.  The plan: one output chunk of D's padded width (64,
    128, 256) up to 256, two consumer warpgroups up to 128 where the chunk
    has more than one q tile, a block per (slot, consumers' q tiles, head,
    chunk), a producer warp, boxes of pb rows that never leave their page
    and land 1024-byte aligned, shared memory within the card's 232,448
    bytes."""
    B, H = 16, 12
    for D in HEAD_DIMS:
        for P in PAGES:
            route = tpa.tile_route(s, D, dtype, P)
            if not _takes(D, P):
                assert route == ("tiles_tc_g" if D <= 256
                                 else "tiles_wide_tc_g")
                with pytest.raises(ValueError):
                    tpa.tc_plan(B, s, H, D, P, dtype)
                continue
            assert route == ("tiles_tc" if D <= 256 else "tiles_wide_tc")
            plan = tpa.tc_plan(B, s, H, D, P, dtype)
            nc = 64 if D <= 64 else 128 if D <= 128 else 256
            kw = 2 if s > 64 and nc <= 128 else 1
            assert (plan["chunk_cols"], plan["consumers"]) == (nc, kw)
            assert plan["chunks"] == -(-D // nc)
            assert plan["threads"] == 128 * kw + 32
            assert plan["grid"] == (B * -(-s // (64 * kw)) * H
                                    * plan["chunks"], 1, 1)
            pb = plan["box_rows"]
            assert pb == min(P & -P, 64) and pb >= 8
            assert plan["boxes"] * pb == 64
            assert pb * plan["box_bytes"] % 1024 == 0
            for t in range(0, 4 * P, pb):       # a box never leaves its page
                assert t // P == (t + pb - 1) // P
            assert plan["slices"] == -(-D // 64) and plan["q_resident"]
            assert plan["smem"] <= tpa.SMEM_LIMIT, (D, s, P, plan)
            box = 64 * 128
            assert plan["smem"] == (1024 + kw * plan["slices"] * box
                                    + 4 * box + 2 * (nc // 64) * box
                                    + 13 * 8)
    # the serving chunk and the w128 chunk over pages of 128
    assert tpa.tc_plan(16, 32, 12, 64, 16, dtype)["grid"] == (192, 1, 1)
    p = tpa.tc_plan(16, 128, 12, 64, 128, dtype)
    assert (p["consumers"], p["grid"], p["boxes"]) == (2, (192, 1, 1), 1)
    # decode widths never reach it
    assert tpa.tile_route(15, 64, dtype, 16) == "split"
    assert tpa.tile_route(1, 36, dtype, 16) == "split_g"


def tc_tile_emulation(q, k_pool, v_pool, page_table, lengths, zero=True):
    """``paged_attention_tc``'s walk in plain torch: per slot, block of
    one or two 64-row q tiles (two where the chunk has more than one tile
    and D <= 128) and consumer tile, the block's visible end t_end =
    min(T, length + min(end of its tiles, s)) and the tile's own; per
    64-row kv tile of the slot's logical rows (through the page table),
    V's rows at or past t_end zeroed (``zero``), S = q.k^T in f32 on the
    inputs' values, in log2 units, -1e30 where t > length + i or t at or
    past the tile's end, the running max, p = 2^(x - m) into l, P rounded
    to the input type, O rescaled and O += P.V in f32; out = O / l (l == 0
    -> 1) rounded to the input type."""
    N, P, H, D = k_pool.shape
    B, s = q.shape[:2]
    T = page_table.shape[1] * P
    dt = q.dtype
    rows = (page_table.long()[:, :, None] * P
            + torch.arange(P)).reshape(B, T)
    kb = k_pool.reshape(N * P, H, D)[rows].transpose(1, 2).float()
    vb = v_pool.reshape(N * P, H, D)[rows].transpose(1, 2).float()
    qh = q.transpose(1, 2).float()                           # (B, H, s, D)
    scale_log2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    kw = 2 if s > 64 and D <= 128 else 1
    out = torch.empty(B, s, H, D, dtype=dt)
    for b in range(B):
        length = int(lengths[b])
        for blk in range(0, s, 64 * kw):
            t_end = min(T, length + min(blk + 64 * kw, s))
            for i0 in range(blk, min(blk + 64 * kw, s), 64):
                qt = qh[b, :, i0:i0 + 64]
                n = qt.shape[1]
                my_end = min(T, length + min(i0 + 64, s))
                pos = length + i0 + torch.arange(n)
                m = torch.full((H, n, 1), -1e30)
                l = torch.zeros(H, n, 1)
                o = torch.zeros(H, n, D)
                for k0 in range(0, my_end, 64):
                    t = torch.arange(k0, k0 + 64)
                    kt, vt = kb[b, :, k0:k0 + 64], vb[b, :, k0:k0 + 64]
                    if kt.shape[1] < 64:                 # the table's end
                        pad = torch.zeros(H, 64 - kt.shape[1], D)
                        kt = torch.cat([kt, pad], 1)
                        vt = torch.cat([vt, pad], 1)
                    if zero:
                        vt = torch.where((t < t_end)[None, :, None], vt,
                                         0.0)
                    x = torch.einsum("hid,htd->hit", qt, kt) * scale_log2
                    ok = (t[None, :] < my_end) & (t[None, :] <= pos[:, None])
                    x = torch.where(ok[None], x, -1e30)
                    m_next = torch.maximum(m, x.amax(-1, keepdim=True))
                    alpha = torch.exp2(m - m_next)
                    p = torch.where(ok[None], torch.exp2(x - m_next), 0.0)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    pv = torch.einsum("hit,htd->hid", p.to(dt).float(), vt)
                    o = o * alpha + pv
                    m = m_next
                out[b, i0:i0 + n] = (o / torch.where(l == 0.0, 1.0, l)) \
                    .transpose(0, 1).to(dt)
    return out


def _case(seed, s, P, D, maxp, B=5, H=2, poison=True):
    """Random pools, a shuffled page table (page 0 never mapped), slot 4
    inactive (an all-NULL table row, a stale length); lengths at 0, the
    last row of a page, past one 64-row tile and mid-page, so chunks cross
    pages and tiles.  ``poison``: the rows past each live slot's end hold
    inf (K) and nan (V), as a page's unwritten rows may."""
    rng = np.random.RandomState(seed)
    N = 1 + B * maxp
    T = maxp * P
    pt = (rng.permutation(N - 1) + 1)[:B * maxp].reshape(B, maxp)
    lengths = np.minimum([0, P - 1, 64 + 3, T - s - 5, 7],
                         T - s).astype(np.int32)[:B]
    k = rng.randn(N, P, H, D).astype(np.float32)
    v = rng.randn(N, P, H, D).astype(np.float32)
    pt[4] = 0
    if poison:
        for b in range(4):
            for t in range(int(lengths[b]) + s, T):
                k[pt[b, t // P], t % P] = np.inf
                v[pt[b, t // P], t % P] = np.nan
    return dict(q=rng.randn(B, s, H, D).astype(np.float32), k_pool=k,
                v_pool=v, page_table=pt.astype(np.int32), lengths=lengths)


def _jax_ref(case, dtype):
    """The JAX package's reference on the case's values in ``dtype``
    (rows past each slot's end read as 0: the reference masks them, but
    its softmax would carry a nan through)."""
    j = {k: jnp.asarray(np.nan_to_num(v, nan=0.0, posinf=0.0))
         for k, v in case.items()}
    for k in ("q", "k_pool", "v_pool"):
        j[k] = j[k].astype(getattr(jnp, dtype)).astype(jnp.float32)
    return np.asarray(jpa.paged_attention_ref(**j), np.float32)


@pytest.mark.parametrize("s,P,D", [(16, 8, 64), (32, 16, 64),
                                   (65, 48, 40), (128, 16, 128),
                                   (32, 128, 8)])
def test_plain_version_matches_jax_on_the_kernels_shapes(s, P, D):
    """The port's plain version against the JAX package's reference on
    shapes the kernel takes: shuffled tables, an inactive slot, offsets
    that cross a page and a 64-row tile; f32 at 2e-5."""
    maxp = -(-(s + 64 + 3 * P) // P)
    case = _case(s * 7 + P + D, s, P, D, maxp, poison=False)
    assert tpa.tile_route(s, D, torch.bfloat16, P) == "tiles_tc"
    ref = np.asarray(jpa.paged_attention_ref(
        **{k: jnp.asarray(v) for k, v in case.items()}))
    got = tpa.paged_attention_ref(
        **{k: torch.from_numpy(v.copy()) for k, v in case.items()}).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("s,P,D", [(16, 8, 64), (32, 16, 64),
                                   (65, 48, 40), (128, 16, 64),
                                   (130, 8, 128), (64, 128, 256)])
def test_tile_walk_matches_jax_reference(s, P, D, dtype):
    """The emulated walk against the JAX package's reference at 2e-2, over
    one and two consumers (s past 64 with D <= 128), pages of 8, 16, 48
    (boxes of 16) and 128 rows, D = 40 (a slice partly zero); the rows
    past each slot's end hold inf and nan, which the zeroed rows and the
    mask keep out.  The planted fault, the walk without V's rows zeroed,
    must not be finite."""
    maxp = -(-(s + 64 + 3 * P) // P)
    case = _case(s + P + D, s, P, D, maxp)
    tdt = getattr(torch, dtype)
    assert tpa.tile_route(s, D, tdt, P) == "tiles_tc"
    t = {k: torch.from_numpy(v.copy()) for k, v in case.items()}
    for k in ("q", "k_pool", "v_pool"):
        t[k] = t[k].to(tdt)
    out = tc_tile_emulation(**t).float().numpy()
    live = out[:4]                            # slot 4 is inactive
    assert np.isfinite(live).all()
    np.testing.assert_allclose(live, _jax_ref(case, dtype)[:4], rtol=2e-2,
                               atol=2e-2)
    bad = tc_tile_emulation(**t, zero=False).float().numpy()[:4]
    assert not np.isfinite(bad).all()


_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_ENGINE = dict(max_slots=3, max_len=96, chunk=16, page_size=8)


def test_paged_engine_at_a_tc_chunk_is_token_exact_vs_jax():
    """The paged engine with chunk ticks of 16 rows over pages of 8 (on the
    card in bf16 the new kernel's route: D = 16) against the JAX package's
    paged engine on the same weights (``load_jax_state``): prompts of 40
    and 23 rows, whose chunks cross pages and a 64-row tile with the
    decode steps; greedy tokens equal, no page leaked."""
    assert tpa.tile_route(16, 16, torch.bfloat16, 8) == "tiles_tc"
    paddle.seed(4)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (40, 23)]
    jeng = JEngine(jm, auto_run=False, cache_mode="paged", **_ENGINE)
    jreqs = [jeng.submit(p, 30) for p in prompts]
    jeng.run_until_idle()
    refs = [r.result() for r in jreqs]
    jeng.shutdown()
    eng = ServingEngine(tm, cache_mode="paged", **_ENGINE)
    reqs = [eng.submit(p, 30) for p in prompts]
    eng.run_until_idle()
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(r.result(), ref)
    assert eng.stats["chunk_ticks"] > 0
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0
    eng.shutdown()
