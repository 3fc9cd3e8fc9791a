"""K3's gathered instances on the CPU: the shapes no TMA box addresses
(pages whose box rows -- the largest power of two dividing the page, up to
64 -- are under 8, such as 12, 6 or 5; rows that are not a multiple of 16
bytes, such as D = 36 in bf16 or D % 4 != 0 in f32) run the same kernels as
the TMA shapes with their rows gathered one by one through the page table
into the same shared-memory tiles.  Here: the route mirror (``tile_route``)
over dtypes, widths, head widths and pages, every shape on a TMA or
gathered wgmma route or on split decode, none on a retired kernel; the
gathered launch plans (``gather_plan``, ``split_plan``); a plain emulation
of the gathered walk -- page ids per row, zero columns past D, V's rows at
or past the block's visible end zeroed, the online softmax in log2 units,
P rounded to the input type (f32: 3xTF32 products), past 256 output chunks
each recomputing S -- against the JAX package's ``paged_attention_ref``;
the split decode's gathered chunks (a head's row padded to 16 bytes)
against it too; and the paged engine at ``page_size`` 12 token-exact
against the JAX package's engine on weights carried by
``load_jax_state``.  bf16/f16 at 2e-2, f32 at 2e-5, as the other K3
tests."""

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
    flash_attention as tfa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    paged_attention as tpa
from paddle_hackathon_tpu_torch.inference import ServingEngine
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
WIDTHS = (1, 15, 16, 32, 65, 128)
HEAD_DIMS = (4, 8, 36, 40, 64, 100, 256, 260, 320, 512, 1032)
PAGES = (1, 5, 6, 8, 12, 16, 48, 128)
RETIRED = {"scalar", "tiles", "tiles_wide"}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _tma(D, P, dtype, chunk):
    """Whether a TMA box takes the rows (and, for the chunk kernels, the
    pages): rows a multiple of 16 bytes, box rows pow2_part(P) >= 8."""
    return D * dtype.itemsize % 16 == 0 and (not chunk
                                             or min(P & -P, 64) >= 8)


@pytest.mark.parametrize("s", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_shape_routes_to_a_hopper_kernel(dtype, s):
    """Every (dtype, s, D, P) names a TMA or gathered wgmma route, or the
    split decode kernel (TMA or gathered), never a retired kernel; the
    gathered routes are exactly the shapes no box takes."""
    for D in HEAD_DIMS:
        for P in PAGES:
            route = tpa.tile_route(s, D, dtype, P)
            assert route in tpa.TILE_ROUTES and route not in RETIRED
            chunk = s >= 16
            gathered = not _tma(D, P, dtype, chunk)
            assert route.endswith("_g") is gathered, (s, D, P, route)
            if not chunk:
                assert route in ("split", "split_g")
            elif dtype == torch.float32:
                assert route in ("tiles_tf32", "tiles_tf32_g")
            else:
                wide = "wide_" if D > 256 else ""
                assert route == f"tiles_{wide}tc" + ("_g" if gathered
                                                     else "")
    assert not RETIRED & set(tpa.TILE_ROUTES)
    assert set(tpa.kernel_launches) == set(tpa.TILE_ROUTES)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gathered_plans_fit_the_card_at_any_slot_count(dtype):
    """The gathered prefill plans: the TMA instance's blocks and rings
    (the same shared-memory layout), the gathered producer's threads
    (bf16/f16: the consumers and a warpgroup; f32: the same producer
    warpgroup), the copy width the rows' alignment allows, shared memory
    within the card's 232,448 bytes, and 65538 slots folded into grid.x
    (past grid.y's 65535, below 2^31).  The TMA plans refuse these shapes,
    and the gathered plan the TMA shapes and decode widths."""
    H, elem = 12, dtype.itemsize
    seen = 0
    for s in (16, 32, 65, 128, 200):
        for D in HEAD_DIMS:
            for P in PAGES:
                if _tma(D, P, dtype, True):
                    with pytest.raises(ValueError):
                        tpa.gather_plan(16, s, H, D, P, dtype)
                    continue
                seen += 1
                plan = tpa.gather_plan(16, s, H, D, P, dtype)
                assert plan["route"] == tpa.tile_route(s, D, dtype, P)
                nbytes = D * elem
                assert plan["align"] == min(nbytes & -nbytes, 16)
                assert plan["smem"] <= tpa.SMEM_LIMIT, (s, D, P, plan)
                kw = plan["consumers"]
                if dtype == torch.float32:
                    assert plan["threads"] == 128 * (1 + kw)
                    chunks = 1 if D <= 256 else -(-D // 160)
                    assert plan["chunks"] == chunks
                    assert plan["q_resident"] is (D <= 256)
                    with pytest.raises(ValueError):
                        tpa.tf32_plan(16, s, H, D, P)
                else:
                    assert plan["threads"] == 128 * kw + 128
                    assert plan["chunks"] == (1 if D <= 256
                                              else -(-D // 256))
                    with pytest.raises(ValueError):
                        tpa.tc_plan(16, s, H, D, P, dtype)
                assert plan["grid"] == (16 * -(-s // (64 * kw)) * H
                                        * plan["chunks"], 1, 1)
                big = tpa.gather_plan(65538, s, 2, D, P, dtype)
                assert 65535 < big["grid"][0] < 2 ** 31
                assert big["grid"][1:] == (1, 1)
    assert seen > 0
    with pytest.raises(ValueError):
        tpa.gather_plan(16, 15, H, 36, 12, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_split_plan_of_unaligned_rows(dtype):
    """Decode rows that are not a multiple of 16 bytes take the split
    kernel's gathered instance: the same groups and chunks, up to 256 each
    head's row padded in shared memory to the next 16 bytes (one a row,
    not in boxes), past it the same column slices; shared memory within
    the card's limit at every such D to 1032 and widths 1 and 15."""
    elem = dtype.itemsize
    vec = 16 // elem
    for D in range(1, 1033):
        gathered = D * elem % 16 != 0
        for width in (1, 15):
            plan = tpa.split_plan(12, D, dtype, 12, 40, width)
            assert plan.gathered is gathered
            assert plan.smem <= tpa.SMEM_LIMIT, (D, width, plan)
            assert plan.chunks == -(-12 * 40 // 64)
            if D <= 256:
                assert plan.G * D <= 256 and plan.G <= 8
                if gathered:
                    hs = -(-D // vec) * vec
                    g = plan.G
                    assert plan.smem == (2 * 64 * g * hs * elem
                                         + 4 * (width * g * hs
                                                + width * g * 64
                                                + 4 * width * g + 1)
                                         + 8 + 16 + 128)
            else:
                assert plan.G == 1
                assert (plan.slices - 1) * plan.slice_cols < D \
                    <= plan.slices * plan.slice_cols


def _case(seed, s, P, D, maxp, B=5, H=2):
    """Random pools, a shuffled page table (page 0 never mapped), slot 4
    inactive (an all-NULL table row, a stale length); lengths at 0, the
    last row of a page, past one 64-row tile and near the table's end, so
    chunks cross pages mid-tile; the rows past each live slot's end hold
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
    name = str(dtype).split(".")[-1]
    for k in ("q", "k_pool", "v_pool"):
        j[k] = j[k].astype(getattr(jnp, name)).astype(jnp.float32)
    return np.asarray(jpa.paged_attention_ref(**j), np.float32)


def _torch(case, dtype):
    t = {k: torch.from_numpy(v.copy()) for k, v in case.items()}
    for k in ("q", "k_pool", "v_pool"):
        t[k] = t[k].to(dtype)
    return t


def _gather(pool, pt_row, k0, t_end, cols):
    """A 64-row kv tile as the gathered producer writes it: logical row t
    at pool row page_table[t / P] * P + t % P (the page clamped to the
    pool, the table index to the table), each row finding its own page;
    zeros at or past t_end and in the columns past D (up to ``cols``)."""
    N, P, H, D = pool.shape
    t = torch.arange(k0, k0 + 64)
    page = pt_row.long()[(t // P).clamp(max=len(pt_row) - 1)]
    rows = page.clamp(0, N - 1) * P + t % P
    x = pool.reshape(N * P, H, D)[rows].float().transpose(0, 1)  # (H,64,D)
    x = torch.where((t < t_end)[None, :, None], x, 0.0)
    return torch.nn.functional.pad(x, (0, cols - D))


def _mm(a, b, f32):
    """a @ b^T over the last axis: in f32 as the kernel's 3xTF32 products
    (al.bh + ah.bl + ah.bh on TF32 halves), else on the values as given."""
    mm = lambda x, y: torch.einsum("...ik,...jk->...ij", x, y)  # noqa
    if not f32:
        return mm(a, b)
    (ah, al), (bh, bl) = tfa.tf32_split(a), tfa.tf32_split(b)
    return mm(al, bh) + mm(ah, bl) + mm(ah, bh)


def gathered_walk(q, k_pool, v_pool, page_table, lengths):
    """The gathered chunk kernels' walk in plain torch (the TMA instances'
    walk too: the tiles are the same): per slot, block of one or two
    64-row q tiles (two where the chunk has more than one tile and D <=
    128) and output chunk (bf16/f16: D's padded width up to 256, chunks of
    256 past it; f32: up to 256 one, chunks of 160 past it), the block's
    visible end t_end = min(T, length + min(end of its tiles, s)) and the
    tile's own; per 64-row kv tile the gathered rows (``_gather``), S
    summed over the slices (64 columns, f32 32 columns of 3xTF32
    products) in log2 units, -1e30 where t > length + i or t at or past
    the tile's end, the running max, p = 2^(x - m) into l, P rounded to
    the input type (f32: 3xTF32 products with V), O rescaled and O +=
    P.V for the chunk's columns; out = O / l (l == 0 -> 1) in the input
    type.  Each chunk recomputes S over all of D."""
    N, P, H, D = k_pool.shape
    B, s = q.shape[:2]
    T = page_table.shape[1] * P
    dt = q.dtype
    f32 = dt == torch.float32
    sl = 32 if f32 else 64                       # S's slices
    nc = (64 if D <= 64 else 128 if D <= 128 else 256) if D <= 256 \
        else (160 if f32 else 256)               # output chunk
    cols = -(-D // sl) * sl
    kw = 2 if s > 64 and D <= 128 else 1
    scale_log2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    qh = torch.nn.functional.pad(q.float(), (0, cols - D)).transpose(1, 2)
    out = torch.empty(B, s, H, -(-D // nc) * nc)
    for b in range(B):
        length = int(lengths[b])
        for blk in range(0, s, 64 * kw):
            t_end = min(T, length + min(blk + 64 * kw, s))
            for i0 in range(blk, min(blk + 64 * kw, s), 64):
                qt = qh[b, :, i0:i0 + 64]
                n = qt.shape[1]
                my_end = min(T, length + min(i0 + 64, s))
                pos = length + i0 + torch.arange(n)
                for z0 in range(0, D, nc):
                    m = torch.full((H, n, 1), -1e30)
                    l = torch.zeros(H, n, 1)
                    o = torch.zeros(H, n, nc)
                    for k0 in range(0, my_end, 64):
                        kt = _gather(k_pool, page_table[b], k0, t_end, cols)
                        vt = _gather(v_pool, page_table[b], k0, t_end,
                                     cols + nc)[..., z0:z0 + nc]
                        x = torch.zeros(H, n, 64)
                        for c0 in range(0, cols, sl):
                            x = x + _mm(qt[..., c0:c0 + sl],
                                        kt[..., c0:c0 + sl], f32)
                        x = x * scale_log2
                        t = torch.arange(k0, k0 + 64)
                        ok = (t[None, :] < my_end) & \
                            (t[None, :] <= pos[:, None])
                        x = torch.where(ok[None], x, -1e30)
                        m_next = torch.maximum(m, x.amax(-1, keepdim=True))
                        alpha = torch.exp2(m - m_next)
                        p = torch.where(ok[None], torch.exp2(x - m_next),
                                        0.0)
                        l = l * alpha + p.sum(-1, keepdim=True)
                        if f32:
                            pv = torch.cat(
                                [_mm(p, vt[..., c:c + 32].transpose(1, 2),
                                     True) for c in range(0, nc, 32)], -1)
                        else:
                            pv = torch.einsum("hit,htd->hid",
                                              p.to(dt).float(), vt)
                        o = o * alpha + pv
                        m = m_next
                    out[b, i0:i0 + n, :, z0:z0 + nc] = \
                        (o / torch.where(l == 0.0, 1.0, l)).transpose(0, 1)
    return out[..., :D].to(dt)


@pytest.mark.parametrize("dtype,s,P,D,route", [
    (torch.bfloat16, 32, 12, 64, "tiles_tc_g"),        # pages of 12
    (torch.float16, 65, 6, 40, "tiles_tc_g"),          # two q tiles
    (torch.bfloat16, 32, 16, 36, "tiles_tc_g"),        # 72-byte rows
    (torch.bfloat16, 32, 16, 260, "tiles_wide_tc_g"),  # 256-col chunks
    (torch.float32, 32, 12, 320, "tiles_tf32_g"),      # 160-col chunks
    (torch.float32, 32, 12, 36, "tiles_tf32_g"),
    (torch.float32, 65, 16, 38, "tiles_tf32_g")])      # D % 4 != 0
def test_gathered_walk_matches_jax_reference(dtype, s, P, D, route):
    """The emulated gathered walk against the JAX package's reference on
    the shapes the gathered instances take; the rows past each slot's end
    hold inf and nan, which the zeroed rows and the mask keep out.  The
    planted fault, V's rows past the end not zeroed, must not be
    finite."""
    maxp = -(-(s + 64 + 3 * P) // P)
    case = _case(s * 3 + P + D, s, P, D, maxp)
    assert tpa.tile_route(s, D, dtype, P) == route
    t = _torch(case, dtype)
    out = gathered_walk(**t).float().numpy()
    live = out[:4]                            # slot 4 is inactive
    assert np.isfinite(live).all()
    tol = TOL[dtype]
    np.testing.assert_allclose(live, _jax_ref(case, dtype)[:4], rtol=tol,
                               atol=tol)
    # the planted fault: V gathered without its rows past t_end zeroed
    real = globals()["_gather"]

    def leaky(pool, pt_row, k0, t_end, cols):
        return real(pool, pt_row, k0, 10 ** 9 if pool is t["v_pool"]
                    else t_end, cols)
    globals()["_gather"] = leaky
    try:
        bad = gathered_walk(**t).float().numpy()[:4]
    finally:
        globals()["_gather"] = real
    assert not np.isfinite(bad).all()


def split_gathered_emulation(q, k_pool, v_pool, page_table, lengths):
    """The split decode kernel's gathered instance in plain torch, f32:
    a head's row padded in shared memory to the next 16 bytes (zeros in K
    and in q), per chunk of 64 logical rows each row through its own page
    id, scores in log2 units, -1e30 past the query's position, the
    chunk's max and sum, p = 2^(x - m_c) on the values (not rounded);
    then the chunks merged in order 0, 1, ...: m = max m_c, l = sum l_c
    2^(m_c - m), acc = sum acc_c 2^(m_c - m), out = acc / l."""
    N, P, H, D = k_pool.shape
    B, s = q.shape[:2]
    T = page_table.shape[1] * P
    vec = 16 // q.element_size()
    hs = -(-D // vec) * vec
    scale_log2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    qp = torch.nn.functional.pad(q.float(), (0, hs - D))
    out = torch.empty(B, s, H, D)
    for b in range(B):
        length = int(lengths[b])
        t_end = min(T, length + s)
        parts = []
        for t0 in range(0, t_end, 64):
            nr = min(64, t_end - t0)
            kt = _gather(k_pool, page_table[b], t0, t_end, hs)[:, :nr]
            vt = _gather(v_pool, page_table[b], t0, t_end, D)[:, :nr]
            x = torch.einsum("ihd,htd->iht", qp[b], kt) * scale_log2
            t = torch.arange(t0, t0 + nr)
            ok = t[None, None, :] <= length + torch.arange(s)[:, None, None]
            x = torch.where(ok, x, -1e30)
            mc = x.amax(-1)
            p = torch.where(ok, torch.exp2(x - mc[..., None]), 0.0)
            parts.append((mc, p.sum(-1), torch.einsum("iht,htd->ihd", p,
                                                      vt)))
        m = torch.stack([c[0] for c in parts]).amax(0)
        l, acc = torch.zeros(s, H), torch.zeros(s, H, D)
        for mc, lc, ac in parts:
            w = torch.exp2(mc - m)
            l, acc = l + lc * w, acc + ac * w[..., None]
        out[b] = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype,s,P,D", [
    (torch.bfloat16, 1, 16, 36), (torch.float16, 15, 12, 36),
    (torch.bfloat16, 1, 12, 260), (torch.float32, 5, 6, 33)])
def test_split_gathered_emulation_matches_jax_reference(dtype, s, P, D):
    """Decode widths whose rows are not a multiple of 16 bytes (D = 36 and
    260 in bf16/f16, D = 33 in f32) over pages of 16, 12 and 6: the split
    kernel's gathered chunks against the JAX package's reference, rows
    past each slot's end non-finite and never read."""
    assert tpa.tile_route(s, D, dtype, P) == "split_g"
    maxp = -(-(s + 64 + 3 * P) // P)
    case = _case(s * 5 + P + D, s, P, D, maxp)
    out = split_gathered_emulation(**_torch(case, dtype)).float().numpy()
    assert np.isfinite(out[:4]).all()
    tol = TOL[dtype]
    np.testing.assert_allclose(out[:4], _jax_ref(case, dtype)[:4], rtol=tol,
                               atol=tol)


_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_ENGINE = dict(max_slots=3, max_len=96, chunk=16, page_size=12)


def test_paged_engine_at_pages_of_12_is_token_exact_vs_jax():
    """The paged engine over pages of 12 rows (on the card the gathered
    chunk routes, bf16 ``tiles_tc_g`` and f32 ``tiles_tf32_g``, and the
    split decode kernel at D = 16) against the JAX package's paged engine
    on the same weights (``load_jax_state``): prompts of 40 and 23 rows,
    whose chunks of 16 cross pages mid-page and a 64-row tile, then the
    decode steps; greedy tokens equal, no page leaked."""
    for dtype, route in ((torch.bfloat16, "tiles_tc_g"),
                         (torch.float32, "tiles_tf32_g")):
        assert tpa.tile_route(16, 16, dtype, 12) == route
        assert tpa.tile_route(1, 16, dtype, 12) == "split"
    paddle.seed(5)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    rs = np.random.RandomState(12)
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
    assert eng.stats["chunk_ticks"] > 0 and eng.stats["decode_ticks"] > 0
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0
    eng.shutdown()
