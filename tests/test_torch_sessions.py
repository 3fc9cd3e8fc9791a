"""Multi-turn KV sessions and page-pool compaction of the port's
``ServingEngine`` (``paddle_hackathon_tpu_torch``), mirroring the engine
cases of ``test_serving_sessions.py``: each scenario runs through the JAX
package's engine and the port's on the same weights (2-layer GPT, hidden
64, f32, greedy) and must give the same tokens, the same session
bookkeeping (retained sessions, resumes, hit tokens, evictions) and the
same page accounting; a resumed turn must also equal a one-shot
submission of the whole conversation, and no page may be left after
``drop_sessions()`` and ``drop_prefix_cache()``."""

import time

import numpy as np
import pytest

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.inference.serving import EngineDraining as JDrain
from paddle_hackathon_tpu.inference.serving import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.inference import (EngineDraining,
                                                  ServingEngine, page_digests)
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_COUNTERS = ("session_resumes", "session_hit_tokens", "prefix_hit_tokens",
             "ticks", "tokens")


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) on the same weights."""
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    return jm, tm


def _both(models, scenario, **kw):
    """``scenario(engine)`` on a JAX engine and a port engine built with
    ``kw`` (synchronously driven); returns ``(jax_result, port_result)``."""
    jm, tm = models
    out = []
    for cls, m in ((JEngine, jm), (ServingEngine, tm)):
        eng = cls(m, auto_run=False, **kw)
        out.append(scenario(eng))
        eng.shutdown(timeout=5)
    return out


def _book(eng):
    """The engine's session and page bookkeeping, comparable across the
    two packages."""
    out = {k: int(eng.stats[k]) for k in _COUNTERS}
    out["sessions_evicted"] = int(eng._c["sessions_evicted"].value)
    out["sessions"] = {sid: (s.tokens.tolist(), len(s.pages), s.kv_len,
                             list(s.digests), s.busy)
                       for sid, s in eng._sessions.items()}
    out["pages_in_use"] = eng.kv_pages_in_use
    return out


def _conversation():
    rs = np.random.RandomState(11)
    t1 = rs.randint(0, 128, (13,)).astype(np.int32)
    return t1, [rs.randint(0, 128, (5,)).astype(np.int32) for _ in range(2)]


@pytest.mark.parametrize("mode", ["dense", "paged", "spec"])
def test_session_resume_token_exact(models, mode):
    """A 3-turn conversation through ``submit(session=)`` gives exactly
    what one-shot submissions of the whole history give, and the JAX
    engine's tokens and session bookkeeping turn by turn (paged and spec:
    both later turns resume from the retained chain)."""
    kw = {"dense": {}, "paged": dict(cache_mode="paged", page_size=8),
          "spec": dict(cache_mode="paged", page_size=8, spec_k=4)}[mode]
    t1, follows = _conversation()
    _, tm = models
    fresh = ServingEngine(tm, max_slots=2, max_len=128, chunk=4,
                          auto_run=False)
    refs, hist = [], t1
    for fu in [None] + follows:
        if fu is not None:
            hist = np.concatenate([refs[-1], fu])
        r = fresh.submit(hist, 6)
        fresh.run_until_idle()
        refs.append(r.result())

    def run(eng):
        hist, outs, books = t1, [], []
        for fu in [None] + follows:
            if fu is not None:
                hist = np.concatenate([hist, fu])
            r = eng.submit(hist, 6, session="conv")
            eng.run_until_idle()
            outs.append(r.result().tolist())
            books.append(_book(eng))
            hist = r.result()
        dropped = eng.drop_sessions()
        eng.drop_prefix_cache()
        return outs, books, dropped, eng.kv_pages_in_use
    ref, got = _both(models, run, max_slots=2, max_len=128, chunk=4, **kw)
    assert got == ref
    assert got[0] == [r.tolist() for r in refs]
    assert got[2] == 1 and got[3] == 0
    if mode != "dense":
        assert got[1][-1]["session_resumes"] == 2
        assert got[1][-1]["session_hit_tokens"] > 0
        assert got[1][-1]["sessions"]["conv"][1] > 0
        # the chain digests are paged.page_digests of the conversation
        sess = got[1][-1]["sessions"]["conv"]
        assert sess[3] == page_digests(np.asarray(sess[0], np.int32),
                                       8)[:sess[2] // 8]
    else:
        assert got[1][-1]["session_resumes"] == 0


def test_session_lru_eviction_under_pressure(models):
    """Two retained sessions and a request that needs more than the free
    pages: admission evicts the least recently used session and never
    starves; the same session is evicted in the JAX engine."""
    rs = np.random.RandomState(12)
    pa = rs.randint(0, 128, (17,)).astype(np.int32)
    pb = rs.randint(0, 128, (18,)).astype(np.int32)
    big = rs.randint(0, 128, (40,)).astype(np.int32)

    def run(eng):
        eng.submit(pa, 4, session="a")
        eng.run_until_idle()
        eng.submit(pb, 4, session="b")
        eng.run_until_idle()
        assert len(eng._sessions) == 2
        eng.drop_prefix_cache()
        free0 = eng.kv_pages_free
        r = eng.submit(big, 8 * (free0 // 2) + 8)
        eng.run_until_idle()
        assert r.done and r.error is None
        book = _book(eng)
        eng.drop_sessions()
        eng.drop_prefix_cache()
        return free0, list(r.tokens), book, eng.kv_pages_in_use
    ref, got = _both(models, run, max_slots=2, max_len=96, chunk=4,
                     cache_mode="paged", page_size=8, num_pages=15)
    assert got == ref
    assert "a" not in got[2]["sessions"] and "b" in got[2]["sessions"]
    assert got[2]["sessions_evicted"] >= 1 and got[3] == 0


def test_session_ttl_donates_to_prefix_cache(models):
    """An idle session past ``session_ttl_s`` is evicted by the next
    admission's sweep and donated to the prefix cache, so the returning
    conversation hits cached pages; as in the JAX engine."""
    rs = np.random.RandomState(12)
    pa = rs.randint(0, 128, (17,)).astype(np.int32)
    pb = rs.randint(0, 128, (18,)).astype(np.int32)

    def run(eng):
        r1 = eng.submit(pa, 4, session="ttl")
        eng.run_until_idle()
        kept = "ttl" in eng._sessions
        time.sleep(2.5)
        eng.submit(pb, 4)                    # any admission sweeps
        eng.run_until_idle()
        swept = "ttl" not in eng._sessions
        hits0 = eng.stats["prefix_hit_tokens"]
        r3 = eng.submit(np.concatenate([r1.result(), [5]]).astype(np.int32),
                        4, session="ttl")
        eng.run_until_idle()
        hit = eng.stats["prefix_hit_tokens"] - hits0
        eng.drop_sessions()
        eng.drop_prefix_cache()
        return kept, swept, hit, list(r3.tokens), eng.kv_pages_in_use
    ref, got = _both(models, run, max_slots=2, max_len=96, chunk=4,
                     cache_mode="paged", page_size=8, session_ttl_s=1.5)
    assert got == ref
    assert got[0] and got[1] and got[2] > 0 and got[4] == 0


def test_max_sessions_keeps_the_most_recent(models):
    """``max_sessions=2``: a third conversation evicts the least recently
    used one, in dense and in paged mode alike."""
    rs = np.random.RandomState(15)
    prompts = [rs.randint(0, 128, (9,)).astype(np.int32) for _ in range(3)]

    def run(eng):
        for k, p in enumerate(prompts):
            eng.submit(p, 3, session=f"s{k}")
            eng.run_until_idle()
        book = _book(eng)
        eng.drop_sessions()
        eng.drop_prefix_cache()
        return book, eng.kv_pages_in_use
    for kw in ({}, dict(cache_mode="paged", page_size=8)):
        ref, got = _both(models, run, max_slots=2, max_len=64, chunk=4,
                         max_sessions=2, **kw)
        assert got == ref
        assert sorted(got[0]["sessions"]) == ["s1", "s2"]
        assert got[0]["sessions_evicted"] == 1 and got[1] == 0


def test_diverged_turn_keeps_the_common_prefix(models):
    """A turn whose prompt diverges from the retained conversation inside
    a page resumes from the longest common prefix (the shared tail page
    forks copy-on-write) and stays token-exact."""
    rs = np.random.RandomState(16)
    p = rs.randint(0, 128, (20,)).astype(np.int32)

    def run(eng):
        r1 = eng.submit(p, 6, session="c")
        eng.run_until_idle()
        alt = r1.result().copy()
        alt[13] = (alt[13] + 1) % 128        # diverges on page 1 of 8 rows
        r2 = eng.submit(alt, 4, session="c")
        eng.run_until_idle()
        book = _book(eng)
        eng.drop_sessions()
        eng.drop_prefix_cache()
        return list(r2.tokens), book, eng.kv_pages_in_use
    ref, got = _both(models, run, max_slots=2, max_len=64, chunk=4,
                     cache_mode="paged", page_size=8)
    assert got == ref
    assert got[1]["session_resumes"] == 1 and got[2] == 0


def test_defrag_preserves_refcounts_and_token_exactness(models):
    """Fragment the pool (drop the cache and one session while the other
    session's chain sits high), compact: the same pages move as in the
    JAX engine, every refcount is kept (remapped), the pool is packed,
    and the remapped session resumes token-exact against a fresh
    submission of the whole conversation."""
    rs = np.random.RandomState(13)
    p1 = rs.randint(0, 128, (17,)).astype(np.int32)
    p2 = rs.randint(0, 128, (22,)).astype(np.int32)
    fu = rs.randint(0, 128, (4,)).astype(np.int32)

    def run(eng):
        eng.submit(p1, 4, session="a")
        eng.run_until_idle()
        eng.submit(p2, 4, session="b")
        eng.run_until_idle()
        eng.drop_prefix_cache()
        with eng._lock:
            eng._evict_session_locked("a", donate=False)
        pool = eng._pool
        before = sorted(int(pool._ref[p]) for p in pool.allocated_ids())
        fragmented = pool.highest_allocated() > pool.allocated
        moved = eng.defrag()
        packed = pool.highest_allocated() == pool.allocated
        after = sorted(int(pool._ref[p]) for p in pool.allocated_ids())
        pages = list(eng._sessions["b"].pages)
        hist = eng._sessions["b"].tokens.copy()
        rb = eng.submit(np.concatenate([hist, fu]), 4, session="b")
        eng.run_until_idle()
        book = _book(eng)
        eng.drop_sessions()
        eng.drop_prefix_cache()
        return (fragmented, moved, packed, before == after, pages,
                int(eng._c["defrag_pages_moved"].value),
                int(eng._c["defrag_total"].value), rb.result().tolist(),
                book, eng.kv_pages_in_use)
    ref, got = _both(models, run, max_slots=2, max_len=96, chunk=4,
                     cache_mode="paged", page_size=8, num_pages=49)
    assert got == ref
    fragmented, moved, packed, kept, _, counted, runs, out, book, left = got
    assert fragmented and moved > 0 and packed and kept
    assert counted == moved and runs == 1 and left == 0
    assert book["session_resumes"] == 1
    _, tm = models
    fresh = ServingEngine(tm, max_slots=2, max_len=96, chunk=4,
                          auto_run=False)
    hist = np.asarray(out[:-4], np.int32)
    r = fresh.submit(hist, 4)
    fresh.run_until_idle()
    assert r.result().tolist() == out


def test_defrag_moves_the_kv_rows(models):
    """The compaction's copy: after ``defrag()`` every remapped page holds
    the K and V rows its source held, layer by layer (a bit copy)."""
    _, tm = models
    eng = ServingEngine(tm, max_slots=2, max_len=64, chunk=4,
                        auto_run=False, cache_mode="paged", page_size=8,
                        num_pages=33)
    rs = np.random.RandomState(17)
    eng.submit(rs.randint(0, 128, (17,)).astype(np.int32), 4, session="x")
    eng.run_until_idle()
    eng.submit(rs.randint(0, 128, (20,)).astype(np.int32), 4, session="y")
    eng.run_until_idle()
    eng.drop_prefix_cache()
    with eng._lock:
        eng._evict_session_locked("x", donate=False)
    pages = list(eng._sessions["y"].pages)
    rows = [(k[pages].clone(), v[pages].clone()) for k, v in eng._caches]
    assert eng.defrag() > 0
    moved = list(eng._sessions["y"].pages)
    assert moved != pages
    for (k, v), (k0, v0) in zip(eng._caches, rows):
        assert bool((k[moved] == k0).all()) and bool((v[moved] == v0).all())
    assert eng.defrag() == 0                     # packed already
    eng.drop_sessions()
    assert eng.kv_pages_in_use == 0


def test_defrag_waits_for_a_quiet_pool(models):
    """``defrag()`` moves nothing while a request is queued or in flight,
    and is 0 in dense mode."""
    _, tm = models
    dense = ServingEngine(tm, max_slots=1, max_len=64, chunk=4,
                          auto_run=False)
    assert dense.defrag() == 0
    eng = ServingEngine(tm, max_slots=1, max_len=64, chunk=4,
                        auto_run=False, cache_mode="paged", page_size=8)
    eng.submit(np.arange(9, dtype=np.int32), 2, session="s")
    eng.run_until_idle()
    eng.drop_prefix_cache()
    eng.submit(np.arange(5, dtype=np.int32), 2)
    assert eng.defrag() == 0                     # queued
    eng.step()
    assert eng.defrag() == 0                     # in flight
    eng.run_until_idle()
    eng.drop_sessions()
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0


def test_load_report_sessions_block(models):
    """The sessions block of ``load_report`` and the introspection count,
    on both engines: zeros on an idle dense engine, then a paged engine's
    retained pages, evictable pages and the digests the prefix_digest
    block leads with."""
    def idle(eng):
        return (eng.load_report()["sessions"],
                eng.introspect_requests()["sessions"], eng.drop_sessions())
    ref, got = _both(models, idle, max_slots=2, max_len=64, chunk=4)
    assert got == ref
    assert got[0] == {"count": 0, "retained_pages": 0, "evictable_pages": 0}
    assert got[1:] == (0, 0)

    def paged(eng):
        r = eng.submit(np.arange(19, dtype=np.int32), 5, session="s")
        eng.run_until_idle()
        rep = eng.load_report()
        digs = rep["prefix_digest"]["digests"]
        sess = eng._sessions["s"]
        out = (rep["sessions"], eng.introspect_requests()["sessions"],
               digs[:len(sess.digests)] == sess.digests,
               rep["admission"], r.result().tolist())
        eng.drop_sessions()
        eng.drop_prefix_cache()
        return out
    ref, got = _both(models, paged, max_slots=2, max_len=64, chunk=4,
                     cache_mode="paged", page_size=8)
    assert got == ref
    assert got[0]["count"] == 1 and got[0]["retained_pages"] > 0
    assert got[1] == 1 and got[2]


def test_drain_donates_sessions_and_refuses_submits(models):
    """``drain()`` on a synchronously driven engine runs the backlog to
    the end, refuses later submits with ``EngineDraining`` and donates the
    retained sessions to the prefix cache, as the JAX engine does."""
    rs = np.random.RandomState(18)
    prompts = [rs.randint(0, 128, (17,)).astype(np.int32) for _ in range(3)]

    def run(eng):
        reqs = [eng.submit(p, 4, session=f"s{k}")
                for k, p in enumerate(prompts)]
        eng.drain(timeout=60)
        refused = False
        try:
            eng.submit(prompts[0], 2)
        except (EngineDraining, JDrain):
            refused = True
        cached = len(eng._prefix)
        out = ([r.result().tolist() for r in reqs], eng.draining, refused,
               len(eng._sessions), cached,
               int(eng._c["sessions_evicted"].value))
        eng.drain(timeout=5)                  # idempotent
        eng.drop_prefix_cache()
        return out + (eng.kv_pages_in_use,)
    ref, got = _both(models, run, max_slots=2, max_len=64, chunk=4,
                     cache_mode="paged", page_size=8)
    assert got == ref
    assert got[1] and got[2] and got[3] == 0 and got[4] > 0
    assert got[5] == 3 and got[6] == 0
