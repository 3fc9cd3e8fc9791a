"""The port's serving slice (``paddle_hackathon_tpu_torch``) as a whole:
the paged ServingEngine on the tiny GPT of ``test_paged.py`` is
token-exact against the JAX package's paged engine on shared weights and
against the port's own dense mode; the page pool drains; every engine and
submit option of the reference is accepted, and what is not ported yet
(the MoE and pipeline-parallel ticks) refuses loudly; and the package
imports without JAX or anything of the JAX package."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.inference import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.inference import ServingEngine
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_ENGINE = dict(max_slots=4, max_len=64, chunk=4)
# the straddle case of test_paged.py: prompt 4 + new 4 = need 8 = one full
# page at page_size=8, while the chunk-4 reserve writes rows [7, 11)
_STRADDLE = np.arange(4, dtype=np.int32) + 7


def _prompts(k=4, lens=(6, 9, 5, 11)):
    rs = np.random.RandomState(5)
    return [rs.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(k)]


@pytest.fixture(scope="module")
def shared():
    """(JAX model, port model) on the same weights, and the JAX paged
    engine's outputs for the 4 prompts and the straddle case."""
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    eng = JEngine(jm, auto_run=False, cache_mode="paged", page_size=8,
                  **_ENGINE)
    reqs = [eng.submit(p, 8) for p in _prompts()]
    eng.run_until_idle()
    straddle = eng.submit(_STRADDLE, 4)
    eng.run_until_idle()
    refs = [r.result() for r in reqs], straddle.result()
    eng.shutdown()
    return jm, tm, refs


def _serve(engine, prompts, new):
    reqs = [engine.submit(p, new) for p in prompts]
    engine.run_until_idle()
    assert all(r.done for r in reqs)
    return [r.result() for r in reqs]


def test_paged_engine_token_exact_vs_jax_engine_and_dense(shared):
    _, tm, (refs, straddle_ref) = shared
    eng = ServingEngine(tm, auto_run=False, cache_mode="paged", page_size=8,
                        **_ENGINE)
    outs = _serve(eng, _prompts(), 8)
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)
    dense = ServingEngine(tm, auto_run=False, **_ENGINE)
    for out, ref in zip(_serve(dense, _prompts(), 8), refs):
        np.testing.assert_array_equal(out, ref)
    assert eng.stats["tokens"] == dense.stats["tokens"] == 32
    assert all(not pages for pages in eng._slot_pages)   # released
    assert eng.kv_pages_in_use == len(eng._prefix.pages)
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0                       # no leak
    # the straddle case: the table holds the page past the last committed
    # row for the in-flight window
    np.testing.assert_array_equal(_serve(eng, [_STRADDLE], 4)[0],
                                  straddle_ref)
    np.testing.assert_array_equal(_serve(dense, [_STRADDLE], 4)[0],
                                  straddle_ref)
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0
    eng.shutdown()
    dense.shutdown()


def test_engine_matches_generate(shared):
    _, tm, _ = shared
    eng = ServingEngine(tm, auto_run=False, cache_mode="paged", page_size=8,
                        **_ENGINE)
    p = _prompts(1)[0]
    np.testing.assert_array_equal(
        eng.generate(p, 6),
        tm.generate(p[None], 6, temperature=0.0)[0].numpy())


def test_prefix_cache_skips_reprefill_and_stays_exact(shared):
    _, tm, _ = shared
    prompt = np.random.RandomState(7).randint(0, 128, (21,)).astype(np.int32)
    eng = ServingEngine(tm, auto_run=False, max_slots=2, max_len=64, chunk=4,
                        cache_mode="paged", page_size=8)
    first = _serve(eng, [prompt], 6)[0]
    ticks1 = eng.stats["ticks"]
    assert eng.stats["prefix_hit_tokens"] == 0
    assert len(eng._prefix) == 2                # 21 tokens = 2 full pages
    np.testing.assert_array_equal(_serve(eng, [prompt], 6)[0], first)
    assert eng.stats["prefix_hit_tokens"] == 16  # 2 pages skipped
    assert eng.stats["ticks"] - ticks1 < ticks1


def test_admission_queues_until_pages_free(shared):
    """A free slot is not capacity: the FIFO head waits for pages."""
    _, tm, (refs, _) = shared
    eng = ServingEngine(tm, auto_run=False, cache_mode="paged", page_size=8,
                        num_pages=9, prefix_cache=False, **_ENGINE)
    reqs = [eng.submit(p, 8) for p in _prompts()]
    occupied = []
    while eng.step():
        occupied.append(sum(s.req is not None for s in eng._slots))
    assert max(occupied) < 4
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(r.result(), ref)
    assert eng.kv_pages_in_use == 0


def test_write_window_tripwire(shared):
    _, tm, _ = shared
    eng = ServingEngine(tm, auto_run=False, max_slots=1, max_len=64, chunk=4,
                        cache_mode="paged", page_size=8)
    eng.submit(np.arange(6, dtype=np.int32), 8)
    assert eng.step()
    pg = int(eng._page_tables[0, int(eng._lengths[0]) // 8])
    eng._pool.incref(pg)                       # a simulated refcount bug
    with pytest.raises(RuntimeError, match="shared page"):
        eng.step()


def test_submit_rejects_what_does_not_fit(shared):
    _, tm, _ = shared
    eng = ServingEngine(tm, auto_run=False, max_slots=2, max_len=64, chunk=4,
                        cache_mode="paged", page_size=8, num_pages=3)
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(np.arange(20, dtype=np.int32), 20)
    with pytest.raises(ValueError, match="cache rows"):
        eng.submit(np.arange(40, dtype=np.int32), 30)


@pytest.mark.parametrize("kwargs", [
    {"auto_run": True}, {"priority_aging_s": 5.0}, {"prefill_budget": 8},
    {"prefill_budget": 1}, {"slo_window_s": 5.0}, {"session_ttl_s": 9.0},
    {"max_sessions": 2}, {"priority_aging_s": None}])
def test_unported_engine_options_raise(shared, kwargs):
    """The engine options a later slice ported are accepted and act as the
    reference's: each engine serves the prompts token-exact against the
    JAX engine (the loop when ``auto_run``, else the synchronous driver),
    and reports the option where the reference's ``load_report`` does."""
    _, tm, (refs, _) = shared
    kw = dict(_ENGINE, cache_mode="paged", page_size=8, **kwargs)
    kw.setdefault("auto_run", False)
    eng = ServingEngine(tm, **kw)
    reqs = [eng.submit(p, 8) for p in _prompts()]
    if eng.auto_run:
        assert all(r.wait(120) for r in reqs)
        eng.drain(timeout=60)
    else:
        eng.run_until_idle()
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(r.result(), ref)
    rep = eng.load_report()
    sched = rep["scheduler"]
    assert sched["priority_aging_s"] == kw.get("priority_aging_s", 30.0)
    assert sched["prefill_budget"] == kw.get("prefill_budget")
    assert rep["slo"]["window_s"] == kw.get("slo_window_s", 60.0)
    assert eng._session_ttl_s == kw.get("session_ttl_s")
    assert eng._max_sessions == kw.get("max_sessions", 64)
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0
    eng.shutdown()


@pytest.mark.parametrize("kwargs", [
    {"session": "chat"}, {"priority": "interactive"}, {"deadline_s": 600.0},
    {"on_token": print}, {"trace_ctx": {"trace_id": "t"}}])
def test_unported_submit_options_raise(shared, kwargs):
    """The submit options a later slice ported are accepted and act as the
    reference's: the request's tokens equal the JAX engine's and the
    option shows where the reference shows it."""
    _, tm, (refs, _) = shared
    eng = ServingEngine(tm, auto_run=False, **_ENGINE)
    streamed = []
    if "on_token" in kwargs:
        kwargs = {"on_token": streamed.append}
    req = eng.submit(_prompts(1)[0], 8, **kwargs)
    eng.run_until_idle()
    np.testing.assert_array_equal(req.result(), refs[0])
    if "session" in kwargs:
        assert list(eng._sessions) == ["chat"]
        np.testing.assert_array_equal(eng._sessions["chat"].tokens, refs[0])
    if "priority" in kwargs:
        assert req.lifecycle["priority"] == "interactive"
    if "deadline_s" in kwargs:
        assert req.lifecycle["deadline_s"] == 600.0 and req.error is None
    if "on_token" in kwargs:
        assert streamed == req.tokens + [None]
    assert req.trace_ctx == kwargs.get("trace_ctx")


def test_moe_and_pp_ticks_raise():
    """What the port still refuses, citing its ROADMAP item: a model with
    MoE layers (the MoE tick) and an ambient mesh with a pipeline axis
    (the pipeline-parallel tick)."""
    import dataclasses
    import types

    from paddle_hackathon_tpu_torch import parallel
    cfg = tgpt.GPTConfig(**_CFG)
    moe = types.SimpleNamespace(
        config=dataclasses.replace(cfg, moe_num_experts=4))
    with pytest.raises(NotImplementedError, match="item 11"):
        ServingEngine(moe, **_ENGINE)
    tm = tgpt.GPTForCausalLM(cfg, device="cpu")
    parallel.set_mesh({"dp": 1, "pp": 2})
    try:
        with pytest.raises(NotImplementedError, match="item 12"):
            ServingEngine(tm, **_ENGINE)
    finally:
        parallel.set_mesh(None)
    ServingEngine(tm, **_ENGINE)


@pytest.mark.parametrize("where", ["generate", "engine_init", "submit"])
def test_signatures_follow_the_reference(where):
    """Parameter names, order and defaults as the JAX package's; the
    port's own ``generator`` comes last, keyword only."""
    import inspect

    from paddle_hackathon_tpu.inference.serving import \
        ServingEngine as JEngine
    from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM as TGPT
    fns = {"generate": (JGPT.generate, TGPT.generate),
           "engine_init": (JEngine.__init__, ServingEngine.__init__),
           "submit": (JEngine.submit, ServingEngine.submit)}[where]
    ref, port = (list(inspect.signature(f).parameters.values())
                 for f in fns)
    extra = port[len(ref):]
    assert [p.name for p in port[:len(ref)]] == [p.name for p in ref]
    assert all(p.kind == p.KEYWORD_ONLY for p in extra)
    assert [p.name for p in extra] == (["generator"] if where == "generate"
                                       else [])
    assert [p.name for p, q in zip(port, ref) if p.default != q.default] \
        == []


def test_engine_takes_the_reference_defaults(shared):
    """Every reference parameter at its default value constructs,
    ``auto_run=True`` included, and ``generate`` then runs through the
    background loop."""
    _, tm, (refs, _) = shared
    eng = ServingEngine(tm, **_ENGINE, temperature=0.0, top_k=None,
                        eos_token_id=None, auto_run=True, decode_window=8,
                        top_p=None, spec_k=0, drafter="ngram",
                        cache_mode="dense", page_size=16, num_pages=None,
                        prefix_cache=True, slo_window_s=60.0,
                        session_ttl_s=None, max_sessions=64,
                        priority_aging_s=30.0, prefill_budget=None,
                        preempt=True, preempt_limit=2)
    np.testing.assert_array_equal(
        eng.generate(_prompts(1)[0], 8, timeout=120), refs[0])
    eng.shutdown(timeout=60)


def test_package_imports_without_jax():
    """Every module of the port imports with ``jax`` blocked, and none of
    them loads the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import paddle_hackathon_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        bad = [m for m in sys.modules if m == "paddle_hackathon_tpu"
               or m.startswith("paddle_hackathon_tpu.")]
        assert not bad, bad
        assert sys.modules["jax"] is None
        print("ok", len([m for m in sys.modules
                         if m.startswith("paddle_hackathon_tpu_torch")]))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_eos_stops_a_request_and_frees_its_slot(shared):
    _, tm, (refs, _) = shared
    prompt = _prompts(1)[0]
    gen = refs[0][len(prompt):]
    eos = int(gen[2])
    stop = int(np.nonzero(gen == eos)[0][0])     # first occurrence
    eng = ServingEngine(tm, auto_run=False, cache_mode="paged", page_size=8,
                        eos_token_id=eos,
                        **_ENGINE)
    out = _serve(eng, [prompt], 8)[0]
    np.testing.assert_array_equal(out, refs[0][:len(prompt) + stop + 1])
    assert all(s.req is None for s in eng._slots)
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0


def test_per_request_sampling_overrides(shared):
    """A greedy request on an engine whose default samples: the per-slot
    vector mode keeps it token-exact while its neighbours sample."""
    _, tm, (refs, _) = shared
    eng = ServingEngine(tm, auto_run=False, cache_mode="paged", page_size=8,
                        temperature=1.0,
                        top_k=20, **_ENGINE)
    prompts = _prompts()
    reqs = [eng.submit(prompts[0], 8, temperature=0.0)] + \
        [eng.submit(p, 8, top_p=0.9) for p in prompts[1:]]
    eng.run_until_idle()
    np.testing.assert_array_equal(reqs[0].result(), refs[0])
    for r in reqs[1:]:
        toks = np.asarray(r.tokens)
        assert len(toks) == 8 and ((toks >= 0) & (toks < 128)).all()
