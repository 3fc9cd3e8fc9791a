"""Priority classes, aging, preemption and ``prefill_budget`` of the
port's ``ServingEngine`` (``paddle_hackathon_tpu_torch``), mirroring the
engine-level cases of ``test_priority.py``: each scenario runs step for
step through the JAX package's engine and the port's on the same weights
(2-layer GPT, hidden 64, f32, greedy) and must give the same tokens,
admission order and scheduler counters (preemptions, replayed rows,
prefix and session hits, ticks); a preempted stream must also equal the
same request served without pressure, and no page may be left."""

import time

import numpy as np
import pytest

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.inference.serving import PRIORITY_RANK as JRANK
from paddle_hackathon_tpu.inference.serving import Request as JRequest
from paddle_hackathon_tpu.inference.serving import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.inference import (PRIORITY_RANK, Request,
                                                  ServingEngine)
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_COUNTERS = ("preemptions", "preempt_replay_tokens", "prefix_hit_tokens",
             "session_resumes", "session_hit_tokens", "ticks", "tokens",
             "prompt_tokens")
_BATCH = (np.arange(16) % 50).astype(np.int32)
_INTER = (np.arange(8) % 50 + 3).astype(np.int32)


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


def _counters(eng):
    return {k: int(eng.stats[k]) for k in _COUNTERS}


def test_request_priority_validation():
    assert PRIORITY_RANK == JRANK
    for cls in (Request, JRequest):
        assert cls([1, 2], 4).priority == "default"
        assert cls([1, 2], 4, priority="interactive")._prank == 0
        assert cls([1, 2], 4, priority="batch")._prank == 2
        with pytest.raises(ValueError):
            cls([1, 2], 4, priority="bogus")
    r = Request([1, 2], 4, priority="batch", deadline_s=2.0)
    assert r._t_queued == r.t_submit
    assert r.lifecycle["priority"] == "batch"
    assert r.lifecycle["deadline_s"] == 2.0


@pytest.mark.parametrize("aging", [10.0, None])
def test_effective_rank_ages_toward_interactive(models, aging):
    """The effective class at the same waits, on both engines: one class
    per ``priority_aging_s``, floored at interactive; static without
    aging."""
    jm, tm = models
    je = JEngine(jm, max_slots=1, max_len=32, chunk=4, auto_run=False,
                 priority_aging_s=aging)
    te = ServingEngine(tm, max_slots=1, max_len=32, chunk=4,
                       auto_run=False, priority_aging_s=aging)
    for prio in PRIORITY_RANK:
        req = Request([1], 2, priority=prio)
        jreq = JRequest([1], 2, priority=prio)
        for wait in (0.0, 10.5, 25.0, 300.0):
            got = te._eff_rank_locked(req, req.t_submit + wait)
            assert got == je._eff_rank_locked(jreq, jreq._t_submit + wait)
    batch = Request([1], 2, priority="batch")
    now = batch.t_submit
    want = [2, 1, 0, 0] if aging else [2, 2, 2, 2]
    assert [te._eff_rank_locked(batch, now + w)
            for w in (0.0, 10.5, 25.0, 300.0)] == want
    je.shutdown(timeout=5)
    te.shutdown(timeout=5)


def test_priority_admission_order_single_slot(models):
    """On one slot the later interactive request admits before the older
    batch one; both finish with the JAX engine's tokens."""
    def run(eng):
        rb = eng.submit(np.arange(10, dtype=np.int32), 4, priority="batch")
        ri = eng.submit(np.arange(10, dtype=np.int32) + 2, 4,
                        priority="interactive")
        eng.step()
        first = eng._slots[0].req
        eng.run_until_idle()
        assert rb.done and ri.done
        assert rb.lifecycle["priority"] == "batch"
        return first is ri, list(rb.tokens), list(ri.tokens)
    ref, got = _both(models, run, max_slots=1, max_len=64, chunk=4)
    assert got == ref and got[0]


def test_prefill_budget_staging_is_priority_ordered(models):
    """White-box ``_stage`` on both engines over the same slots: with the
    budget contended, prefill width goes best class first, decode feeds
    are never deferred, and a resume slot's final replay chunk never
    stages as finishing."""
    def run(eng):
        def fab(i, req, off, last=0, resume=False):
            s = eng._slots[i]
            s.req, s.seq, s.off, s.last, s.resume = (
                req, req.prompt, off, last, resume)
            eng._lengths[i] = off
        req_cls = Request if isinstance(eng, ServingEngine) else JRequest
        fab(0, req_cls(np.arange(32), 4, priority="batch"), 0)
        fab(1, req_cls(np.arange(20), 4, priority="interactive"), 0)
        fab(2, req_cls(np.arange(4), 8, priority="default"), 4, last=7)
        staged = [eng._stage()]
        eng._prefill_budget = None
        eng._slots[0].seq = np.arange(12, dtype=np.int32)
        eng._slots[0].off = 8
        eng._slots[0].resume = True
        eng._slots[1].req = eng._slots[2].req = None
        staged.append(eng._stage())
        eng._slots[0].resume = False
        staged.append(eng._stage())
        for s in eng._slots:
            s.req = None
        return [[np.asarray(a).tolist() for a in st] for st in staged]
    ref, got = _both(models, run, max_slots=3, max_len=64, chunk=8,
                     prefill_budget=10)
    assert got == ref
    (_, _, _, consumed, finishing), resume, plain = got
    assert consumed == [2, 8, 1] and finishing == [False, False, True]
    assert resume[3][0] == 4 and not resume[4][0]
    assert plain[4][0]


@pytest.mark.parametrize("budget", [1, 6, 16])
def test_prefill_budget_run_matches_jax(models, budget):
    """A mixed load under a per-tick prefill budget: the same tokens and
    the same tick count as the JAX engine, and at least the ticks of the
    same load without a budget."""
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 128, n).astype(np.int32) for n in (21, 9, 14)]

    def run(eng):
        reqs = [eng.submit(p, 6, priority=c) for p, c in
                zip(prompts, ("batch", "interactive", "default"))]
        eng.run_until_idle()
        return [list(r.tokens) for r in reqs], _counters(eng)
    ref, got = _both(models, run, max_slots=3, max_len=64, chunk=8,
                     prefill_budget=budget)
    assert got == ref
    free = ServingEngine(models[1], auto_run=False, max_slots=3, max_len=64,
                         chunk=8)
    assert got[1]["ticks"] >= run(free)[1]["ticks"]


@pytest.mark.parametrize("mode", ["dense", "paged", "spec"])
@pytest.mark.parametrize("session", [None, "conv"])
def test_preempt_resume_token_exact(models, mode, session):
    """A batch stream preempted mid-decode by an interactive arrival
    (dense: no free slot; paged and spec: a pool its footprint fills)
    resumes and completes with the tokens of the same request served
    without pressure; the JAX engine preempts at the same tick and counts
    the same replayed rows, prefix and session hits.  A session stream is
    demoted to session-retained and resumes from its chain."""
    kw = {"dense": dict(max_slots=1),
          "paged": dict(max_slots=2, cache_mode="paged", page_size=8,
                        num_pages=9),
          "spec": dict(max_slots=2, cache_mode="paged", page_size=8,
                       num_pages=9, spec_k=4)}[mode]
    prompt = np.tile(np.arange(4, dtype=np.int32), 4) if mode == "spec" \
        else _BATCH

    def run(eng):
        rb = eng.submit(prompt, 32, priority="batch", session=session)
        for _ in range(6):
            eng.step()
        assert rb.tokens and not rb.done   # mid-decode
        ri = eng.submit(_INTER, 8, priority="interactive")
        eng.step()
        retained = None
        if session is not None and eng._paged:
            sess = eng._sessions.get(session)
            retained = bool(sess is not None and sess.pages
                            and not sess.busy)
        eng.run_until_idle()
        assert rb.done and ri.done and len(rb.tokens) == 32
        eng.drop_sessions()
        eng.drop_prefix_cache()
        return (list(rb.tokens), list(ri.tokens), rb._preempts,
                rb.lifecycle["preemptions"], retained, _counters(eng),
                eng.kv_pages_in_use)
    ref, got = _both(models, run, max_len=64, chunk=4, **kw)
    assert got == ref
    assert got[2] >= 1 and got[5]["preemptions"] >= 1
    assert got[6] == 0                      # no page left
    if session is not None and mode != "dense":
        assert got[4] and got[5]["session_resumes"] >= 1
    if mode == "dense":
        # nothing to donate: the whole replay source is re-prefilled
        assert got[5]["preempt_replay_tokens"] > 0
    quiet = ServingEngine(models[1], auto_run=False, max_len=64, chunk=4,
                          **dict(kw, num_pages=None))
    alone = quiet.submit(prompt, 32)
    quiet.run_until_idle()
    assert list(alone.tokens) == got[0]


@pytest.mark.parametrize("kw", [dict(preempt=False), dict(preempt_limit=0)])
def test_preemption_off_waits_instead(models, kw):
    """``preempt=False`` or a zero ``preempt_limit``: the interactive
    arrival waits for the batch stream, as in the JAX engine."""
    def run(eng):
        rb = eng.submit(_BATCH, 16, priority="batch")
        for _ in range(4):
            eng.step()
        ri = eng.submit(_INTER, 4, priority="interactive")
        eng.run_until_idle()
        return (list(rb.tokens), list(ri.tokens), _counters(eng),
                ri.lifecycle["t_admit"] >= rb.lifecycle["t_finish"])
    ref, got = _both(models, run, max_slots=1, max_len=64, chunk=4, **kw)
    assert got[:3] == ref[:3]
    assert got[2]["preemptions"] == 0 and got[3]


def test_preempt_limit_caps_a_victim(models):
    """A batch stream under ``preempt_limit=1`` is preempted once and
    then never again, however many interactive requests arrive."""
    def run(eng):
        rb = eng.submit(_BATCH, 24, priority="batch")
        for _ in range(4):
            eng.step()
        inter = []
        for k in range(3):
            inter.append(eng.submit(_INTER + k, 4, priority="interactive"))
            for _ in range(3):
                eng.step()
        eng.run_until_idle()
        return (list(rb.tokens), [list(r.tokens) for r in inter],
                rb._preempts, _counters(eng))
    ref, got = _both(models, run, max_slots=1, max_len=64, chunk=4,
                     preempt_limit=1)
    assert got == ref and got[2] == 1


def test_aging_prevents_batch_starvation(models):
    """Under a sustained interactive load on one slot a batch request
    still completes: aging promotes it until, being oldest, it outranks
    fresh interactive arrivals.  Its tokens are the JAX engine's."""
    jm, tm = models
    prompt = np.arange(6, dtype=np.int32)
    ref = JEngine(jm, max_slots=1, max_len=32, chunk=4, auto_run=False)
    rr = ref.submit(prompt, 2)
    ref.run_until_idle()
    eng = ServingEngine(tm, max_slots=1, max_len=32, chunk=4,
                        auto_run=False, priority_aging_s=1.0)
    rb = eng.submit(prompt, 2, priority="batch")
    inter = [eng.submit(prompt + 1, 1, priority="interactive")
             for _ in range(2)]
    done_order = []
    t_end = time.monotonic() + 30
    while time.monotonic() < t_end:
        eng.step()
        for r in list(inter):
            if r.done:
                done_order.append("interactive")
                inter.remove(r)
                inter.append(eng.submit(prompt + 1, 1,
                                        priority="interactive"))
        if rb.done:
            done_order.append("batch")
            break
    assert rb.done, "aging failed: batch starved under interactive load"
    assert done_order[0] == "interactive" and done_order[-1] == "batch"
    assert list(rb.tokens) == list(rr.tokens)
    ref.shutdown(timeout=5)


def test_load_report_class_queues_and_scheduler_block(models):
    """The class queues and the scheduler block of ``load_report`` on
    both engines with the same queue."""
    def run(eng):
        eng.submit([1, 2], 2, priority="batch")
        eng.submit([3, 4], 2, priority="batch")
        eng.submit([5, 6], 2, priority="interactive")
        rep = eng.load_report()
        cls = {c: row["depth"] for c, row in rep["queue"]["classes"].items()}
        waits = rep["queue"]["classes"]
        ordered = (waits["batch"]["oldest_wait_s"]
                   >= waits["interactive"]["oldest_wait_s"] >= 0.0)
        eng.run_until_idle()
        return (rep["version"], cls, ordered,
                waits["default"]["oldest_wait_s"], rep["scheduler"],
                {c: set(h) for c, h in rep["slo"]["classes"].items()})
    ref, got = _both(models, run, max_slots=1, max_len=32, chunk=4,
                     prefill_budget=16)
    assert got == ref
    assert got[1] == {"interactive": 1, "default": 0, "batch": 2}
    assert got[2] and got[3] == 0.0
    assert got[4] == {"preemptions": 0, "preempt_replay_tokens": 0,
                      "preempt": True, "preempt_limit": 2,
                      "prefill_budget": 16, "priority_aging_s": 30.0}


def test_class_queue_gauges_count_by_class(models):
    """``serving_class_queue_depth`` counts the queue by class, as the
    reference's gauges do."""
    _, tm = models
    eng = ServingEngine(tm, max_slots=1, max_len=32, chunk=4,
                        auto_run=False)
    for prio in ("batch", "batch", "interactive", None):
        eng.submit([1, 2], 2, priority=prio)
    with eng._lock:
        eng._set_queue_gauges_locked()
    assert {c: int(g.value) for c, g in eng._g_class_queue.items()} == \
        {"interactive": 1, "default": 1, "batch": 2}
    eng.run_until_idle()
    assert {int(g.value) for g in eng._g_class_queue.values()} == {0}
