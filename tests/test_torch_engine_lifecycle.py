"""The port's ``ServingEngine`` lifecycle stages (``paddle_hackathon_
tpu_torch``) against the JAX package's engine on the same weights (2-layer
GPT, hidden 64, f32, greedy): deadlines queued and in a slot, ``on_token``
streams, the ``auto_run`` loop driven from several threads with ``drain``
and ``shutdown``, the single-driver guard, the loop's crash path, the race
sanitizer over a loop run, ``trace_ctx`` in the lifecycle record, the
``load_report`` / ``slo_windows`` / ``introspect_requests`` reports key
for key, and ``/load`` and ``/debug/requests`` over the port's
introspection server."""

import http.client
import json
import threading

import numpy as np
import pytest

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.inference.serving import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.observability import tracing as jtracing
from paddle_hackathon_tpu_torch.inference import (DeadlineExceededError,
                                                  EngineDraining,
                                                  ServingEngine)
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.observability import sanitizers as tsan
from paddle_hackathon_tpu_torch.observability import tracing as ttracing
from paddle_hackathon_tpu_torch.observability.server import \
    start_introspection_server
from paddle_hackathon_tpu_torch.utils import load_jax_state

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_ENGINE = dict(max_slots=2, max_len=64, chunk=4)


def _prompts(k=4, lens=(6, 9, 5, 11)):
    rs = np.random.RandomState(5)
    return [rs.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(k)]


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) on the same weights, and the JAX engine's
    greedy outputs for ``_prompts(8)`` at 8 new tokens."""
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    eng = JEngine(jm, auto_run=False, **_ENGINE)
    reqs = [eng.submit(p, 8) for p in _prompts(8)]
    eng.run_until_idle()
    refs = [r.result() for r in reqs]
    eng.shutdown(timeout=5)
    return jm, tm, refs


def _both(models, scenario, **kw):
    """``scenario(engine)`` on a JAX engine and a port engine built with
    ``kw`` (synchronously driven); returns ``(jax_result, port_result)``."""
    jm, tm, _ = models
    out = []
    for cls, m in ((JEngine, jm), (ServingEngine, tm)):
        eng = cls(m, auto_run=False, **dict(_ENGINE, **kw))
        out.append(scenario(eng))
        eng.shutdown(timeout=5)
    return out


def _shape(x, key=None):
    """A report with its run-dependent values reduced: ids and engine
    names to their type, floats to (type, sign); everything else as is."""
    if key in ("rid", "engine"):
        return type(x).__name__
    if isinstance(x, dict):
        return {k: _shape(v, k) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_shape(v) for v in x]
    if isinstance(x, float):
        return ("float", (x > 0) - (x < 0))
    return x


# ------------------------------------------------------------- deadlines

def test_queued_deadline_aborts_unadmitted(models):
    """A request still queued past its ``deadline_s`` is aborted at the
    next admission: ``result()`` raises from ``DeadlineExceededError``,
    its lifecycle and the ``recent_aborts`` ring read
    ``where="deadline"``, the stream ends in ``None``; the request ahead
    finishes with the JAX engine's tokens."""
    p = _prompts()

    def run(eng):
        streamed = []
        first = eng.submit(p[0], 8)
        late = eng.submit(p[1], 4, deadline_s=0.0,
                          on_token=streamed.append)
        eng.run_until_idle()
        try:
            late.result()
            cause = None
        except RuntimeError as e:
            cause = type(e.__cause__).__name__
        lc = late.lifecycle
        aborts = eng.introspect_requests()["recent_aborts"]
        return (first.result().tolist(), late.done, late.wait(0), cause,
                {k: lc[k] for k in ("aborted", "where", "error", "tokens")},
                "t_admit" in lc, "t_abort" in lc, streamed,
                [(a["where"], a["error"], a["tokens"]) for a in aborts],
                eng.load_report()["goodput"], eng._deadline_queued)
    ref, got = _both(models, run, max_slots=1)
    assert got == ref
    assert got[0] == models[2][0].tolist()
    assert got[3] == "DeadlineExceededError" and not got[1]
    assert got[4] == {"aborted": True, "where": "deadline",
                      "error": "DeadlineExceededError", "tokens": 0}
    assert not got[5] and got[6] and got[7] == [None]
    assert got[8] == [("deadline", "DeadlineExceededError", 0)]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_slot_deadline_aborts_mid_decode_and_frees_pages(models, mode):
    """A request still decoding past its deadline is aborted before the
    next tick: its generated tokens count as aborted work, its slot and
    pages are freed, and the stream ends in ``None`` after its tokens."""
    kw = {} if mode == "dense" else dict(cache_mode="paged", page_size=8)
    p = _prompts()

    def run(eng):
        streamed = []
        req = eng.submit(p[2], 30, deadline_s=1e6, on_token=streamed.append)
        for _ in range(4):
            eng.step()
        req.deadline_s = 0.0                 # the budget runs out here
        eng.run_until_idle()
        eng.drop_prefix_cache()
        lc = req.lifecycle
        return (len(req.tokens), isinstance(req.error, RuntimeError),
                type(req.error).__name__, lc["where"], lc["tokens"],
                streamed, int(eng._c["aborted_tokens"].value),
                int(eng._c["completed_tokens"].value),
                eng.kv_pages_in_use, eng.introspect_requests()["slots"])
    ref, got = _both(models, run, **kw)
    assert got == ref
    n = got[0]
    assert 0 < n < 30 and got[2] == "DeadlineExceededError"
    assert got[3] == "deadline" and got[4] == n and got[6] == n
    assert got[5][-1] is None and len(got[5]) == n + 1
    assert got[7] == 0 and got[8] == 0 and got[9] == [None, None]
    assert isinstance(DeadlineExceededError("x"), RuntimeError)


# --------------------------------------------------------------- streams

@pytest.mark.parametrize("kw", [{}, dict(cache_mode="paged", page_size=8,
                                         spec_k=4)])
def test_on_token_streams_equal_results(models, kw):
    """Every committed token reaches ``on_token`` in order, then one
    ``None``; a hook that raises is dropped with a flight mark and the
    other streams go on.  The streams equal the JAX engine's."""
    p = _prompts()

    def run(eng):
        got = {k: [] for k in range(3)}

        def broken(tok):
            raise ValueError("consumer bug")
        reqs = [eng.submit(q, 8, on_token=got[k].append)
                for k, q in enumerate(p[:3])]
        reqs.append(eng.submit(p[3], 8, on_token=broken))
        eng.run_until_idle()
        for k, r in enumerate(reqs[:3]):
            assert got[k] == r.tokens + [None]
        return [r.result().tolist() for r in reqs], got
    ref, got = _both(models, run, **kw)
    assert got == ref
    assert got[0] == [r.tolist() for r in models[2][:4]]


# ------------------------------------------------------------ the loop

def test_auto_run_loop_from_several_threads(models):
    """Four threads call ``generate`` on one ``auto_run`` engine; the loop
    batches their requests, each result equals the JAX engine's, the loop
    idles out, and ``drain`` / ``shutdown`` finish it: no beacon left, the
    engine gone from ``/load``."""
    _, tm, refs = models
    eng = ServingEngine(tm, cache_mode="paged", page_size=8, **_ENGINE)
    prompts = _prompts(8)
    outs, errors = {}, []

    def client(k):
        try:
            for j in (k, k + 4):
                outs[j] = eng.generate(prompts[j], 8, timeout=120)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not errors
    for j in range(8):
        np.testing.assert_array_equal(outs[j], refs[j])
    eng.drain(timeout=60)
    assert eng.draining and not eng._running
    with pytest.raises(EngineDraining):
        eng.submit(prompts[0], 2)
    assert f"serving.{eng.engine_id}" not in ttracing.beacon_ages()
    eid = eng.engine_id
    assert eid in ttracing.load_reports()
    eng.shutdown(timeout=60)
    assert eid not in ttracing.load_reports()
    assert eid not in ttracing.introspection_tables()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(prompts[0], 2)


def test_loop_under_thread_stress(models):
    """32 requests from 16 threads at a shortened switch interval: every
    request completes token-exact, and the engine's counters add up (a
    lost update would break them)."""
    import sys
    _, tm, refs = models
    eng = ServingEngine(tm, cache_mode="paged", page_size=8,
                        **dict(_ENGINE, max_slots=4))
    prompts = _prompts(8)
    got, errors = [], []
    lock = threading.Lock()

    def client(k):
        try:
            reqs = [eng.submit(prompts[(k + j) % 8], 8) for j in (0, 1)]
            for r in reqs:
                r.wait(300)
                with lock:
                    got.append((r.prompt.tolist(), r.result()))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(got) == 32
    ref = {tuple(r[:-8].tolist()): r for r in refs}
    for prompt, out in got:
        np.testing.assert_array_equal(out, ref[tuple(prompt)])
    eng.drain(timeout=120)
    assert eng.stats["requests"] == 32 and eng.stats["tokens"] == 256
    assert int(eng._c["completed_tokens"].value) == 256
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0
    eng.shutdown(timeout=60)


def test_loop_idles_out_and_restarts(models):
    """The loop thread exits once nothing is queued or in flight, and the
    next submit starts a new one; the engine can then be driven
    synchronously, as the reference allows."""
    _, tm, refs = models
    eng = ServingEngine(tm, **_ENGINE)
    p = _prompts(8)
    r = eng.submit(p[0], 8)
    assert r.wait(120)
    eng._loop_thread.join(60)
    first = eng._loop_thread
    assert not eng._running and not first.is_alive()
    r2 = eng.submit(p[1], 8)
    assert r2.wait(120)
    eng._loop_thread.join(60)
    assert eng._loop_thread is not first
    np.testing.assert_array_equal(r.result(), refs[0])
    np.testing.assert_array_equal(r2.result(), refs[1])
    assert not eng.step()                 # idle: the caller may drive
    eng.shutdown(timeout=60)


def _blocked(eng):
    """Hold the engine's next chunk tick until the returned event is set;
    the second event is set once the tick has started."""
    gate, entered = threading.Event(), threading.Event()
    real = eng._run_tick

    def held(*a, **k):
        entered.set()
        gate.wait(60)
        return real(*a, **k)
    eng._run_tick = held
    return gate, entered


def test_single_driver_guard_raises_without_a_dump(models, monkeypatch,
                                                   tmp_path):
    """While the loop drives, ``step()``, ``run_until_idle()`` and
    ``defrag()`` from another thread raise a usage error that writes no
    crash dump; ``generate(timeout=)`` raises ``TimeoutError``; the
    request then finishes token-exact."""
    _, tm, refs = models
    monkeypatch.setenv("PHT_FLIGHT_DIR", str(tmp_path))
    eng = ServingEngine(tm, cache_mode="paged", page_size=8, **_ENGINE)
    gate, entered = _blocked(eng)
    p = _prompts(8)
    req = eng.submit(p[0], 8)
    assert entered.wait(60)
    try:
        for call in (eng.step, eng.run_until_idle, eng.defrag):
            with pytest.raises(RuntimeError, match="auto_run loop") as ei:
                call()
            assert ei.value._pht_usage_error
        with pytest.raises(TimeoutError):
            eng.generate(p[1], 8, timeout=0.05)
        assert list(tmp_path.iterdir()) == []
    finally:
        gate.set()
    assert req.wait(120)
    np.testing.assert_array_equal(req.result(), refs[0])
    eng.drain(timeout=60)
    eng.shutdown(timeout=60)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_loop_crash_fails_every_request_and_pins_the_beacon(
        models, monkeypatch, tmp_path):
    """A tick that raises in the loop fails the request in its slot and
    the one queued behind it with the cause, ends their streams, frees
    their pages and the retained sessions, pins the liveness beacon and
    writes a crash dump; ``drain`` then reports the crash.  A new burst
    after the cause is gone serves again."""
    _, tm, refs = models
    monkeypatch.setenv("PHT_FLIGHT_DIR", str(tmp_path))
    eng = ServingEngine(tm, cache_mode="paged", page_size=8,
                        **dict(_ENGINE, max_slots=1))
    p = _prompts(8)
    kept = eng.submit(p[0], 8, session="chat")
    assert kept.wait(120) and "chat" in eng._sessions
    eng._loop_thread.join(60)

    gate = threading.Event()

    def boom(*a, **k):
        gate.wait(60)            # both requests queued before the crash
        raise RuntimeError("forced tick failure")
    eng._run_tick = boom
    streams = ([], [])
    reqs = [eng.submit(q, 4, on_token=s.append)
            for q, s in zip(p[1:3], streams)]
    gate.set()
    for r in reqs:
        assert not r.wait(60)            # failed: set, but not done
    eng._loop_thread.join(60)
    for r, where in zip(reqs, ("slot", "pending")):
        assert isinstance(r.error, RuntimeError)
        assert str(r.error) == "forced tick failure"
        lc = r.lifecycle
        assert lc["aborted"] is True and lc["where"] == where
        assert lc["error"] == "RuntimeError" and "t_finish" not in lc
    assert streams == ([None], [None])
    assert eng._sessions == {} and not eng._running
    eng.drop_prefix_cache()
    assert eng.kv_pages_in_use == 0
    assert f"serving.{eng.engine_id}" in ttracing.beacon_ages()
    (dump,) = list(tmp_path.iterdir())
    events = json.loads(dump.read_text())["events"]
    assert events[-1]["kind"] == "crash"
    assert {e.get("where") for e in events
            if e.get("phase") == "fail"} == {"slot", "pending"}
    with pytest.raises(RuntimeError, match="crashed while draining"):
        eng.drain(timeout=10)
    del eng._run_tick
    eng._draining = False
    again = eng.submit(p[3], 8)
    assert again.wait(120) and eng._crashed is None
    np.testing.assert_array_equal(again.result(), refs[3])
    eng.drain(timeout=60)
    eng.shutdown(timeout=60)
    assert f"serving.{eng.engine_id}" not in ttracing.beacon_ages()


def test_race_sanitizer_over_a_loop_run(models):
    """The lock and race sanitizers over a loop run fed from three
    threads (the engine built inside them, so its lock and attributes are
    instrumented): no lock-order error, no data race, token-exact."""
    _, tm, refs = models
    p = _prompts(8)
    errors, outs = [], {}
    with tsan.lock_sanitizer(), tsan.race_sanitizer():
        eng = ServingEngine(tm, cache_mode="paged", page_size=8, spec_k=4,
                            **_ENGINE)
        assert type(eng).__name__.startswith("_RaceShim_")

        def client(k):
            try:
                r = eng.submit(p[k], 8, on_token=lambda t: None)
                assert r.wait(120)
                outs[k] = r.result()
                eng.load_report()
                eng.introspect_requests()
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        eng.drain(timeout=60)
        eng.shutdown(timeout=60)
    assert not errors, errors
    for k in range(3):
        np.testing.assert_array_equal(outs[k], refs[k])


# ----------------------------------------------------------- reporting

def test_trace_ctx_lands_in_lifecycle_and_spans(models):
    """``trace_ctx``'s ``fleet_rid`` and ``attempt`` land in the
    lifecycle record (as the JAX engine stamps them) and ``fleet_rid`` on
    the request's lifecycle spans and its submit flight event."""
    ctx = {"fleet": "f0", "fleet_rid": 41, "attempt": 2}
    p = _prompts()

    def run(eng):
        mod = ttracing if isinstance(eng, ServingEngine) else jtracing
        spans = []
        mod.set_span_sink(lambda name, t0, t1, tid, attrs:
                          spans.append((name, attrs)))
        mod.enable_tracing()
        try:
            req = eng.submit(p[0], 4, trace_ctx=ctx)
            plain = eng.submit(p[1], 4)
            eng.run_until_idle()
        finally:
            mod.disable_tracing()
            mod.set_span_sink(None)
        lc = req.lifecycle
        tagged = sorted(n for n, a in spans if a.get("fleet_rid") == 41)
        return ({k: lc.get(k) for k in ("fleet_rid", "dispatch_attempt")},
                "fleet_rid" in plain.lifecycle, tagged, req.trace_ctx)
    ref, got = _both(models, run)
    assert got == ref
    assert got[0] == {"fleet_rid": 41, "dispatch_attempt": 2}
    assert not got[1] and got[3] == ctx
    assert got[2] == ["serving.request", "serving.request.queued"]


def test_reports_match_jax_key_for_key(models):
    """``load_report``, ``slo_windows`` and ``introspect_requests`` of the
    two engines after the same traffic (mid-run and drained, dense and
    paged with a session and a preemption): the same keys and the same
    counts, times the same type and sign."""
    p = _prompts()

    def run(eng):
        eng.submit(p[0], 12, priority="batch", session="s")
        eng.submit(p[1], 6)
        eng.submit(p[2], 6, deadline_s=0.0)
        for _ in range(3):
            eng.step()
        eng.submit(p[3], 4, priority="interactive")
        eng.step()
        mid = (eng.load_report(), eng.introspect_requests())
        eng.run_until_idle()
        slo = {k: (type(h).__name__, h.count)
               for k, h in eng.slo_windows().items()}
        return _shape([mid, eng.load_report(), eng.introspect_requests(),
                       slo])
    for kw in ({}, dict(cache_mode="paged", page_size=8)):
        ref, got = _both(models, run, **kw)
        assert got == ref
        mid, done = got[0][0], got[1]
        assert done["slo"]["ttft"]["count"] == 3
        assert done["goodput"]["aborted_tokens"] == 0
        assert set(done) >= {"version", "engine", "ts", "running",
                             "draining", "tickno", "slots", "queue",
                             "modes", "slo", "goodput", "admission",
                             "sessions", "scheduler"}
        assert mid["scheduler"]["preemptions"] == 1
        assert got[3] == {k: ["SlidingWindowHistogram", c] for k, c in
                          (("ttft", 3), ("tpot", got[3]["tpot"][1]),
                           ("e2e", 3), ("queue_wait", 4))}


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def test_load_and_debug_requests_over_the_server(models):
    """``/load`` serves the engine's ``load_report`` and
    ``/debug/requests`` its slot table and, as ``<engine>.load``, the same
    report; both forget the engine at shutdown."""
    _, tm, _ = models
    srv = start_introspection_server(0)
    try:
        eng = ServingEngine(tm, auto_run=False, cache_mode="paged",
                            page_size=8, **_ENGINE)
        eid = eng.engine_id
        for q in _prompts(2):
            eng.submit(q, 8)
        eng.step()
        code, body = _get(srv.port, "/load")
        assert code == 200 and body["version"] == 1
        rep = body["engines"][eid]
        assert set(rep) == set(eng.load_report())
        assert rep["slots"] == {"max": 2, "active": 2, "free": 0}
        assert rep["modes"]["cache"] == "paged"
        code, body = _get(srv.port, "/debug/requests")
        assert code == 200
        table = body["sources"][eid]
        assert [row["slot"] for row in table["slots"]] == [0, 1]
        assert set(body["sources"][f"{eid}.load"]) == set(rep)
        eng.run_until_idle()
        code, body = _get(srv.port, "/load")
        assert body["engines"][eid]["goodput"]["completed_tokens"] == 16
        eng.shutdown()
        code, body = _get(srv.port, "/load")
        assert eid not in body["engines"]
        code, body = _get(srv.port, "/debug/requests")
        assert eid not in body["sources"]
        assert f"{eid}.load" not in body["sources"]
    finally:
        srv.stop()
