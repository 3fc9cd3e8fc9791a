"""The port's ``observability/`` against the JAX package's, and the
serving engine's instrumentation: the registry's text exposition, the
seeded fault schedules, the span names and nesting, the lock-order
checker, and the host-transfer guard rebuilt over ``torch.Tensor`` (a
steady-state engine tick passes under it, a planted ``.item()`` does
not).

Tolerances: everything here is compared exactly (text, hit indices, span
sequences, counter and gauge values); wall-time histograms are compared
by their observation counts only."""

import http.client
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.inference import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.observability import faults as jfaults
from paddle_hackathon_tpu.observability import flight as jflight
from paddle_hackathon_tpu.observability import metrics as jmetrics
from paddle_hackathon_tpu.observability import sanitizers as jsan
from paddle_hackathon_tpu.observability import tracing as jtracing
from paddle_hackathon_tpu_torch import observability as tobs
from paddle_hackathon_tpu_torch.inference import ServingEngine
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.observability import faults as tfaults
from paddle_hackathon_tpu_torch.observability import flight as tflight
from paddle_hackathon_tpu_torch.observability import metrics as tmetrics
from paddle_hackathon_tpu_torch.observability import sanitizers as tsan
from paddle_hackathon_tpu_torch.observability import tracing as ttracing
from paddle_hackathon_tpu_torch.utils import load_jax_state

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_ENGINE = dict(max_slots=4, max_len=64, chunk=4, spec_k=4, page_size=8,
               decode_window=4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    return jm, tm


def _prompts():
    rs = np.random.RandomState(5)
    return [rs.randint(0, 128, (n,)).astype(np.int32) for n in (6, 11, 5)] \
        + [np.tile(np.array([9, 7, 5], np.int32), 4)]


# ---------------------------------------------------------------- metrics

def _registry_ops(mod):
    """One sequence of registry operations; returns its text exposition,
    its snapshot without the timestamp, and a snapshot delta."""
    reg = mod.MetricRegistry(enabled=True)
    c = reg.counter("demo_requests_total", "requests seen")
    c.labels(route="a").inc()
    c.labels(route="b").inc(3)
    g = reg.gauge("demo_depth", "queue depth", unit="items")
    g.set(5)
    g.labels(cls="x").set(2.5)
    h = reg.histogram("demo_latency_seconds", "latency", unit="s")
    for v in (1e-5, 3e-4, 0.02, 0.02, 1.5, 90.0):
        h.labels(op="get").observe(v)
    r = reg.histogram("demo_ratio", "a ratio", buckets=mod.RATIO_BUCKETS)
    before = reg.snapshot()
    for v in (0.0, 0.25, 0.5, 1.0):
        r.observe(v)
    c.labels(route="a").inc(2)
    after = reg.snapshot()
    before.pop("ts"), after.pop("ts")
    return (reg.expose_text(), after,
            mod.snapshot_delta(before, after), mod.log_buckets(1e-3, 10, 2))


def test_exposition_text_matches_reference():
    assert _registry_ops(tmetrics) == _registry_ops(jmetrics)


def test_record_device_memory_without_cuda(monkeypatch):
    """No CUDA device: nothing is recorded, as the reference records
    nothing where its backend has no stats."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = tobs.MetricRegistry(enabled=True)
    tobs.record_device_memory(reg)
    assert reg.expose_text().strip() == ""


def test_record_device_memory_reads_the_caching_allocator(monkeypatch):
    """One child a CUDA device for each of the three gauges, read from
    the caching allocator (stubbed here with two devices; the card's
    own readings are checked by ``chip_smoke.py``'s spec phase), and a
    failing probe records what it has and never raises."""
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cuda, "memory_allocated", lambda i: 100 * (i + 1))
    monkeypatch.setattr(cuda, "max_memory_allocated",
                        lambda i: 300 * (i + 1))
    monkeypatch.setattr(cuda, "memory_stats", lambda i: {
        "reserved_bytes.all.current": 1024 * (i + 1)})
    reg = tobs.MetricRegistry(enabled=True)
    tobs.record_device_memory(reg)
    got = {ln.split(" ")[0]: float(ln.split(" ")[1])
           for ln in reg.expose_text().splitlines()
           if ln and not ln.startswith("#")}
    assert got == {
        'device_memory_bytes_in_use{device="0"}': 100.0,
        'device_memory_bytes_in_use{device="1"}': 200.0,
        'device_memory_bytes_peak{device="0"}': 300.0,
        'device_memory_bytes_peak{device="1"}': 600.0,
        'device_memory_bytes_reserved{device="0"}': 1024.0,
        'device_memory_bytes_reserved{device="1"}': 2048.0}

    def broken(i):
        raise RuntimeError("no stats")
    monkeypatch.setattr(cuda, "memory_stats", broken)
    reg = tobs.MetricRegistry(enabled=True)
    tobs.record_device_memory(reg)            # does not raise
    assert "device_memory_bytes_in_use" in reg.expose_text()
    assert "device_memory_bytes_reserved" not in reg.expose_text()
    off = tobs.MetricRegistry(enabled=False)
    tobs.record_device_memory(off)
    assert off.expose_text().strip() == ""


# ----------------------------------------------------------------- faults

def _fault_hits(mod, spec, name, n=60):
    fired = []
    with mod.injected(spec):
        for i in range(n):
            try:
                mod.point(name)
            except mod.InjectedFault:
                fired.append(i)
        hits = mod.hits(name)
    return fired, hits


@pytest.mark.parametrize("spec", ["port.drill=prob@0.3,seed=7",
                                  "port.drill=fail@4"])
def test_seeded_fault_schedule_matches_reference(spec):
    got = _fault_hits(tfaults, spec, "port.drill")
    assert got == _fault_hits(jfaults, spec, "port.drill")
    assert got[0] and got[1] == 60
    assert tfaults.armed("port.drill") is None     # disarmed on exit


# ---------------------------------------------------------------- tracing

def _traced(mod, run):
    """The spans ``run()`` emits under ``mod``'s tracing: (name, lane)
    pairs in emission order, each lane (a request id or a thread)
    renumbered by first appearance, and each span's parent by interval
    containment on its lane."""
    spans = []
    mod.set_span_sink(lambda name, t0, t1, tid, attrs:
                      spans.append((name, t0, t1, tid)))
    mod.enable_tracing()
    try:
        run()
    finally:
        mod.disable_tracing()
        mod.set_span_sink(None)
    # the reference's program observatory adds a span per jit build; the
    # port has no jit builds (programs.py waits for the CUDA-graph
    # capture)
    spans = [sp for sp in spans if not sp[0].startswith("compile:")]
    lanes = {}
    out = []
    for name, t0, t1, tid in spans:
        lane = lanes.setdefault(tid, len(lanes))
        parent = [n for n, a, b, t in spans
                  if t == tid and (a, b) != (t0, t1) and a <= t0
                  and t1 <= b and n != name]
        out.append((name, lane, sorted(set(parent))))
    return out


def _nested(mod):
    with mod.span("outer", step=1):
        with mod.span("inner"):
            pass
        sp = mod.start_span("explicit", _tid=7)
        mod.end_span(sp, done=True)
    t = mod.time.perf_counter_ns()
    mod.add_span("retro", t, t + 1000, _tid=7)


def test_span_names_and_nesting_match_reference():
    got = _traced(ttracing, lambda: _nested(ttracing))
    assert got == _traced(jtracing, lambda: _nested(jtracing))
    assert [g[0] for g in got] == ["inner", "explicit", "outer", "retro"]
    assert got[0][2] == ["outer"]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_engine_spans_and_counters_match_reference(models, mode):
    """The same workload through the JAX engine and the port's (spec on):
    the same span sequence (request lifecycles, prefill chunks, decode
    windows, verify shares, ticks), the same counter and gauge series,
    and the same tick-histogram counts; the flight recorder holds the
    port engine's spec tick events."""
    jm, tm = models

    def run(engine_cls, model, **kw):
        eng = engine_cls(model, cache_mode=mode, **_ENGINE, **kw)
        reqs = [eng.submit(p, 10) for p in _prompts()]
        eng.run_until_idle()
        return eng, [r.result() for r in reqs]

    box = {}
    jspans = _traced(jtracing, lambda: box.setdefault(
        "j", run(JEngine, jm, auto_run=False)))
    tspans = _traced(ttracing, lambda: box.setdefault("t", run(
        ServingEngine, tm, auto_run=False)))
    (je, jout), (te, tout) = box["j"], box["t"]
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)
    assert tspans == jspans
    names = {s[0] for s in tspans}
    assert {"serving.request", "serving.request.queued",
            "serving.prefill_chunk", "serving.spec_verify",
            "serving.tick.prefill", "serving.tick.spec"} <= names

    def series(reg, eng):
        text = reg.expose_text(label_filter={"engine": eng.engine_id})
        text = text.replace(f'engine="{eng.engine_id}"', 'engine="E"')
        # the serving series (the idle-tick pool compaction's among
        # them) but the wall-time buckets and sums; the reference's
        # jit-build series are left out
        return [ln for ln in text.splitlines()
                if "serving_" in ln
                and not re.search(r"serving_(ttft|tpot|e2e|tick)_seconds_"
                                  r"(bucket|sum)", ln)]
    assert series(tobs.get_registry(), te) == \
        series(jmetrics.get_registry(), je)
    assert te.stats["spec_ticks"] > 0
    assert {k: te.stats[k] for k in je.stats} == dict(je.stats)
    ticks = [e for e in tobs.get_flight_recorder().dump()["events"]
             if e.get("kind") == "tick" and e.get("engine") == te.engine_id]
    assert {e["flavor"] for e in ticks} >= {"prefill", "spec"}
    assert len(ticks) == te.stats["ticks"]


# ------------------------------------------------------------- sanitizers

def test_lock_order_checker_raises_on_cycle():
    tsan.reset_lock_graph()
    with tsan.lock_sanitizer():
        a, b = tsan.make_lock("port.a"), tsan.make_lock("port.b")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(tsan.LockOrderError, match="port.a"):
            with a:
                pass
    tsan.reset_lock_graph()


def test_forbid_host_transfers_guards_implicit_fetches():
    t = torch.arange(6, dtype=torch.float32)
    implicit = [lambda: t[1].item(), lambda: t.tolist(),
                lambda: np.asarray(t), lambda: bool(t[1]),
                lambda: float(t[1]), lambda: int(t[1]),
                lambda: [0, 1, 2][t[1].long()]]
    with tobs.forbid_host_transfers():
        for fn in implicit:
            with pytest.raises(tobs.HostTransferError):
                fn()
        with tobs.forbid_host_transfers():      # nests
            got = tobs.device_get({"t": t, "pair": (t[:2], 3)})
        with pytest.raises(tobs.HostTransferError):
            t[0].item()                         # still guarded
    np.testing.assert_array_equal(got["t"], np.arange(6))
    assert got["pair"][1] == 3
    for fn in implicit:                         # restored on exit
        fn()


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_steady_state_tick_passes_under_the_guard(models, mode):
    """Once every slot decodes, the engine's ticks (verify and multi
    window) run under ``forbid_host_transfers()``: their one fetch is
    ``device_get``.  A planted ``.item()`` inside the same block is the
    control, and the guarded run stays token-exact."""
    _, tm = models
    eng = ServingEngine(tm, auto_run=False, cache_mode=mode, **_ENGINE)
    reqs = [eng.submit(p, 24) for p in _prompts()]
    while any(s.req is not None and s.off < len(s.seq)
              for s in eng._slots) or eng._pending:
        eng.step()
    spec0 = eng.stats["spec_ticks"]
    with tobs.forbid_host_transfers():
        for _ in range(3):
            assert eng.step()
        with pytest.raises(tobs.HostTransferError):
            eng._caches[0][0].sum().item()
    assert eng.stats["spec_ticks"] > spec0
    eng.run_until_idle()
    ref = ServingEngine(tm, auto_run=False, cache_mode=mode, **_ENGINE)
    for r, p in zip(reqs, _prompts()):
        np.testing.assert_array_equal(r.result(), ref.generate(p, 24))


# ---------------------------------------------------------- race sanitizer

class _Box:
    def __init__(self):
        self.val = 0
        self.flag = False


def _in_thread(fn, name="worker"):
    """Run ``fn`` on a thread of its own; its exception, or None."""
    errs = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001
            errs.append(e)
    th = threading.Thread(target=run, name=name)
    th.start()
    th.join(5)
    return errs[0] if errs else None


def _race_outcome(S, scenario):
    """One access pattern over an object shared under ``S``'s race
    sanitizer: the class of what it raised (or None) and the shared
    attributes its report names."""
    with S.race_sanitizer():
        box = S.share_object(_Box(), "unit.box", atomic=("val",)
                             if scenario == "atomic" else ())
        guard = S.make_lock("unit.guard")
        err = None
        if scenario == "write_write":
            def locked():
                with guard:
                    box.flag = True
            for _ in range(2):
                assert _in_thread(locked) is None
            err = _in_thread(lambda: setattr(box, "flag", False))
        elif scenario == "read_write":
            def read():
                with guard:
                    _ = box.flag
            for _ in range(2):
                assert _in_thread(read) is None
            try:
                box.flag = True
            except BaseException as e:  # noqa: BLE001
                err = e
        elif scenario == "common_lock":
            def bump():
                for _ in range(10):
                    with guard:
                        box.val += 1
            errs = [_in_thread(bump) for _ in range(3)]
            err = next((e for e in errs if e is not None), None)
        elif scenario == "handoff":
            box.val = 1

            def drive():
                for i in range(5):
                    box.val = i
                    _ = box.val
            err = _in_thread(drive)
        elif scenario == "atomic":
            def bump_val():
                box.val += 1
            for _ in range(3):
                assert _in_thread(bump_val) is None
            for _ in range(2):
                assert _in_thread(lambda: setattr(box, "flag", True)) is None
            try:
                box.flag = False
            except BaseException as e:  # noqa: BLE001
                err = e
    plain = S.share_object(_Box(), "unit.off")
    named = sorted(set(re.findall(r"unit\.box\.\w+", str(err or ""))))
    return (type(err).__name__ if err else None, named,
            type(plain) is _Box, S.race_sanitizer_enabled())


@pytest.mark.parametrize("scenario", ["write_write", "read_write",
                                      "common_lock", "handoff", "atomic"])
def test_race_sanitizer_matches_reference(scenario):
    """The same access pattern under the port's race sanitizer and the
    reference's: the same verdict, naming the same attribute, and the
    sanitizer off again (share_object returns the plain object) after
    the block."""
    got = _race_outcome(tsan, scenario)
    assert got == _race_outcome(jsan, scenario)
    raced = scenario in ("write_write", "read_write", "atomic")
    assert got[0] == ("DataRaceError" if raced else None)
    assert got[1] == (["unit.box.flag"] if raced else [])
    assert got[2:] == (True, False)


# --------------------------------------------------------- flight recorder

def _crash(mod, flight_dir, monkeypatch):
    """A crash dump of ``mod``'s recorder after one tagged event, read
    back: the dump's envelope keys and its last two events without
    their timestamps."""
    monkeypatch.setenv("PHT_FLIGHT_DIR", str(flight_dir))
    mod.get_flight_recorder().record("unit", step=3, note="before")
    with pytest.warns(UserWarning, match="flight-recorder dump"):
        path = mod.crash_dump("unit.origin", ValueError("boom"))
    assert os.path.dirname(path) == str(flight_dir)
    with open(path) as f:
        dump = json.load(f)
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in dump["events"][-2:]]
    return sorted(dump), events, dump["capacity"]


def test_crash_dump_matches_reference(tmp_path, monkeypatch):
    """``crash_dump`` writes the ring under ``PHT_FLIGHT_DIR`` with the
    crash event last, as the reference's does."""
    got = _crash(tflight, tmp_path / "port", monkeypatch)
    assert got == _crash(jflight, tmp_path / "ref", monkeypatch)
    assert got[1] == [{"step": 3, "note": "before", "kind": "unit"},
                      {"origin": "unit.origin", "error": "ValueError",
                       "message": "boom", "kind": "crash"}]


def test_engine_step_failure_writes_a_crash_dump(models, tmp_path,
                                                 monkeypatch):
    """A fault injected at the port engine's ``serving.step`` point
    escapes ``step`` and leaves a crash dump naming the engine."""
    _, tm = models
    monkeypatch.setenv("PHT_FLIGHT_DIR", str(tmp_path))
    eng = ServingEngine(tm, auto_run=False, cache_mode="dense", **_ENGINE)
    eng.submit(_prompts()[0], 4)
    with tfaults.injected("serving.step=fail@1"):
        with pytest.warns(UserWarning, match="flight-recorder dump"):
            with pytest.raises(tfaults.InjectedFault):
                eng.step()
    (path,) = list(tmp_path.iterdir())
    with open(path) as f:
        last = json.load(f)["events"][-1]
    assert last["kind"] == "crash"
    assert last["origin"] == f"serving.step[{eng.engine_id}]"
    eng.run_until_idle()                       # the engine goes on


# ---------------------------------------------------- introspection server

def _get(port, path):
    """GET ``path`` from the server on localhost (http.client: no proxy
    is consulted); the status and the decoded body."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
    finally:
        conn.close()
    ctype = resp.getheader("Content-Type")
    return resp.status, ctype, (json.loads(body) if "json" in ctype
                                else body)


def _scrape(metrics_mod, flight_mod, tracing_mod, server_mod):
    """One server over a registry filled by :func:`_registry_ops`'s
    sequence, one tagged flight event and one stale beacon; every
    endpoint's status, content type and body, timestamps and uptime
    dropped, the flight dump cut to its last event, the beacons to the
    stale one."""
    reg = metrics_mod.MetricRegistry(enabled=True)
    reg.counter("demo_requests_total", "requests seen").labels(
        route="a").inc(2)
    reg.gauge("demo_depth", "queue depth", unit="items").set(5)
    h = reg.histogram("demo_latency_seconds", "latency", unit="s")
    for v in (3e-4, 0.02, 1.5):
        h.observe(v)
    flight_mod.get_flight_recorder().record("unit", probe="server")
    tracing_mod._beacons["unit.stale"] = (time.time() - 60.0, None)
    srv = server_mod.start_introspection_server(0, registry=reg)
    out = {}
    try:
        for path in ("/metrics", "/healthz", "/healthz?max_age=30",
                     "/healthz?max_age=", "/healthz?max_age=nan",
                     "/load", "/fleet", "/debug/flight", "/nope"):
            code, ctype, body = _get(srv.port, path)
            if isinstance(body, dict):
                body = {k: v for k, v in body.items()
                        if k not in ("ts", "uptime_s", "perf_ns", "pid")}
                for k in ("beacons", "stale"):
                    if k in body:
                        body[k] = sorted(b for b in body[k]
                                         if b == "unit.stale")
                if "stale_beacons" in body:
                    body["stale_beacons"] = [
                        b for b in body["stale_beacons"] if b == "unit.stale"]
                for k in ("engines", "fleets"):
                    if k in body:
                        # the live engines (both packages') and the
                        # reference's routers register reports here
                        out[f"{path} {k}"] = body.pop(k)
                if "events" in body:
                    body["events"] = [{k: v for k, v in e.items()
                                       if k != "ts"}
                                      for e in body["events"][-1:]]
                    body.pop("dropped", None)
            out[path] = (code, ctype, body)
    finally:
        srv.stop()
        tracing_mod.remove_beacon("unit.stale")
    return out


def test_introspection_server_matches_reference():
    """The port's server and the reference's, each over the same
    registry contents, flight event and stale beacon, answer every
    endpoint alike; the one difference is ``/debug/programs``, which
    the port leaves for the CUDA-graph capture."""
    from paddle_hackathon_tpu.observability import server as jserver
    from paddle_hackathon_tpu_torch.observability import server as tserver
    got = _scrape(tmetrics, tflight, ttracing, tserver)
    ref = _scrape(jmetrics, jflight, jtracing, jserver)
    code, ctype, body = ref.pop("/nope")
    body["endpoints"].remove("/debug/programs")
    assert got.pop("/nope") == (code, ctype, body) and code == 404
    assert isinstance(got.pop("/load engines"), dict)
    assert got.pop("/fleet fleets") == {}
    assert isinstance(ref.pop("/load engines"), dict)
    assert isinstance(ref.pop("/fleet fleets"), dict)
    assert got == ref
    assert got["/metrics"][0] == 200
    assert 'demo_requests_total{route="a"} 2' in got["/metrics"][2]
    assert got["/healthz"][:2] == (200, "application/json; charset=utf-8")
    assert got["/healthz?max_age=30"][0] == 503
    assert got["/healthz?max_age=30"][2]["stale_beacons"] == ["unit.stale"]
    assert got["/healthz?max_age="][0] == 400
    assert got["/healthz?max_age=nan"][0] == 400
    assert got["/debug/flight"][2]["events"] == [
        {"probe": "server", "kind": "unit"}]
    assert got["/load"][:2] == (200, "application/json; charset=utf-8")
    assert got["/load"][2] == got["/fleet"][2] == {"version": 1}
