"""The port's fleet observability (``paddle_hackathon_tpu_torch``:
``inference/fleet.py``'s reports, ``profiler/cross_stack.py``) against
the JAX package's, on host-only fake replicas.

The cases of ``tests/test_fleet_observability.py`` over the port
(trace-context propagation across a failover, metric federation,
``/fleet`` and ``/healthz`` over the port's introspection server, hop
forensics, the watchdog rules, the federation hammer under the lock
sanitizer, trace stitching), then the port's ``load_report``,
``health_report``, ``introspect_requests`` and ``expose_text`` key for
key against a JAX ``FleetRouter`` driven through the same fakes, and
``merge_traces(stitch_fleet=True)`` equal to the JAX package's on the same
trace files.
"""

import itertools
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from paddle_hackathon_tpu.inference import fleet as jfleet
from paddle_hackathon_tpu.observability import tracing as jtracing
from paddle_hackathon_tpu.profiler import cross_stack as jcross
from paddle_hackathon_tpu_torch.inference.fleet import FleetRouter
from paddle_hackathon_tpu_torch.observability import (flight, get_registry,
                                                      sanitizers, tracing)
from paddle_hackathon_tpu_torch.observability.metrics import (
    MetricRegistry, SlidingWindowHistogram, federate_text,
    merged_percentiles)
from paddle_hackathon_tpu_torch.profiler import merge_traces


# ---------------------------------------------------------------------------
# fakes (host-only replica handles speaking the engine surface)
# ---------------------------------------------------------------------------

_RIDS = itertools.count()


class _FakeReq:
    def __init__(self, prompt, max_new, on_token=None):
        self.rid = next(_RIDS)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.tokens = []
        self.done = False
        self.error = None
        self._event = threading.Event()
        self.on_token = on_token


class _FakeEngine:
    """Records every ``trace_ctx`` it is handed; ``die_first`` fails the
    first submitted request AFTER placement (zero tokens streamed) —
    the router-side failover path, not a submit error."""

    def __init__(self, name, headroom=1000, die_first=False, version=1,
                 slo=None, goodput=None, preemptions=0, queue_depth=0):
        self.engine_id = name
        self.headroom = headroom
        self.die_first = die_first
        self.version = version
        self.slo = slo
        self.goodput = goodput
        self.preemptions = preemptions
        self.queue_depth = queue_depth
        self.trace_ctxs = []
        self.submitted = 0
        self.probe_error = None

    def load_report(self):
        if self.probe_error is not None:
            raise self.probe_error
        rep = {"version": self.version, "engine": self.engine_id,
               "draining": False,
               "slots": {"max": 8, "active": 0, "free": 8},
               "queue": {"depth": self.queue_depth, "oldest_wait_s": 0.0},
               "admission": {"headroom_tokens": self.headroom}}
        if self.slo is not None:
            rep["slo"] = self.slo
        if self.goodput is not None:
            rep["goodput"] = {"ratio": self.goodput}
            rep["scheduler"] = {"preemptions": self.preemptions}
        return rep

    def submit(self, prompt, max_new_tokens, deadline_s=None,
               on_token=None, trace_ctx=None, **kw):
        self.trace_ctxs.append(trace_ctx)
        self.submitted += 1
        req = _FakeReq(prompt, max_new_tokens, on_token)
        if self.die_first and self.submitted == 1:
            req.error = RuntimeError("boom")
        else:
            req.tokens = list(range(max_new_tokens))
            req.done = True
        req._event.set()
        return req

    def drain(self, timeout=None):
        pass

    def shutdown(self, timeout=None):
        pass


# ---------------------------------------------------------------------------
# trace-context propagation
# ---------------------------------------------------------------------------

def test_trace_context_rides_to_replica_and_survives_failover():
    a = _FakeEngine("ta", headroom=9000, die_first=True)
    b = _FakeEngine("tb", headroom=10)
    r = FleetRouter([a, b], backoff_s=0.001)
    fr = r.submit([1, 2, 3], 4)
    assert fr.wait(10) and fr.error is None
    assert fr.replica == "tb" and fr.retries == 1
    # the context is a plain dict (the future HTTP-header contract):
    # same fleet rid on both attempts, attempt ordinal bumped
    (ctx_a,), (ctx_b,) = a.trace_ctxs, b.trace_ctxs
    assert ctx_a == {"fleet": r.fleet_id, "fleet_rid": fr.fleet_rid,
                     "attempt": 1}
    assert ctx_b == {"fleet": r.fleet_id, "fleet_rid": fr.fleet_rid,
                     "attempt": 2}
    json.dumps(ctx_b)                     # header-safe: JSON round-trips
    r.shutdown()


def test_fleet_rids_survive_router_scoped_not_request_scoped():
    a = _FakeEngine("ua")
    r = FleetRouter([a], backoff_s=0.001)
    r1, r2 = r.submit([1], 2), r.submit([2], 2)
    assert r2.fleet_rid > r1.fleet_rid    # monotonic across requests
    r.shutdown()


# ---------------------------------------------------------------------------
# merged quantiles
# ---------------------------------------------------------------------------

def test_merged_quantiles_never_exceed_either_observed_max():
    clock = [100.0]
    mk = lambda: SlidingWindowHistogram(  # noqa: E731
        window_s=60, slices=6, clock=lambda: clock[0])
    wa, wb = mk(), mk()
    for v in (0.010, 0.020, 0.040):
        wa.observe(v)
    for v in (0.001, 0.002, 0.350):
        wb.observe(v)
    out = merged_percentiles([wa, wb], qs=(0.5, 0.99))
    assert out["count"] == 6
    vmax = max(wa.max, wb.max)
    assert out["max"] == vmax == 0.350
    # the pin: bucket interpolation clamps to the OBSERVED max — a
    # merged p99 above every real sample would be an invented latency
    assert out["p99"] <= vmax
    assert out["p50"] <= vmax
    assert merged_percentiles([]) is None
    assert merged_percentiles([mk(), None]) is None    # empty windows
    with pytest.raises(ValueError):
        merged_percentiles([wa, SlidingWindowHistogram(
            buckets=(1.0, 2.0), clock=lambda: clock[0])])


# ---------------------------------------------------------------------------
# federation text plumbing
# ---------------------------------------------------------------------------

def test_federate_text_injects_label_and_dedups_meta():
    parts = {
        "a": ("# HELP n_total things\n# TYPE n_total counter\n"
              "n_total 3\nn_total{engine=\"e1\"} 2\n"),
        "b": ("# HELP n_total things\n# TYPE n_total counter\n"
              "n_total 5\n"),
    }
    text = federate_text(parts)
    lines = text.splitlines()
    assert lines.count("# HELP n_total things") == 1      # meta dedup
    assert lines.count("# TYPE n_total counter") == 1
    assert 'n_total{replica="a"} 3' in lines
    # replica label injected FIRST, existing labels preserved
    assert 'n_total{replica="a",engine="e1"} 2' in lines
    assert 'n_total{replica="b"} 5' in lines


def test_federate_text_escapes_label_values():
    text = federate_text({'we"ird\\x': "n_total 1\n"})
    assert 'n_total{replica="we\\"ird\\\\x"} 1' in text


def test_expose_text_label_filter_slices_by_subset():
    r = MetricRegistry()
    r.counter("n_total").labels(engine="e1").inc(1)
    r.counter("n_total").labels(engine="e2").inc(2)
    r.gauge("other").set(7)
    text = r.expose_text(label_filter={"engine": "e1"})
    assert 'n_total{engine="e1"} 1' in text
    assert "e2" not in text
    # families with no surviving series are omitted entirely under a
    # filter (no orphan HELP/TYPE), but stay in the unfiltered view
    assert "other" not in text
    assert "other 7" in r.expose_text()


# ---------------------------------------------------------------------------
# fleet /load federation: versions, staleness
# ---------------------------------------------------------------------------

def test_load_report_staleness_and_version_gate():
    a = _FakeEngine("sa")
    r = FleetRouter([a], backoff_s=0.001)
    rep1 = r.load_report()
    e = rep1["replicas"]["sa"]
    assert e["age_s"] == 0.0 and e["version_ok"] and "stale" not in e
    # replica starts answering with an unknown schema: the cached good
    # report is served WITH its age, never silently-fresh numbers
    a.version = 9
    time.sleep(0.01)
    with pytest.warns(RuntimeWarning, match="version 9"):
        rep2 = r.load_report()
    e = rep2["replicas"]["sa"]
    assert e["version_ok"] is False and e["stale"] is True
    assert e["age_s"] > 0.0
    assert e["report"]["version"] == 1        # the cached GOOD report
    assert get_registry().total("fleet_load_version_mismatch_total",
                                fleet=r.fleet_id, replica="sa") == 1
    json.dumps(rep2)                          # /fleet body serializes
    r.shutdown()


def test_load_report_probe_error_serves_cache_with_age():
    a = _FakeEngine("pa")
    r = FleetRouter([a], backoff_s=0.001)
    r.load_report()                           # prime the cache
    a.probe_error = RuntimeError("probe down")
    rep = r.load_report()
    e = rep["replicas"]["pa"]
    assert "RuntimeError" in e["probe_error"]
    assert e["stale"] is True and e["age_s"] >= 0.0
    r.shutdown()


# ---------------------------------------------------------------------------
# /fleet + /healthz over HTTP
# ---------------------------------------------------------------------------

def test_fleet_endpoint_and_healthz_fleet_block():
    from paddle_hackathon_tpu_torch.observability.server import (
        start_introspection_server)
    a = _FakeEngine("ha")
    r = FleetRouter([a], backoff_s=0.001)
    srv = start_introspection_server(0)
    try:
        doc = json.load(urllib.request.urlopen(f"{srv.url}/fleet"))
        assert doc["version"] == 1
        fleet = doc["fleets"][r.fleet_id]
        assert fleet["kind"] == "fleet"
        assert "ha" in fleet["replicas"]
        hz = json.load(urllib.request.urlopen(f"{srv.url}/healthz"))
        blk = hz["fleets"][r.fleet_id]
        assert blk["ok"] is True and blk["replicas"][0]["replica"] == "ha"
    finally:
        srv.stop()
        r.shutdown()
    # after shutdown the router unregisters: no ghost fleet entries
    assert r.fleet_id not in tracing.fleet_reports()


def test_health_report_sorts_stalest_replica_first():
    a, b = _FakeEngine("hb-a"), _FakeEngine("hb-b")
    r = FleetRouter([a, b], backoff_s=0.001, health_max_age_s=5.0)
    now = time.time()
    tracing._beacons["serving.hb-a"] = (now - 2.0, None)   # pinned
    tracing._beacons["serving.hb-b"] = (now - 60.0, None)
    try:
        rep = r.health_report()
        assert [row["replica"] for row in rep["replicas"]] == [
            "hb-b", "hb-a"]                    # stalest first
        assert rep["stale_replicas"] == ["hb-b"]
        assert rep["ok"] is False
    finally:
        tracing.remove_beacon("serving.hb-a")
        tracing.remove_beacon("serving.hb-b")
        r.shutdown()


# ---------------------------------------------------------------------------
# per-hop forensics
# ---------------------------------------------------------------------------

def test_hop_forensics_records_why_and_failover_cause():
    a = _FakeEngine("fa", headroom=9000, die_first=True)
    b = _FakeEngine("fb", headroom=10)
    r = FleetRouter([a, b], backoff_s=0.001)
    fr = r.submit([1, 2, 3], 4)
    assert fr.wait(10) and fr.error is None
    rows = r.introspect_requests()["requests"]
    row = rows[str(fr.fleet_rid)]
    assert row["replica"] == "fb" and row["retries"] == 1
    assert row["done"] is True and row["error"] is None
    hops = row["hops"]
    # placed on fa (why recorded), fa died (cause recorded), re-placed
    assert hops[0]["replica"] == "fa" and hops[0]["outcome"] == "ok"
    assert hops[0]["why"] in ("headroom", "affinity")
    failover = [h for h in hops if h["outcome"] == "failover"]
    assert failover and "RuntimeError: boom" in failover[0]["cause"]
    assert hops[-1]["replica"] == "fb" and hops[-1]["outcome"] == "ok"
    json.dumps(rows)                          # /debug/requests body
    r.shutdown()


def test_forensics_rows_vanish_with_dropped_handles():
    a = _FakeEngine("ga")
    r = FleetRouter([a], backoff_s=0.001)
    fr = r.submit([1], 2)
    frid = str(fr.fleet_rid)
    assert frid in r.introspect_requests()["requests"]
    del fr                                    # weak registry
    import gc
    gc.collect()
    assert frid not in r.introspect_requests()["requests"]
    r.shutdown()


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_ttft_breach_fires_then_clears_with_flight_events():
    slo_bad = {"classes": {"interactive": {"ttft": {"p99": 9.5}}}}
    a = _FakeEngine("wa", slo=slo_bad)
    r = FleetRouter([a], backoff_s=0.001, watchdog_ttft_p99_s=2.0)
    rec = flight.get_flight_recorder()
    active = r.load_report()["watchdog"]
    assert [d["rule"] for d in active] == ["ttft_p99[wa]"]
    assert "9.500s breaches 2.0s" in active[0]["reason"]
    # named degradation surfaces in the health body too
    assert r.health_report()["ok"] is False
    a.slo = {"classes": {"interactive": {"ttft": {"p99": 0.1}}}}
    assert r.load_report()["watchdog"] == []
    assert r.health_report()["ok"] is True
    wd = [e for e in rec.dump()["events"]
          if e.get("phase") == "watchdog"
          and e.get("rule") == "ttft_p99[wa]"]
    assert [e["state"] for e in wd[-2:]] == ["fired", "cleared"]
    r.shutdown()


def test_watchdog_goodput_crater_requires_fresh_preemption():
    a = _FakeEngine("wg", goodput=0.2, preemptions=0)
    r = FleetRouter([a], backoff_s=0.001, watchdog_goodput_ratio=0.5)
    # low goodput alone (an idle engine) is NOT the crater signal
    assert r.load_report()["watchdog"] == []
    a.preemptions = 3                         # goodput low AND preempted
    active = r.load_report()["watchdog"]
    assert [d["rule"] for d in active] == ["goodput[wg]"]
    assert "0 -> 3" in active[0]["reason"]
    r.shutdown()


def test_watchdog_replica_skew_rule():
    a = _FakeEngine("ska", queue_depth=0)
    b = _FakeEngine("skb", queue_depth=200)
    r = FleetRouter([a, b], backoff_s=0.001, watchdog_skew=64)
    rep = r.load_report()
    assert rep["replica_skew"] == 200
    assert [d["rule"] for d in rep["watchdog"]] == ["replica_skew"]
    assert get_registry().total("fleet_replica_skew",
                                fleet=r.fleet_id) == 200
    b.queue_depth = 10
    assert r.load_report()["watchdog"] == []
    r.shutdown()


# ---------------------------------------------------------------------------
# federation hammer (torn-JSON check) under the lock sanitizer
# ---------------------------------------------------------------------------

def test_concurrent_federation_hammer_no_torn_output():
    a = _FakeEngine("cfa", headroom=9000)
    b = _FakeEngine("cfb", headroom=100)
    with sanitizers.lock_sanitizer():
        r = FleetRouter([a, b], backoff_s=0.001)
        stop = threading.Event()
        errs = []

        def writer():
            try:
                while not stop.is_set():
                    fr = r.submit([1, 2, 3], 2)
                    assert fr.wait(5)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        def reader():
            try:
                while not stop.is_set():
                    json.loads(json.dumps(r.load_report()))
                    json.loads(json.dumps(r.introspect_requests()))
                    json.loads(json.dumps(r.health_report()))
                    for ln in r.expose_text().splitlines():
                        assert ln.startswith("#") or " " in ln, ln
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=writer) for _ in range(2)] + [
            threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.6)
        stop.set()
        for t in threads:
            t.join(10)
        r.shutdown()
    assert not errs, errs


# ---------------------------------------------------------------------------
# chrome-trace stitching
# ---------------------------------------------------------------------------

def test_stitch_fleet_rehomes_router_and_replica_spans(tmp_path):
    events = [
        # router spans carry fleet_rid directly
        {"name": "fleet.route", "ph": "X", "pid": 0, "tid": 901,
         "ts": 0, "dur": 50, "args": {"fleet": "f0", "fleet_rid": 7}},
        {"name": "fleet.dispatch", "ph": "X", "pid": 0, "tid": 901,
         "ts": 1, "dur": 5, "args": {"fleet_rid": 7, "attempt": 1}},
        # replica lifecycle span carries BOTH (the rid bridge)
        {"name": "serving.request", "ph": "X", "pid": 0, "tid": 31,
         "ts": 2, "dur": 40, "args": {"rid": 31, "fleet_rid": 7,
                                      "engine": "e1"}},
        # per-tick replica span carries rid ONLY -> mapped via bridge
        {"name": "serving.decode", "ph": "X", "pid": 0, "tid": 31,
         "ts": 3, "dur": 2, "args": {"rid": 31, "slot": 0}},
        # unrelated rid: stays on its original rank row
        {"name": "serving.decode", "ph": "X", "pid": 0, "tid": 99,
         "ts": 3, "dur": 2, "args": {"rid": 99, "slot": 1}},
        # engine tick span with no rid: serves many requests, untouched
        {"name": "serving.tick.decode", "ph": "X", "pid": 0, "tid": 1,
         "ts": 0, "dur": 9, "args": {"batch": 4}},
    ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    merged = merge_traces([str(p)], stitch_fleet=True)
    ev = merged["traceEvents"]
    meta = [e for e in ev if e.get("ph") == "M"
            and e.get("name") == "process_name"
            and "rid-stitched" in (e.get("args") or {}).get("name", "")]
    assert meta, "stitched fleet process missing"
    fpid = meta[0]["pid"]
    lane = [e["name"] for e in ev if e.get("ph") != "M"
            and e["pid"] == fpid and e["tid"] == 7]
    assert sorted(lane) == ["fleet.dispatch", "fleet.route",
                            "serving.decode", "serving.request"]
    untouched = [e for e in ev if e.get("ph") != "M" and e["pid"] != fpid]
    assert {e["name"] for e in untouched} == {"serving.decode",
                                              "serving.tick.decode"}
    lanes = [e for e in ev if e.get("ph") == "M"
             and e.get("name") == "thread_name" and e["pid"] == fpid]
    assert [m["args"]["name"] for m in lanes] == ["fleet_rid=7"]


def test_stitch_fleet_without_fleet_events_is_a_noop(tmp_path):
    events = [{"name": "train.step", "ph": "X", "pid": 0, "tid": 1,
               "ts": 0, "dur": 5, "args": {}}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    merged = merge_traces([str(p)], stitch_fleet=True)
    assert not any("rid-stitched" in (e.get("args") or {})
                   .get("name", "") for e in merged["traceEvents"]
                   if e.get("ph") == "M")


# ---------------------------------------------------------------------------
# key for key against the JAX package's router over the same fakes
# ---------------------------------------------------------------------------

def _shape(x, key=None):
    """A report with its run-dependent values reduced: router, fleet and
    replica ids, times and ages to their type; everything else as is."""
    if key in ("fleet", "ts", "since", "age_s", "beacon_age_s", "p50_s",
               "p99_s", "rid") or (key or "").endswith("_rid"):
        return type(x).__name__
    if key == "requests":       # keyed by fleet rid: in rid order
        return [_shape(v) for _, v in sorted(x.items(),
                                             key=lambda kv: int(kv[0]))]
    if isinstance(x, dict):
        return {k: _shape(v, k) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_shape(v) for v in x]
    return x


def _drive(router_cls, tag):
    """One router over three fakes: a failover, a watchdog rule, a stale
    probe served from the cache; returns its reports."""
    slo = {"classes": {"interactive": {"ttft": {"p99": 5.0}}}}
    a = _FakeEngine("a" + tag, headroom=9000, die_first=True, slo=slo)
    b = _FakeEngine("b" + tag, headroom=10, goodput=0.2, preemptions=0)
    c = _FakeEngine("c" + tag, headroom=5, queue_depth=100)
    r = router_cls([a, b, c], backoff_s=0.001, watchdog_skew=64)
    frs = [r.submit([1, 2, 3], 4) for _ in range(3)]
    for fr in frs:
        assert fr.wait(10) and fr.error is None
    r.load_report()
    b.preemptions = 2
    c.probe_error = RuntimeError("probe down")
    out = {"load": r.load_report(), "health": r.health_report(),
           "introspect": r.introspect_requests()}
    text = r.expose_text()
    out["series"] = sorted({ln.split("{")[0].split(" ")[0]
                            for ln in text.splitlines()
                            if ln and not ln.startswith("#")})
    out["labels"] = sorted({kv.split("=")[0] for ln in text.splitlines()
                            if "{" in ln and not ln.startswith("#")
                            for kv in ln.split("{")[1].split("}")[0]
                            .split(",")})
    r.shutdown()
    return out, frs


def _rename(x, tag):
    """The fake replicas' names with the run's tag taken out."""
    if isinstance(x, dict):
        return {_rename(k, tag): _rename(v, tag) for k, v in x.items()}
    if isinstance(x, list):
        return [_rename(v, tag) for v in x]
    if isinstance(x, str):
        return x.replace(tag, "")
    return x


def test_reports_key_for_key_against_jax_router():
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jout, jfrs = _drive(jfleet.FleetRouter, "_jx")
        tout, tfrs = _drive(FleetRouter, "_pt")
    jout, tout = _rename(jout, "_jx"), _rename(tout, "_pt")
    for key in ("load", "health", "introspect"):
        assert _shape(tout[key]) == _shape(jout[key]), key
    # the same dispatch decisions, hop for hop
    assert [f.replica.replace("_pt", "") for f in tfrs] == \
        [f.replica.replace("_jx", "") for f in jfrs]
    assert [f.retries for f in tfrs] == [f.retries for f in jfrs]
    assert tout["series"] == jout["series"]
    assert tout["labels"] == jout["labels"]
    assert [d["rule"] for d in tout["load"]["watchdog"]] == \
        [d["rule"] for d in jout["load"]["watchdog"]] != []


def _trace_files(tmp_path):
    ev0 = [
        {"name": "fleet.route", "ph": "X", "pid": 3, "tid": 901,
         "ts": 10, "dur": 50, "args": {"fleet": "f0", "fleet_rid": 7}},
        {"name": "serving.request", "ph": "X", "pid": 3, "tid": 31,
         "ts": 12, "dur": 40, "args": {"rid": 31, "fleet_rid": 7}},
        {"name": "serving.decode", "ph": "X", "pid": 3, "tid": 31,
         "ts": 13, "dur": 2, "args": {"rid": 31}},
        {"name": "step", "ph": "X", "pid": 3, "tid": 1, "ts": 5,
         "dur": 1, "args": {}},
        {"ph": "M", "name": "process_name", "pid": 3,
         "args": {"name": "x"}},
    ]
    ev1 = [
        {"name": "step", "ph": "X", "pid": 0, "tid": 1, "ts": 105,
         "dur": 1, "args": {}},
        {"name": "serving.request", "ph": "X", "pid": 0, "tid": 31,
         "ts": 112, "dur": 40, "args": {"rid": 31, "fleet_rid": 8}},
        {"name": "serving.decode", "ph": "C", "pid": 0, "tid": 31,
         "ts": 113, "args": {"rid": 31}},
    ]
    paths = []
    for name, ev in (("rank0_trace.json", ev0), ("worker1.json", ev1)):
        p = tmp_path / name
        p.write_text(json.dumps({"traceEvents": ev}))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("kw", [dict(stitch_fleet=True),
                                dict(stitch_fleet=True, align_marker="step"),
                                dict()])
def test_merge_traces_equals_jax(tmp_path, kw):
    paths = _trace_files(tmp_path)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jcross.merge_traces(paths, **kw)
        got = merge_traces(paths, out_path=str(tmp_path / "out.json"), **kw)
    assert got == want
    assert json.loads((tmp_path / "out.json").read_text()) == want
    # one trace file alone, as the issue's stitch case
    assert merge_traces(paths[:1], stitch_fleet=True) == \
        jcross.merge_traces(paths[:1], stitch_fleet=True)


def test_merge_traces_flight_overlay_equals_jax(tmp_path):
    paths = _trace_files(tmp_path)
    dump = {"ts": 1000.0, "perf_ns": 5_000_000_000,
            "events": [{"kind": "fleet", "ts": 1000.5, "phase": "drain"}]}
    fp = tmp_path / "flight.json"
    fp.write_text(json.dumps(dump))
    assert merge_traces(paths, flight_paths=[str(fp)]) == \
        jcross.merge_traces(paths, flight_paths=[str(fp)])
    with pytest.raises(ValueError):
        merge_traces(paths, align_marker="step", flight_paths=[str(fp)])
