"""The port's serving fleet (``paddle_hackathon_tpu_torch.inference.
fleet``) against the JAX package's, on the CPU.

Fast half (the cases of ``tests/test_fleet.py`` on host-only FAKE
replicas speaking the engine surface): ``pick_replica`` /
``affinity_depth`` / ``page_digests``, the ``CircuitBreaker`` state
machine with an injected clock, and ``FleetRouter`` retry and backoff,
draining, the stale-health and load-probe fault points, replica-death
recovery and streaming backpressure.  ``pick_replica`` and
``affinity_depth`` make the JAX package's choice on every report here.

Drills (two tiny paged port replicas, 2-layer GPTs at hidden 64 in f32,
each with its own model object on the JAX model's weights): failover
when ``serving.tick[<replica>]`` kills one replica mid-flight, a drain
under load, affinity against round-robin, and a drive under the lock and
race sanitizers; every completed request token-exact against the JAX
engine's greedy output, no page leaked.
"""

import itertools
import queue
import threading
import time

import numpy as np
import pytest

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.inference import fleet as jfleet
from paddle_hackathon_tpu.inference.serving import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.inference import ServingEngine
from paddle_hackathon_tpu_torch.inference.fleet import (
    BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN, CircuitBreaker,
    FleetRouter, NoReplicaAvailableError, StreamInterruptedError,
    affinity_depth, pick_replica)
from paddle_hackathon_tpu_torch.inference.paged import (PagePool,
                                                        PrefixCache,
                                                        page_digests)
from paddle_hackathon_tpu_torch.inference.serving import (
    DeadlineExceededError, EngineDraining)
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.observability import faults, get_registry
from paddle_hackathon_tpu_torch.utils import load_jax_state


# ---------------------------------------------------------------------------
# fakes (host-only replica handles speaking the engine surface)
# ---------------------------------------------------------------------------

_RIDS = itertools.count()


class _FakeReq:
    def __init__(self, prompt, max_new, on_token=None):
        self.rid = next(_RIDS)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.tokens = []
        self.done = False
        self.error = None
        self._event = threading.Event()
        self.on_token = on_token

    def finish(self):
        for t in range(self.max_new):
            self.tokens.append(t)
            if self.on_token is not None:
                self.on_token(t)
        self.done = True
        if self.on_token is not None:
            self.on_token(None)
        self._event.set()

    def die(self, err, streamed=0):
        self.tokens = list(range(streamed))
        self.error = err
        if self.on_token is not None:
            self.on_token(None)
        self._event.set()

    def result(self):
        if self.error is not None:
            raise RuntimeError("request failed") from self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


class _FakeEngine:
    """Host-only replica: a /load report knob per field, scripted
    submit outcomes, manual finish/die control."""

    def __init__(self, name, headroom=1000, queue_depth=0, active=0,
                 digests=None, page_size=8, submit_error=None,
                 auto_finish=True, version=1):
        self.engine_id = name
        self.headroom = headroom
        self.queue_depth = queue_depth
        self.active = active
        self.digests = digests
        self.page_size = page_size
        self.submit_error = submit_error
        self.auto_finish = auto_finish
        self.version = version
        self.draining = False
        self.submitted = []
        self.last_deadline_s = "unset"
        self.drained = False
        self.shut = False

    def load_report(self):
        rep = {"version": self.version, "engine": self.engine_id,
               "draining": self.draining,
               "slots": {"max": 8, "active": self.active,
                         "free": 8 - self.active},
               "queue": {"depth": self.queue_depth, "oldest_wait_s": 0.0},
               "admission": {"headroom_tokens": self.headroom}}
        if self.digests is not None:
            rep["prefix_digest"] = {"algo": "crc32-pages",
                                    "page_size": self.page_size,
                                    "digests": list(self.digests)}
        return rep

    def submit(self, prompt, max_new_tokens, deadline_s=None,
               on_token=None, **kw):
        self.last_deadline_s = deadline_s
        if self.submit_error is not None:
            raise self.submit_error
        req = _FakeReq(prompt, max_new_tokens, on_token)
        self.submitted.append(req)
        if self.auto_finish:
            req.finish()
        return req

    def drain(self, timeout=None):
        self.drained = True

    def shutdown(self, timeout=None):
        self.shut = True


def _total(name, **labels):
    return get_registry().total(name, **labels)


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

def test_page_digests_cap_and_determinism():
    p = np.arange(40, dtype=np.int32)
    d = page_digests(p, 8)
    assert len(d) == (40 - 1) // 8 == 4      # last token never cached
    assert d == page_digests(list(p), 8)     # list/array agree
    assert page_digests(p[:8], 8) == []      # one page -> 0 full pages
    assert page_digests(p[:9], 8) == d[:1]   # prefix chains are prefixes


def test_page_digests_match_prefix_cache_chains():
    """The router hashes prompts with page_digests; the engine publishes
    PrefixCache.digests() — the two chains must be bytes-identical or
    affinity silently never matches."""
    pool = PagePool(num_pages=16, page_size=4)
    cache = PrefixCache(pool)
    prompt = np.arange(100, 117, dtype=np.int32)   # 17 tokens, 4 full pages
    pages = pool.alloc(4)
    cache.insert(prompt, pages, 4)
    assert set(cache.digests()) == set(page_digests(prompt, 4))
    # a different prompt shares no chain entry
    other = np.arange(200, 217, dtype=np.int32)
    assert not set(cache.digests()) & set(page_digests(other, 4))
    # bounded: limit is honored, most-recent first
    assert len(cache.digests(limit=2)) == 2


def test_affinity_depth_matches_deepest():
    p = np.arange(40, dtype=np.int32)
    d = page_digests(p, 8)
    rep = {"prefix_digest": {"page_size": 8, "digests": d[:3]}}
    assert affinity_depth(rep, d) == 3
    assert affinity_depth(rep, page_digests(np.arange(1, 41), 8)) == 0
    assert affinity_depth({}, d) == 0
    assert affinity_depth({"prefix_digest": {"digests": []}}, d) == 0


# ---------------------------------------------------------------------------
# pick_replica scoring
# ---------------------------------------------------------------------------

def _rep(headroom=100, depth=0, active=0, version=1, draining=False,
         digests=None, page_size=8):
    rep = {"version": version, "draining": draining,
           "slots": {"max": 8, "active": active, "free": 8 - active},
           "queue": {"depth": depth, "oldest_wait_s": 0.0},
           "admission": {"headroom_tokens": headroom}}
    if digests is not None:
        rep["prefix_digest"] = {"page_size": page_size,
                                "digests": digests}
    return rep


class TestPickReplica:
    def test_most_headroom_wins_among_fits(self):
        reps = {"a": _rep(headroom=100), "b": _rep(headroom=500)}
        assert pick_replica(reps, 50) == "b"

    def test_only_fitting_replica_wins_regardless_of_order(self):
        reps = {"a": _rep(headroom=100), "b": _rep(headroom=500)}
        assert pick_replica(reps, 400) == "b"
        reps = {"a": _rep(headroom=500), "b": _rep(headroom=100)}
        assert pick_replica(reps, 400) == "a"

    def test_nobody_fits_queues_on_least_loaded(self):
        reps = {"a": _rep(headroom=0, depth=5),
                "b": _rep(headroom=0, depth=1)}
        assert pick_replica(reps, 100) == "b"

    def test_version_gate(self):
        reps = {"a": _rep(), "b": _rep(headroom=9999, version=2)}
        assert pick_replica(reps, 10) == "a"
        assert pick_replica({"b": _rep(version=2)}, 10) is None

    def test_draining_never_a_candidate(self):
        reps = {"a": _rep(), "b": _rep(headroom=9999, draining=True)}
        assert pick_replica(reps, 10) == "a"

    def test_exclude(self):
        reps = {"a": _rep(headroom=500), "b": _rep(headroom=100)}
        assert pick_replica(reps, 10, exclude={"a"}) == "b"
        assert pick_replica(reps, 10, exclude={"a", "b"}) is None

    def test_affinity_wins_among_fits(self):
        p = np.arange(40, dtype=np.int32)
        d = page_digests(p, 8)
        reps = {"cold": _rep(headroom=500, digests=[]),
                "warm": _rep(headroom=100, digests=d)}
        assert pick_replica(reps, 50, digests=d) == "warm"
        # ...but only among replicas that can actually ADMIT the
        # request: affinity must not queue a request on a full replica
        assert pick_replica(reps, 400, digests=d) == "cold"

    def test_deeper_affinity_beats_shallower(self):
        p = np.arange(40, dtype=np.int32)
        d = page_digests(p, 8)
        reps = {"deep": _rep(headroom=100, digests=d),
                "shallow": _rep(headroom=400, digests=d[:1])}
        assert pick_replica(reps, 50, digests=d) == "deep"

    def test_queue_depth_breaks_headroom_ties(self):
        reps = {"a": _rep(headroom=100, depth=3),
                "b": _rep(headroom=100, depth=0)}
        assert pick_replica(reps, 50) == "b"

    def test_garbage_reports_skipped(self):
        reps = {"a": _rep(), "err": {"error": "TimeoutError: ..."},
                "none": None}
        assert pick_replica(reps, 10) == "a"


# ---------------------------------------------------------------------------
# circuit breaker (injected clock — no sleeps)
# ---------------------------------------------------------------------------

def test_breaker_state_machine():
    b = CircuitBreaker(failure_threshold=2, probe_interval_s=1.0)
    assert b.state == BREAKER_CLOSED and b.allows(0.0)
    b.record_failure(0.0)
    assert b.state == BREAKER_CLOSED and b.allows(0.1)   # under threshold
    b.record_failure(0.1)
    assert b.state == BREAKER_OPEN and not b.allows(0.5)
    # cool-down elapsed: half-open, exactly one probe
    assert b.allows(1.2) and b.state == BREAKER_HALF_OPEN
    b.on_dispatch()
    assert not b.allows(1.3)
    # probe failed: re-open, cool-down restarts from the failure
    b.record_failure(1.4)
    assert b.state == BREAKER_OPEN and not b.allows(2.0)
    # probe succeeded the second time: closed, streak reset
    assert b.allows(2.5)
    b.on_dispatch()
    b.record_success()
    assert b.state == BREAKER_CLOSED and b.consecutive_failures == 0


# ---------------------------------------------------------------------------
# router against fakes
# ---------------------------------------------------------------------------

class TestRouterDispatch:
    def test_submit_lands_least_loaded_and_counts(self):
        a, b = _FakeEngine("fa", headroom=10), _FakeEngine("fb",
                                                           headroom=500)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([1, 2, 3], 4)
        assert fr.wait(5) and fr.error is None and fr.replica == "fb"
        assert list(fr.result()) == [1, 2, 3, 0, 1, 2, 3]
        assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                      replica="fb", outcome="ok") == 1

    def test_submit_failure_retries_on_another_replica(self):
        a = _FakeEngine("ra", headroom=9000,
                        submit_error=RuntimeError("boom"))
        b = _FakeEngine("rb", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        before = _total("fleet_retries_total", fleet=r.fleet_id)
        fr = r.submit([1], 4)
        assert fr.replica == "rb"          # broken favorite excluded
        assert _total("fleet_retries_total", fleet=r.fleet_id) == before + 1
        assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                      replica="ra", outcome="error") == 1

    def test_all_replicas_broken_raises_named(self):
        r = FleetRouter(
            [_FakeEngine("xa", submit_error=RuntimeError("a down")),
             _FakeEngine("xb", submit_error=RuntimeError("b down"))],
            backoff_s=0.001, max_retries=2)
        with pytest.raises(NoReplicaAvailableError) as ei:
            r.submit([1], 4)
        assert ei.value.__cause__ is not None

    def test_engine_draining_is_not_a_failure(self):
        a = _FakeEngine("da", headroom=9000,
                        submit_error=EngineDraining("draining"))
        b = _FakeEngine("db", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([1], 2)
        assert fr.replica == "db"
        info = r.introspect_requests()["replicas"]
        assert info["da"]["draining"] is True
        assert info["da"]["consecutive_failures"] == 0   # no penalty
        assert _total("fleet_draining", fleet=r.fleet_id) == 1
        # subsequent submits never even try the draining replica
        a.submit_error = None
        assert r.submit([1], 2).replica == "db"

    def test_bad_report_version_skipped_counted_warned_once(self):
        """An unknown /load version is a deploy-skew signal, not a
        replica failure: the replica is skipped for scoring, the
        mismatch books on its own labeled counter (NOT probe_error —
        no breaker penalty: the replica is healthy, just newer/older),
        and the operator warning fires once per replica, not per
        probe."""
        import warnings as _w
        a = _FakeEngine("va", version=3)
        b = _FakeEngine("vb")
        r = FleetRouter([a, b], backoff_s=0.001)
        with _w.catch_warnings(record=True) as rec:
            _w.simplefilter("always")
            assert r.submit([1], 2).replica == "vb"
            assert r.submit([1], 2).replica == "vb"
        skew = [w for w in rec if "va" in str(w.message)]
        assert len(skew) == 1                      # warn-once per replica
        assert _total("fleet_load_version_mismatch_total",
                      fleet=r.fleet_id, replica="va") >= 2
        assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                      replica="va", outcome="probe_error") == 0
        info = r.introspect_requests()["replicas"]
        assert info["va"]["consecutive_failures"] == 0   # no penalty

    def test_stale_health_fault_point_skips_replica(self):
        a, b = _FakeEngine("ha", headroom=9000), _FakeEngine("hb",
                                                             headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        with faults.injected("fleet.stale_health[ha]=fail@1"):
            fr = r.submit([1], 2)
        assert fr.replica == "hb"
        assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                      replica="ha", outcome="stale") == 1
        # the point fired once; the replica recovers on the next submit
        assert r.submit([1], 2).replica == "ha"

    def test_load_probe_fault_point_skips_replica(self):
        a, b = _FakeEngine("pa", headroom=9000), _FakeEngine("pb",
                                                             headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        with faults.injected("fleet.load_probe[pa]=fail@1"):
            fr = r.submit([1], 2)
        assert fr.replica == "pb"
        assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                      replica="pa", outcome="probe_error") == 1

    def test_breaker_opens_then_half_open_probe_recovers(self):
        a = _FakeEngine("ba", headroom=9000,
                        submit_error=RuntimeError("down"))
        b = _FakeEngine("bb", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001, breaker_failures=2,
                        breaker_probe_interval_s=0.05, max_retries=1)
        r.submit([1], 2)
        r.submit([1], 2)
        info = r.introspect_requests()["replicas"]
        assert info["ba"]["breaker"] == "open"
        # while open, dispatch skips it entirely (favorite headroom
        # notwithstanding) without burning retries
        before = _total("fleet_dispatch_total", fleet=r.fleet_id,
                        replica="ba", outcome="error")
        assert r.submit([1], 2).replica == "bb"
        assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                      replica="ba", outcome="error") == before
        # cool-down passes, the replica recovered: one probe closes it
        a.submit_error = None
        time.sleep(0.06)
        assert r.submit([1], 2).replica == "ba"
        assert r.introspect_requests()["replicas"]["ba"]["breaker"] \
            == "closed"

    def test_round_robin_policy_rotates(self):
        r = FleetRouter([_FakeEngine("qa"), _FakeEngine("qb")],
                        policy="round_robin")
        assert [r.submit([1], 1).replica for _ in range(4)] \
            == ["qa", "qb", "qa", "qb"]

    def test_affinity_routes_to_warm_replica(self):
        p = np.arange(40, dtype=np.int32)
        d = page_digests(p, 8)
        warm = _FakeEngine("wa", headroom=500, digests=d)
        cold = _FakeEngine("wb", headroom=500, digests=[])
        r = FleetRouter([cold, warm])
        assert r.submit(p, 4).replica == "wa"


class TestRouterRecovery:
    def test_unstarted_request_fails_over(self):
        a = _FakeEngine("fo1", headroom=9000, auto_finish=False)
        b = _FakeEngine("fo2", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([5, 6], 3)
        assert fr.replica == "fo1"
        a.submitted[0].die(RuntimeError("replica crashed"), streamed=0)
        assert fr.wait(5)
        assert fr.error is None and fr.replica == "fo2" and fr.retries == 1
        assert list(fr.result()) == [5, 6, 0, 1, 2]
        # the death booked a breaker failure against the dead replica
        assert r.introspect_requests()["replicas"]["fo1"][
            "consecutive_failures"] >= 1

    def test_poll_style_consumer_gets_failover_without_wait(self):
        """done/error/result must settle a recoverable replica death
        through the router — a consumer that polls instead of blocking
        in wait() gets the same failover guarantee."""
        a = _FakeEngine("pf1", headroom=9000, auto_finish=False)
        b = _FakeEngine("pf2", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([5, 6], 3)
        a.submitted[0].die(RuntimeError("replica crashed"), streamed=0)
        # no wait(): the first poll settles the death through the
        # router — re-placed on pf2 (which auto-finishes) and done
        assert fr.error is None
        assert fr.replica == "pf2" and fr.retries == 1
        assert fr.done and list(fr.result()) == [5, 6, 0, 1, 2]

    def test_started_stream_fails_loudly_never_redispatched(self):
        a = _FakeEngine("lo1", headroom=9000, auto_finish=False)
        b = _FakeEngine("lo2", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([7], 3)
        a.submitted[0].die(RuntimeError("crash"), streamed=2)
        assert fr.wait(5)
        assert isinstance(fr.error, StreamInterruptedError)
        assert "2 token(s)" in str(fr.error)
        assert fr.error.__cause__ is not None
        with pytest.raises(StreamInterruptedError):
            fr.result()
        assert not b.submitted                  # never re-dispatched

    def test_deadline_abort_is_terminal_not_retried(self):
        a = _FakeEngine("dl1", headroom=9000, auto_finish=False)
        b = _FakeEngine("dl2", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([1], 3, deadline_s=60.0)
        assert a.last_deadline_s is not None and a.last_deadline_s <= 60.0
        a.submitted[0].die(DeadlineExceededError("past deadline"))
        assert fr.wait(5)
        assert isinstance(fr.error, DeadlineExceededError)
        assert not b.submitted

    def test_failover_passes_remaining_deadline(self):
        a = _FakeEngine("rd1", headroom=9000, auto_finish=False)
        b = _FakeEngine("rd2", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([1], 3, deadline_s=60.0)
        first = a.last_deadline_s
        time.sleep(0.01)
        a.submitted[0].die(RuntimeError("crash"))
        assert fr.wait(5) and fr.replica == "rd2"
        # the re-dispatch hands the survivor only what REMAINS
        assert b.last_deadline_s < first

    def test_spent_deadline_fails_without_dispatch(self):
        a = _FakeEngine("sd1", headroom=9000)
        r = FleetRouter([a], backoff_s=0.001)
        with pytest.raises(DeadlineExceededError):
            r.submit([1], 3, deadline_s=-1.0)
        assert not a.submitted


class TestRouterStreaming:
    def test_stream_yields_then_terminates(self):
        r = FleetRouter([_FakeEngine("st1")])
        assert list(r.submit_stream([1, 2], 5)) == [0, 1, 2, 3, 4]

    def test_stream_death_before_tokens_recovers(self):
        a = _FakeEngine("sf1", headroom=9000, auto_finish=False)
        b = _FakeEngine("sf2", headroom=10, auto_finish=False)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([1], 3, stream=True)
        it = fr.stream()
        a.submitted[0].die(RuntimeError("crash"), streamed=0)
        # recovery happens inside the iterator; finish on the survivor
        got = []
        t = threading.Thread(target=lambda: got.extend(it))
        t.start()
        deadline = time.monotonic() + 5
        while not b.submitted and time.monotonic() < deadline:
            time.sleep(0.005)
        b.submitted[0].finish()
        t.join(5)
        assert not t.is_alive() and got == [0, 1, 2]
        assert fr.retries == 1 and fr.replica == "sf2"

    def test_stale_stream_terminal_does_not_recover_healthy_placement(self):
        """Regression: a replica death before any token enqueues a
        stream terminal; when ANOTHER waiter performs the recovery
        first, the stream consumer later dequeues that now-STALE
        terminal against the healthy new placement — it must be a
        no-op, not a second recovery (which booked a breaker failure
        against the live replica and double-placed the request)."""
        a = _FakeEngine("sg1", headroom=9000, auto_finish=False)
        b = _FakeEngine("sg2", headroom=10, auto_finish=False)
        r = FleetRouter([a, b], backoff_s=0.001)
        fr = r.submit([1], 3, stream=True)
        a.submitted[0].die(RuntimeError("crash"), streamed=0)
        # this wait() performs the recovery (then times out: the new
        # placement on the survivor is still running)
        assert not fr.wait(0.05)
        assert fr.replica == "sg2" and fr.retries == 1
        b.submitted[0].finish()
        # the queue now reads [stale terminal, 0, 1, 2, terminal]
        assert list(fr.stream()) == [0, 1, 2]
        assert fr.retries == 1 and len(b.submitted) == 1
        assert fr.wait(5) and fr.error is None

    def test_stream_death_after_tokens_raises_loudly(self):
        a = _FakeEngine("sl1", auto_finish=False)
        r = FleetRouter([a], backoff_s=0.001)
        it = r.submit_stream([1], 4)
        req = None
        deadline = time.monotonic() + 5
        while not a.submitted and time.monotonic() < deadline:
            time.sleep(0.001)
        req = a.submitted[0]
        req.tokens.append(0)
        req.on_token(0)
        req.error = RuntimeError("crash mid-stream")
        req.on_token(None)
        req._event.set()
        got = []
        with pytest.raises(StreamInterruptedError):
            for t in it:
                got.append(t)
        assert got == [0]        # everything streamed was delivered once

    def test_backpressure_bounded_queue_detaches_dead_consumer(self):
        """The producer blocks on a full queue (backpressure); when the
        consumer never drains it, the put times out and the stream
        detaches instead of wedging the engine's loop thread."""
        a = _FakeEngine("bp1", auto_finish=False)
        r = FleetRouter([a], stream_queue_tokens=2,
                        stream_put_timeout_s=0.05)
        fr = r.submit([1], 8, stream=True)
        req = a.submitted[0]
        t0 = time.monotonic()
        for k in range(6):                   # nobody consumes
            req.on_token(k)
        dt = time.monotonic() - t0
        assert fr._closed                    # detached after the timeout
        assert dt < 5.0                      # ...not one timeout per token
        # detached stream: further tokens drop instantly
        t0 = time.monotonic()
        req.on_token(99)
        assert time.monotonic() - t0 < 0.05
        # the engine finishes the request normally; a consumer that
        # RESUMES the iterator must get a loud detach error (tokens
        # were dropped — a silent short stream or an infinite poll
        # loop would both lie), while result() still has everything
        req.finish()
        with pytest.raises(StreamInterruptedError, match="detached"):
            list(fr.stream())
        assert fr.done and list(fr.result())[-8:] == list(range(8))

    def test_stale_health_keys_on_engine_id_not_router_alias(self):
        """The staleness gate must read the beacon the ENGINE
        heartbeats under (serving.<engine_id>), even when the replica
        is registered under a router-side alias."""
        from paddle_hackathon_tpu_torch.observability import tracing
        a = _FakeEngine("hb-real", headroom=9000)
        b = _FakeEngine("hb-other", headroom=10)
        r = FleetRouter([b], backoff_s=0.001)
        r.add_replica(a, name="hb-alias")
        assert r._replicas["hb-alias"].beacon == "serving.hb-real"
        tracing.heartbeat("serving.hb-real")
        try:
            # any existing beacon reads stale under a negative max age:
            # the aliased replica must be the one gated out
            r.health_max_age_s = -1.0
            fr = r.submit([1], 2)
            assert fr.replica == "hb-other"
            assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                          replica="hb-alias", outcome="stale") >= 1
        finally:
            tracing.remove_beacon("serving.hb-real")


class TestRouterLifecycle:
    def test_drain_removes_replica_and_calls_graceful_half(self):
        a, b = _FakeEngine("dr1"), _FakeEngine("dr2")
        r = FleetRouter([a, b])
        r.submit([1], 1)                 # mint dr-labelled series
        r.drain("dr1", timeout=5)
        assert a.drained and a.shut
        assert r.replica_names() == ["dr2"]
        assert _total("fleet_draining", fleet=r.fleet_id) == 0
        # replica churn must not grow the registry: the departed
        # replica's labelled series are dropped with it
        assert _total("fleet_dispatch_total", fleet=r.fleet_id,
                      replica="dr1") == 0
        assert r.submit([1], 1).replica == "dr2"
        with pytest.raises(KeyError):
            r.drain("dr1")

    def test_failed_drain_keeps_replica_registered(self):
        """A drain that times out (or crashes) must NOT forget a live
        engine: the replica stays registered and draining so the
        operator can retry or escalate — and a retry that succeeds
        completes the removal."""
        a, b = _FakeEngine("fd1"), _FakeEngine("fd2")
        a.drain = lambda timeout=None: (_ for _ in ()).throw(
            TimeoutError("backlog outlived timeout"))
        r = FleetRouter([a, b])
        with pytest.raises(TimeoutError):
            r.drain("fd1", timeout=1)
        assert not a.shut                          # shutdown never ran
        assert "fd1" in r.replica_names()          # still ours to retry
        info = r.introspect_requests()["replicas"]["fd1"]
        assert info["draining"] is True
        assert _total("fleet_draining", fleet=r.fleet_id) == 1
        # dispatch keeps avoiding it meanwhile
        assert r.submit([1], 1).replica == "fd2"
        # the backlog cleared: the retry completes the removal
        a.drain = lambda timeout=None: None
        r.drain("fd1", timeout=5)
        assert a.shut and r.replica_names() == ["fd2"]
        assert _total("fleet_draining", fleet=r.fleet_id) == 0

    def test_replica_side_drain_is_held_until_router_completes(self):
        """engine.drain() called directly: the router observes it at
        the next poll, stops dispatching, HOLDS the record, and
        router.drain(name) completes the removal (gauge back to 0)."""
        a, b = _FakeEngine("rs1", headroom=9000), _FakeEngine("rs2",
                                                             headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001)
        a.draining = True                # replica-side drain observed
        assert r.submit([1], 1).replica == "rs2"
        assert r.introspect_requests()["replicas"]["rs1"]["draining"]
        assert _total("fleet_draining", fleet=r.fleet_id) == 1
        assert "rs1" in r.replica_names()          # held, not forgotten
        r.drain("rs1", timeout=5)                  # operator completes
        assert a.shut and r.replica_names() == ["rs2"]
        assert _total("fleet_draining", fleet=r.fleet_id) == 0

    def test_half_open_admits_exactly_one_probe_via_router(self):
        """While a half-open probe is IN FLIGHT, a second dispatch must
        not also land on the suspect replica (the claim is atomic with
        the dispatch decision, not with the earlier candidate gate)."""
        a = _FakeEngine("hp1", headroom=9000,
                        submit_error=RuntimeError("down"))
        b = _FakeEngine("hp2", headroom=10)
        r = FleetRouter([a, b], backoff_s=0.001, breaker_failures=1,
                        breaker_probe_interval_s=0.01)
        r.submit([1], 1)                  # opens the breaker on hp1
        time.sleep(0.02)                  # cool-down elapses
        a.submit_error = None
        with r._lock:                     # claim the half-open probe,
            rep = r._replicas["hp1"]      # as an in-flight dispatch
            assert rep.breaker.allows(time.monotonic())
            rep.breaker.on_dispatch()
        # probe unresolved: the next dispatch must avoid hp1 entirely
        assert r.submit([1], 1).replica == "hp2"
        rep.breaker.record_success()
        assert r.submit([1], 1).replica == "hp1"

    def test_shutdown_drops_labels_and_unregisters(self):
        from paddle_hackathon_tpu_torch.observability import tracing
        a = _FakeEngine("sh1")
        r = FleetRouter([a])
        r.submit([1], 1)
        assert r.fleet_id in tracing.introspection_tables()
        r.shutdown()
        assert a.shut
        assert r.fleet_id not in tracing.introspection_tables()
        assert _total("fleet_dispatch_total", fleet=r.fleet_id) == 0

    def test_duplicate_replica_name_rejected(self):
        r = FleetRouter([_FakeEngine("dup")])
        with pytest.raises(ValueError):
            r.add_replica(_FakeEngine("dup"))
        with pytest.raises(ValueError):
            FleetRouter(policy="weird")


# ---------------------------------------------------------------------------
# the JAX package's choice on the same reports
# ---------------------------------------------------------------------------

def _random_reports(rs, digests):
    reps = {}
    for k in range(rs.randint(1, 5)):
        rep = _rep(headroom=int(rs.choice([0, 20, 60, 200, 500])),
                   depth=int(rs.randint(0, 4)), active=int(rs.randint(0, 8)),
                   version=int(rs.choice([1, 1, 1, 2])),
                   draining=bool(rs.rand() < 0.15),
                   digests=(None if rs.rand() < 0.3 else
                            list(digests[:rs.randint(0, len(digests) + 1)])))
        if rs.rand() < 0.5:
            rep["queue"]["classes"] = {
                c: {"depth": int(rs.randint(0, 4))}
                for c in ("interactive", "default", "batch")}
        reps[f"r{k}"] = rep
    if rs.rand() < 0.1:
        reps["junk"] = None
    return reps


def test_pick_replica_and_affinity_make_the_jax_choice():
    rs = np.random.RandomState(0)
    prompt = np.arange(40, dtype=np.int32)
    digests = page_digests(prompt, 8)
    assert digests == jfleet.page_digests(prompt, 8)
    n_cases = 0
    for _ in range(400):
        reps = _random_reports(rs, digests)
        need = int(rs.choice([10, 50, 100, 400]))
        prio = [None, "interactive", "default", "batch"][rs.randint(4)]
        excl = {n for n in reps if rs.rand() < 0.1}
        dg = digests if rs.rand() < 0.7 else None
        got, want = {}, {}
        assert pick_replica(reps, need, digests=dg, exclude=excl,
                            priority=prio, explain=got) == \
            jfleet.pick_replica(reps, need, digests=dg, exclude=excl,
                                priority=prio, explain=want)
        assert got == want
        for rep in reps.values():
            if isinstance(rep, dict):
                assert affinity_depth(rep, digests) == \
                    jfleet.affinity_depth(rep, digests)
                assert jfleet._queue_depth_for(rep, prio) == \
                    __import__("paddle_hackathon_tpu_torch.inference.fleet",
                               fromlist=["_"])._queue_depth_for(rep, prio)
        n_cases += 1
    assert n_cases == 400


def test_breaker_state_machine_matches_jax():
    ops = [("allows", 0.0), ("fail", 0.0), ("allows", 0.1), ("fail", 0.1),
           ("allows", 0.5), ("allows", 1.2), ("dispatch",), ("allows", 1.3),
           ("fail", 1.4), ("allows", 2.0), ("allows", 2.5), ("dispatch",),
           ("ok",), ("allows", 2.6)]
    bs = [CircuitBreaker(2, 1.0), jfleet.CircuitBreaker(2, 1.0)]
    for op in ops:
        seen = []
        for b in bs:
            if op[0] == "allows":
                seen.append(b.allows(op[1]))
            elif op[0] == "fail":
                b.record_failure(op[1])
            elif op[0] == "dispatch":
                b.on_dispatch()
            else:
                b.record_success()
            seen.append((b.state, b.consecutive_failures))
        assert seen[:len(seen) // 2] == seen[len(seen) // 2:], op


# ---------------------------------------------------------------------------
# drills (2 tiny port replicas, each with its own model object)
# ---------------------------------------------------------------------------

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
MAXNEW = 8


def _affinity_prompts():
    rs = np.random.RandomState(11)
    shared = rs.randint(0, 128, (24,)).astype(np.int32)   # 3 full pages
    return [np.concatenate([shared,
                            rs.randint(0, 128, (4,)).astype(np.int32)])
            for _ in range(6)]


@pytest.fixture(scope="module")
def drill():
    """The JAX model's weights, 10 drill prompts and the JAX engine's
    greedy outputs for them (MAXNEW new tokens)."""
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    rs = np.random.RandomState(7)
    lens = [(6, 9, 7, 11, 8, 10)[k % 6] for k in range(10)]
    prompts = [rs.randint(0, 128, (k,)).astype(np.int32) for k in lens]
    eng = JEngine(jm, auto_run=False, max_slots=4, max_len=64, chunk=4)
    reqs = [eng.submit(p, MAXNEW) for p in prompts]
    eng.run_until_idle()
    refs = [r.result() for r in reqs]
    eng.shutdown(timeout=5)
    return arrays, prompts, refs


def _drill_engine(arrays, **kw):
    # its own model object a replica, as in the JAX drills
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    kw.setdefault("cache_mode", "paged")
    kw.setdefault("page_size", 8)
    return ServingEngine(tm, max_slots=2, max_len=64, chunk=4, **kw)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failover_drill_kill_replica_mid_flight(drill):
    """``serving.tick[<replica>]`` kills one of two replicas on its 3rd
    tick: every request that had not started completes on the survivor
    token-exact against the JAX engine, every started stream fails loudly
    (``StreamInterruptedError``), and no page is left in use."""
    arrays, prompts, refs = drill
    e1, e2 = _drill_engine(arrays), _drill_engine(arrays)
    faults.arm_point(f"serving.tick[{e1.engine_id}]", "fail", nth=3)
    try:
        router = FleetRouter([e1, e2], backoff_s=0.01, breaker_failures=1)
        frs = [router.submit(p, MAXNEW) for p in prompts]
        ok = failed = failovers = 0
        for fr, ref in zip(frs, refs):
            assert fr.wait(120), "request hung"
            if fr.error is None:
                np.testing.assert_array_equal(fr.result(), ref)
                ok += 1
                failovers += fr.retries > 0
            else:
                assert isinstance(fr.error, StreamInterruptedError)
                assert len(fr.tokens) > 0
                failed += 1
        assert ok + failed == len(prompts)
        assert failovers >= 1 and ok >= failed
    finally:
        faults.disarm()
    e2.drain(timeout=60)
    e2.drop_prefix_cache()
    assert e2.kv_pages_in_use == 0
    e2.shutdown()
    e1.drop_prefix_cache()
    assert e1.kv_pages_in_use == 0


def test_drain_under_load_loses_nothing(drill):
    arrays, prompts, refs = drill
    e1, e2 = _drill_engine(arrays), _drill_engine(arrays)
    router = FleetRouter([e1, e2], backoff_s=0.01)
    # streaming through the fleet: token-exact against the JAX engine
    assert list(router.submit_stream(prompts[0], MAXNEW)) \
        == list(refs[0][-MAXNEW:])
    inflight = [router.submit(p, MAXNEW) for p in prompts[:6]]
    router.drain(e1.engine_id, timeout=60)
    for fr, ref in zip(inflight, refs):
        assert fr.wait(60) and fr.error is None
        np.testing.assert_array_equal(fr.result(), ref)
    assert router.replica_names() == [e2.engine_id]
    with pytest.raises(EngineDraining):
        e1.submit([1, 2], 2)
    fr = router.submit(prompts[1], MAXNEW)
    assert fr.wait(60) and fr.replica == e2.engine_id
    e2.drain(timeout=60)
    for e in (e1, e2):
        e.drop_prefix_cache()
        assert e.kv_pages_in_use == 0
    router.shutdown()


def test_affinity_beats_round_robin_on_repeat_prefix_workload(drill):
    """A repeat-prefix workload routed with affinity shows a higher
    prefix-hit ratio on the affine replica than round-robin gives any
    replica; the tokens are the JAX engine's either way."""
    arrays = drill[0]
    prompts = _affinity_prompts()
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    jeng = JEngine(jm, auto_run=False, max_slots=4, max_len=64, chunk=4)
    jreqs = [jeng.submit(p, 4) for p in prompts]
    jeng.run_until_idle()
    refs = [r.result() for r in jreqs]
    jeng.shutdown(timeout=5)

    def run(policy):
        e1, e2 = _drill_engine(arrays), _drill_engine(arrays)
        router = FleetRouter([e1, e2], policy=policy)
        for p, ref in zip(prompts, refs):
            fr = router.submit(p, 4)
            assert fr.wait(60) and fr.error is None
            np.testing.assert_array_equal(fr.result(), ref)
        ratios = [e.stats["prefix_hit_rate"] for e in (e1, e2)]
        router.shutdown()
        return ratios

    affine = run("least_loaded")
    rr = run("round_robin")
    assert max(affine) > max(rr)
    assert max(affine) > 0.5


def test_fleet_drive_clean_under_sanitizers(drill):
    """The router and two replicas under the lock-order and race
    sanitizers (engines built inside the contexts, so their locks are
    instrumented): a streamed request, three more, a drain."""
    from paddle_hackathon_tpu_torch.observability import sanitizers
    arrays, prompts, refs = drill
    with sanitizers.lock_sanitizer(), sanitizers.race_sanitizer():
        e1, e2 = _drill_engine(arrays), _drill_engine(arrays)
        router = FleetRouter([e1, e2], backoff_s=0.01)
        frs = [router.submit(p, MAXNEW, stream=(i == 0))
               for i, p in enumerate(prompts[:4])]
        assert list(frs[0].stream()) == list(refs[0][-MAXNEW:])
        for fr, ref in zip(frs, refs):
            assert fr.wait(60) and fr.error is None
            np.testing.assert_array_equal(fr.result(), ref)
        router.drain(e1.engine_id, timeout=60)
        router.shutdown()
