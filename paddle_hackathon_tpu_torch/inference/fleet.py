"""Fault-tolerant serving fleet: a replica router over N engines (the
port of the JAX package's ``inference/fleet.py``; host code only, the
same logic over the port's engine and ``observability/``).

Ref: the reference framework serves multi-rank inference through the
``fleet_executor`` actor pipeline (``dist_model.cc`` — a persistent
runtime fronting per-stage worker processes).  This module is the
fleet half of that design, built on the engine's reports: each
:class:`ServingEngine` replica
publishes a versioned ``/load`` capacity report (page-exact admission
headroom, rolling SLO percentiles, goodput, a ``prefix_digest``
cache-affinity block) and a ``/healthz`` liveness beacon — the
:class:`FleetRouter` is the thing that finally READS them.

Topology: in-process replica handles first.  A replica is anything
speaking the engine surface (``submit``/``load_report``/``drain``/
``shutdown`` + an ``engine_id``); the dispatch core is transport-
agnostic, so the multi-process deployment puts the same router behind
an HTTP shim polling ``/load`` instead of calling ``load_report()``
(docs/SERVING.md, "Serving fleet").

Dispatch (least-loaded + cache-affinity):

- candidates are live, non-draining replicas whose circuit breaker
  allows traffic and whose liveness beacon is not stale;
- among candidates whose ``admission.headroom_tokens`` admits the
  request RIGHT NOW, the deepest ``prefix_digest`` match wins (the
  replica already holds the prompt's prefix pages — repeat tenants land
  where their KV lives), then most headroom, then shortest queue;
- when nobody has headroom the request queues on the least-loaded
  replica (engines queue internally; FIFO admission bounds the wait);
- ``submit(session=)`` turns pin to the replica that served the last
  turn (it retains the conversation's KV pages for a suffix-cache
  resume); a draining/unhealthy pin target is skipped and the turn
  migrates — the pin is a fast path over the ``prefix_digest``
  affinity, never load-bearing for correctness.

Robustness is the headline:

- **deadlines** — ``submit(deadline_s=)`` is the request's TOTAL wall
  budget; the engine aborts it in-queue or mid-decode
  (``where="deadline"``), and a re-dispatch carries only the REMAINING
  budget.
- **bounded retry + backoff** — a failed placement (submit error,
  injected dispatch fault) retries against other replicas with
  exponential backoff; a replica DEATH re-dispatches its
  not-yet-started requests to a healthy replica.  A request that has
  streamed tokens is failed LOUDLY (:class:`StreamInterruptedError`
  naming the replica and the token count) — never silently retried,
  because a retry would duplicate output the caller already consumed.
- **circuit breaker** — consecutive failures (submit errors, load-probe
  errors, stale health) open a per-replica breaker; after a cool-down
  one half-open probe dispatch tests recovery (success closes, failure
  re-opens).
- **graceful drain** — :meth:`FleetRouter.drain` stops dispatching to a
  replica, lets its queued + inflight requests finish
  (``ServingEngine.drain``), then ``shutdown()`` — zero requests lost
  to a planned removal.
- **streaming backpressure** — :meth:`FleetRouter.submit_stream` yields
  tokens as the engine commits them through a BOUNDED queue: a slow
  consumer stalls that replica's decode loop (the engine delivers
  outside its lock), not the router or other requests.

Fault drills ride the ``PHT_FAULTS`` harness (observability/faults.py):
``fleet.dispatch`` fires per placement attempt,
``fleet.load_probe[<replica>]`` per capacity poll,
``fleet.stale_health[<replica>]`` inside the health gate, and the
engine's per-replica ``serving.tick[<engine_id>]`` kills ONE replica of
many deterministically — "kill a replica mid-flight" is a test, not a
hope (tests/test_torch_fleet.py).

All shared router state is guarded by ``make_lock`` locks and declared
via ``share_object`` so the runtime lockset sanitizer polices it.

Replicas on one CUDA card share its default stream: each engine's
kernels are launched in order from its own loop thread onto the
current stream (per thread, the default stream unless a caller set
another), the engines share no tensor, and the caching allocator's
reuse is ordered on that one stream, so concurrent replicas need no
stream of their own.

Fleet observability (docs/OBSERVABILITY.md, "Fleet telemetry"): every
dispatch mints a fleet-wide trace context (:meth:`FleetRequest.
trace_context` — fleet id, fleet rid, attempt ordinal; a plain dict
designed to ride an HTTP header later) that the replica stamps into its
lifecycle record and spans, while the router emits its own spans
(``fleet.route``/``fleet.dispatch``/``fleet.backoff``/
``fleet.failover``/``fleet.drain_migration``) on a per-fleet-request
lane — ``cross_stack.merge_traces(stitch_fleet=True)`` fuses both sides
into one swimlane per request.  :meth:`FleetRouter.load_report` /
``/fleet`` federates every replica's ``/load`` (version-gated, with
staleness ages), :meth:`FleetRouter.expose_text` federates their metric
text under a bounded ``replica=`` label, and a rules-driven watchdog
over the replicas' rolling SLO windows surfaces named degradation
reasons in :meth:`FleetRouter.health_report` / ``/healthz``.
"""

from __future__ import annotations

import itertools
import queue
import time
import warnings
import weakref
from typing import Dict, List, Optional

import numpy as np

from ..observability import faults as _faults
from ..observability import flight as _flight
from ..observability import metrics as _obs
from ..observability import tracing as _tr
from ..observability.sanitizers import make_lock, make_rlock, share_object
from .paged import page_digests
from .serving import (PRIORITY_RANK, DeadlineExceededError,
                      EngineDraining)

# placement-retry pacing per class: an interactive request backs off
# half as long between attempts (its SLO is the tightest), a batch
# request twice as long (it can wait; its retries must not crowd the
# dispatch path while the fleet is degraded)
_BACKOFF_FACTOR = {"interactive": 0.5, "default": 1.0, "batch": 2.0}

__all__ = ["FleetRouter", "FleetRequest", "CircuitBreaker",
           "NoReplicaAvailableError", "StreamInterruptedError",
           "pick_replica", "affinity_depth",
           "BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN"]

_FLEET_IDS = itertools.count()
# fleet-wide request ids: process-wide like the engine's rids, but a
# SEPARATE sequence — one fleet request may burn several engine rids
# across failovers, and the merged-trace stitcher keys lanes on this
_FLEET_RIDS = itertools.count(1)
# chrome-trace lane base for router spans: engine spans lane on the
# (small-int) engine rid, router spans on _FLEET_LANE + fleet_rid so
# the two sequences never collide in an unstitched trace
_FLEET_LANE = 1 << 20

# session-pin map bound: pins past this evict oldest-first (the evicted
# conversation still routes right via prefix_digest affinity — a pin is
# a fast path, never load-bearing for correctness)
MAX_SESSION_PINS = 4096

# bound on the /debug/requests live-request table (the registry itself
# is weak — this caps only the rendered rows)
MAX_FORENSICS_ROWS = 256


class NoReplicaAvailableError(RuntimeError):
    """Every placement attempt failed: no live, non-draining,
    breaker-closed replica accepted the request within the retry
    budget.  Carries the last underlying failure as ``__cause__``."""


class StreamInterruptedError(RuntimeError):
    """A replica died AFTER streaming part of a request's output.  The
    router never silently re-dispatches a started stream — the caller
    has already consumed tokens, and a retry would duplicate them — so
    the failure is loud and names the replica and how far it got.  The
    replica's root cause rides ``__cause__``."""


# breaker states, exported as the fleet_breaker_state gauge values
BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN = 0, 1, 2


class CircuitBreaker:
    """Per-replica failure gate (closed → open → half-open → ...).

    Pure host state with the clock INJECTED at every transition, so the
    state machine unit-tests without sleeping.  The owner (the router)
    serializes access under its own lock.

    - ``failure_threshold`` consecutive failures open the breaker
      (dispatch stops);
    - after ``probe_interval_s`` the next :meth:`allows` turns it
      half-open and admits exactly ONE probe dispatch
      (:meth:`on_dispatch` marks it in flight — the owner must run the
      ``allows`` + ``on_dispatch`` pair as one atomic step under its
      lock at the dispatch decision, or two concurrent dispatches both
      read the unclaimed probe);
    - the probe's success closes the breaker (failure count reset), its
      failure re-opens it and restarts the cool-down."""

    __slots__ = ("failure_threshold", "probe_interval_s", "state",
                 "consecutive_failures", "_opened_at", "_probing")

    def __init__(self, failure_threshold: int = 3,
                 probe_interval_s: float = 1.0):
        self.failure_threshold = int(failure_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    def allows(self, now: float) -> bool:
        """May the router dispatch to this replica right now?  An open
        breaker past its cool-down transitions to half-open here (the
        decision point) and admits a single probe."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN:
            if now - self._opened_at < self.probe_interval_s:
                return False
            self.state = BREAKER_HALF_OPEN
            self._probing = False
        return not self._probing

    def on_dispatch(self) -> None:
        """The router is about to dispatch here; in half-open state
        that dispatch IS the probe — no second one until it resolves."""
        if self.state == BREAKER_HALF_OPEN:
            self._probing = True

    def record_failure(self, now: float) -> None:
        self.consecutive_failures += 1
        if (self.state == BREAKER_HALF_OPEN
                or self.consecutive_failures >= self.failure_threshold):
            self.state = BREAKER_OPEN
            self._opened_at = now
            self._probing = False

    def record_success(self) -> None:
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self._probing = False


def affinity_depth(report: dict, digests: List[int]) -> int:
    """How many leading prompt pages this replica already holds: the
    deepest entry of ``digests`` (the prompt's chain digests from
    :func:`paged.page_digests`) present in the report's
    ``prefix_digest`` block.  0 when the replica publishes no block
    (dense replica) or nothing matches — chains hashed with a
    different page size simply never match (the running crc covers
    different byte spans), so a mixed fleet degrades to no affinity
    rather than wrong affinity."""
    pd = report.get("prefix_digest")
    if not pd or not digests:
        return 0
    have = pd.get("digests") or ()
    if not have:
        return 0
    have = set(have)
    depth = 0
    for k, d in enumerate(digests, 1):
        if d in have:
            depth = k
    return depth


def _queue_depth_for(report: dict, priority=None) -> int:
    """Queue depth AS SEEN BY a request of ``priority``: only classes
    scheduled at or before its own (the engine admits best effective
    class first), read from the ``queue.classes`` block.  Falls back to
    the total depth when no priority is given or the replica predates
    the block — an interactive queue starving behind a deep batch
    queue stops being invisible to least-loaded scoring."""
    q = report.get("queue") or {}
    classes = q.get("classes")
    if priority is None or not isinstance(classes, dict):
        return int(q.get("depth") or 0)
    r = PRIORITY_RANK.get(priority, 1)
    return sum(int(((classes.get(c) or {}).get("depth")) or 0)
               for c, rank in PRIORITY_RANK.items() if rank <= r)


def pick_replica(reports: Dict[str, dict], need: int,
                 digests: Optional[List[int]] = None,
                 exclude=(), priority=None,
                 explain: Optional[dict] = None) -> Optional[str]:
    """Pure dispatch scoring over ``/load`` reports (the router
    contract, docs/OBSERVABILITY.md "SLO telemetry and the /load
    report"); returns the chosen replica name, or None when no report
    is a candidate.

    Reading rules honored here: only ``version == 1`` documents count;
    ``draining`` replicas are never candidates; ``headroom_tokens`` is
    "would this request fit RIGHT NOW" as one comparison.  Scoring:
    among replicas whose headroom admits ``need``, deepest
    ``prefix_digest`` affinity match first (repeat tenants land on the
    replica already holding their pages), then most headroom, then
    shortest queue, then fewest active slots; when NOBODY has headroom
    the request queues on the least-loaded replica (shortest queue
    first — engines admit best-class-first, so the depth a request
    compares is only the classes scheduled at or before its own, via
    ``queue.classes`` when the replica publishes it).  Name
    order breaks remaining ties, so equal fleets dispatch
    deterministically.

    ``explain``, when a dict is passed, is filled in place with WHY the
    winner won — ``{"why": "affinity" | "headroom" | "queued_least_
    loaded", "affinity_depth": int, "headroom": int, "queue_depth":
    int}`` — the per-hop forensics record ``/debug/requests`` shows
    (an out-param so the scoring stays a pure single-return function
    for every existing caller)."""
    cands = []
    for name in sorted(reports):
        rep = reports[name]
        if name in exclude or not isinstance(rep, dict):
            continue
        if rep.get("version") != 1 or rep.get("draining"):
            continue
        adm = rep.get("admission") or {}
        head = int(adm.get("headroom_tokens") or 0)
        depth = _queue_depth_for(rep, priority)
        active = int((rep.get("slots") or {}).get("active") or 0)
        aff = affinity_depth(rep, digests) if digests else 0
        cands.append((name, head, depth, active, aff))
    if not cands:
        return None
    fits = [c for c in cands if c[1] >= need]
    if fits:
        best = min(fits, key=lambda c: (-c[4], -c[1], c[2], c[3], c[0]))
        why = "affinity" if best[4] else "headroom"
    else:
        best = min(cands, key=lambda c: (c[2], c[3], -c[1], c[0]))
        why = "queued_least_loaded"
    if explain is not None:
        explain.update(why=why, affinity_depth=best[4],
                       headroom=best[1], queue_depth=best[2])
    return best[0]


class _Replica:
    """Router-side record for one replica handle."""

    __slots__ = ("name", "handle", "breaker", "draining", "g_breaker",
                 "beacon", "last_report", "last_report_ts",
                 "version_warned")

    def __init__(self, name, handle, breaker, g_breaker):
        self.name = name
        self.handle = handle
        self.breaker = breaker
        self.draining = False
        self.g_breaker = g_breaker     # fleet_breaker_state child
        # liveness-beacon key: engines heartbeat under their OWN
        # engine_id, which may differ from the router-side name
        # (add_replica(name=...)) — keying the staleness gate on the
        # wrong string would silently disable it for that replica
        self.beacon = f"serving.{getattr(handle, 'engine_id', name)}"
        # last GOOD (version-1) /load report + its monotonic stamp: the
        # fleet load_report serves this with its staleness age when a
        # fresh probe fails, so a federated scrape shows "stale since"
        # instead of a hole
        self.last_report: Optional[dict] = None
        self.last_report_ts: Optional[float] = None
        # warn-once latch for an unknown /load envelope version
        self.version_warned = False


class FleetRequest:
    """Router-side request handle: re-pointable across replicas until
    the first token streams.

    Mirrors the engine :class:`Request` surface — ``wait(timeout)`` →
    done, ``result()`` raises-or-returns, ``.tokens``/``.done``/
    ``.error`` — plus fleet provenance: ``.replica`` (current
    placement) and ``.retries`` (re-dispatch count).  Terminal fleet
    failures (:class:`NoReplicaAvailableError`,
    :class:`StreamInterruptedError`) surface through ``.error`` /
    ``result()`` exactly like engine failures.

    Recovery runs lazily inside ``wait()``/the stream iterator: when
    the current engine request dies, the waiter calls the router back
    — the router re-dispatches a not-yet-started request (zero
    committed tokens) to another replica, and fails a started one
    loudly.  The per-request RLOCK is held across the whole recovery
    (decision + re-placement), so concurrent waiters serialize on it
    and exactly one performs the recovery — the rest observe the new
    generation when it releases.  (No ``__slots__``: the race
    sanitizer's ``share_object`` shim needs a swappable class
    layout.)"""

    def __init__(self, router, prompt, max_new_tokens, kw, deadline_s,
                 stream, session=None, priority=None):
        self._router = router
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self._kw = kw                      # sampling overrides
        self.session = session             # multi-turn KV session key
        self.priority = "default" if priority is None else priority
        self.deadline_s = deadline_s
        self._t_submit = time.perf_counter()
        # fleet-wide trace identity: survives failovers (each placement
        # burns a fresh engine rid; this one names the REQUEST) — the
        # lane key cross_stack's --stitch-fleet merges swimlanes on
        self.fleet_rid = next(_FLEET_RIDS)
        # dispatch attempt ordinal (every _try_dispatch bumps it,
        # including failover re-placements) — rides the trace context
        self._attempts = 0
        # per-hop forensics, appended under _lock per placement attempt:
        # which replica, why chosen, outcome/cause — the hop history
        # /debug/requests renders (bounded by the retry budget per
        # placement episode plus one failover marker per recovery)
        self.hops: List[dict] = []
        # queue-at-router span: submit() ends it at first successful
        # placement (or terminal failure) — router-side queueing +
        # retries are exactly the TTFT the replica cannot see
        self._span_route = _tr.start_span(
            "fleet.route", _tid=_FLEET_LANE + self.fleet_rid,
            fleet=router.fleet_id, fleet_rid=self.fleet_rid,
            priority=self.priority)
        # RLock: _recover holds it across _place, which re-acquires it
        # to install the new placement
        self._lock = make_rlock("fleet.request")
        self._req = None                   # current engine Request
        self._replica = None
        self._retries = 0
        self._failed: Optional[BaseException] = None
        self._stream_q = (queue.Queue(maxsize=router.stream_queue_tokens)
                          if stream else None)
        # consumer-gone latch: once set, on_token drops tokens instead
        # of backpressuring a tick loop nobody is reading from.
        # Written by the consumer/put-timeout, read by the engine's
        # loop thread — single aligned bool, declared atomic to the
        # race sanitizer below.
        self._closed = False
        share_object(self, f"fleet.request[{id(self)}]",
                     atomic=("_closed",))

    def trace_context(self) -> dict:
        """The fleet trace context this request's NEXT/current placement
        carries to its replica: ``{"fleet", "fleet_rid", "attempt"}``.
        A plain JSON-able dict by design — when replicas move behind
        HTTP this is the header payload, unchanged
        (docs/OBSERVABILITY.md, "Fleet telemetry")."""
        with self._lock:
            return {"fleet": self._router.fleet_id,
                    "fleet_rid": self.fleet_rid,
                    "attempt": self._attempts}

    # -- engine-Request-compatible surface --------------------------------
    def _settle(self):
        """Resolve any terminal-looking engine error through the
        router's recovery BEFORE exposing state: poll-style consumers
        (``done``/``error``/``result``) must get the same failover
        ``wait()``/``stream()`` perform, or a recoverable replica
        death would leak out as terminal to anyone who didn't block.
        Returns the settled ``(req, failed)`` pair."""
        while True:
            with self._lock:
                req, failed = self._req, self._failed
            if failed is not None or req is None or req.error is None:
                return req, failed
            # _recover serializes on the request lock and, by the time
            # it returns, has either recorded a terminal _failed or
            # installed a new placement — loop to look at that
            self._router._recover(self, req)

    @property
    def done(self) -> bool:
        req, failed = self._settle()
        if failed is not None:
            return True
        return bool(req is not None and req.done)

    @property
    def error(self) -> Optional[BaseException]:
        return self._settle()[1]

    @property
    def tokens(self) -> List[int]:
        with self._lock:
            req = self._req
        return list(req.tokens) if req is not None else []

    @property
    def rid(self):
        with self._lock:
            return self._req.rid if self._req is not None else None

    # provenance reads take the request lock like the rest of the
    # surface: a recovery on another thread re-points these mid-flight
    @property
    def replica(self) -> Optional[str]:
        with self._lock:
            return self._replica

    @property
    def retries(self) -> int:
        with self._lock:
            return self._retries

    def wait(self, timeout=None) -> bool:
        """Block until the request is terminal (finished, or failed
        beyond recovery); replica deaths are recovered HERE — the
        waiter is the thread with nothing better to do."""
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                req, failed = self._req, self._failed
            if failed is not None:
                return True
            rem = None if end is None else max(0.0, end - time.monotonic())
            req._event.wait(rem)
            if not req._event.is_set():
                return False               # caller's timeout
            if req.error is None:
                return True                # finished clean
            self._router._recover(self, req)

    def result(self):
        """Full sequence (prompt + generated) or raise the terminal
        error — same contract as ``Request.result`` (recoverable
        replica deaths are settled through the router first)."""
        req, failed = self._settle()
        if failed is not None:
            raise failed
        if req is None:
            raise RuntimeError("request was never placed")
        return req.result()

    # -- streaming --------------------------------------------------------
    def _on_token(self, tok, gen):
        """Engine-side hook (replica loop thread, engine lock NOT
        held; ``_try_dispatch`` binds ``gen`` per placement).  The
        BOUNDED blocking put is the backpressure: a slow consumer
        stalls that replica's decode loop.  A consumer that stopped
        reading entirely (put times out / generator closed) flips
        ``_closed`` and the stream detaches — the engine finishes the
        request normally rather than wedging its tick loop.

        Entries are ``(generation, token-or-None)``: a failover leaves
        the dead placement's terminal ``None`` in the queue with NO
        ordering guarantee against the survivor's entries (two engine
        threads flush independently), so the consumer needs the tag to
        tell a stale terminal from the live generation's real end."""
        if self._closed:
            return
        try:
            self._stream_q.put((gen, tok),
                               timeout=self._router.stream_put_timeout_s)
        except queue.Full:
            self._closed = True

    def stream(self):
        """Generator yielding committed token ids as the fleet produces
        them; returns on clean finish, raises the terminal error
        (recovering replica deaths for not-yet-started requests along
        the way).  Closing the generator detaches the stream — the
        request keeps running, ``wait()``/``result()`` still work."""
        if self._stream_q is None:
            raise RuntimeError("not a streaming request; use "
                               "submit_stream()")
        try:
            while True:
                try:
                    gen, tok = self._stream_q.get(timeout=0.25)
                except queue.Empty:
                    if self._closed:
                        # the backpressure timeout detached this stream
                        # while the consumer was away: tokens (and the
                        # terminal) were DROPPED, so resuming the
                        # iterator can never deliver a complete stream
                        # — fail loudly; wait()/result() still return
                        # the full output
                        raise StreamInterruptedError(
                            "stream detached after the backpressure "
                            "put timeout (consumer stopped reading); "
                            "tokens were dropped — use wait()/result() "
                            "for the complete output")
                    with self._lock:
                        failed = self._failed
                    if failed is not None:
                        raise failed
                    continue
                if tok is not None:
                    yield tok
                    continue
                # a terminal: clean end, recoverable death, a loud
                # failure — or STALE (a dead generation's, possibly
                # enqueued out of order against the live placement's
                # entries; the live placement feeds the same queue)
                with self._lock:
                    req, failed, cur = self._req, self._failed, \
                        self._retries
                if failed is not None:
                    raise failed
                if gen != cur:
                    continue              # stale terminal: keep draining
                if req.error is None:
                    # the live generation's own terminal: its engine
                    # appends it under the lock that set done/error and
                    # flushes in order, so this really is the end
                    return
                self._router._recover(self, req)
                with self._lock:
                    failed = self._failed
                if failed is not None:
                    raise failed
                # recovered onto a fresh replica: keep draining the
                # same queue — the new placement feeds it
        finally:
            self._closed = True


class FleetRouter:
    """Health-driven replica router: least-loaded + cache-affinity
    dispatch, deadlines/retry/backoff, circuit breaking, graceful
    drain, per-token streaming (module docstring has the full design;
    docs/SERVING.md "Serving fleet" the operator view).

    Args:
      replicas: engine handles to front (``add_replica`` adds more
        later).  In-process ``ServingEngine`` objects, or anything
        speaking the same surface.
      max_retries: placement attempts per request beyond the first
        (dispatch failures back off exponentially from ``backoff_s`` by
        ``backoff_mult``).
      health_max_age_s: a replica whose liveness beacon
        (``serving.<engine_id>``) is older than this is treated as
        wedged (same rule as ``/healthz?max_age``); an ABSENT beacon is
        fine — idle engines drop theirs by design.
      breaker_failures / breaker_probe_interval_s: circuit-breaker
        threshold and cool-down (:class:`CircuitBreaker`).
      policy: ``"least_loaded"`` (default; headroom + affinity scoring
        via :func:`pick_replica`) or ``"round_robin"`` (rotation over
        healthy replicas — the affinity A/B baseline, not a production
        policy).
      stream_queue_tokens / stream_put_timeout_s: streaming
        backpressure bound and the consumer-gone detach timeout.
      watchdog_ttft_p99_s / watchdog_goodput_ratio / watchdog_skew:
        rules-driven degradation watchdog thresholds evaluated at every
        :meth:`load_report`/:meth:`health_report` over the replicas'
        rolling SLO windows — an interactive TTFT p99 past
        ``watchdog_ttft_p99_s``, a goodput ratio under
        ``watchdog_goodput_ratio`` right after preemptions grew, or a
        max/min load spread past ``watchdog_skew`` fires a named
        degradation (flight-recorder event on each transition, reason
        strings in ``/healthz``).
    """

    def __init__(self, replicas=(), *, max_retries: int = 2,
                 backoff_s: float = 0.02, backoff_mult: float = 2.0,
                 health_max_age_s: float = 10.0,
                 breaker_failures: int = 3,
                 breaker_probe_interval_s: float = 1.0,
                 policy: str = "least_loaded",
                 stream_queue_tokens: int = 64,
                 stream_put_timeout_s: float = 30.0,
                 watchdog_ttft_p99_s: float = 2.0,
                 watchdog_goodput_ratio: float = 0.5,
                 watchdog_skew: int = 64):
        if policy not in ("least_loaded", "round_robin"):
            raise ValueError(f"policy must be 'least_loaded' or "
                             f"'round_robin', got {policy!r}")
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self.health_max_age_s = float(health_max_age_s)
        self.breaker_failures = int(breaker_failures)
        self.breaker_probe_interval_s = float(breaker_probe_interval_s)
        self.policy = policy
        self.stream_queue_tokens = int(stream_queue_tokens)
        self.stream_put_timeout_s = float(stream_put_timeout_s)
        self.watchdog_ttft_p99_s = float(watchdog_ttft_p99_s)
        self.watchdog_goodput_ratio = float(watchdog_goodput_ratio)
        self.watchdog_skew = int(watchdog_skew)

        self._lock = make_lock("fleet.router")
        self._replicas: Dict[str, _Replica] = {}
        self._rr = 0                      # round_robin rotation cursor
        # session stickiness: session key -> last replica that served a
        # turn of it (that replica retains the conversation's KV pages,
        # so a returning turn must land there to resume — the pin is a
        # fast path over the prefix_digest affinity scoring, which
        # still catches pin misses).  Bounded LRU: a chat fleet sees
        # unbounded session churn and the map must not grow with it.
        self._session_pins: Dict[str, str] = {}
        self.fleet_id = f"f{next(_FLEET_IDS)}"
        self._flight = _flight.get_flight_recorder()
        # live-request forensics registry: fleet_rid -> FleetRequest,
        # weak so a dropped handle vanishes from /debug/requests on its
        # own (mutation vs snapshot serialized under _lock, same
        # discipline as the tracing registries)
        self._requests: "weakref.WeakValueDictionary[int, FleetRequest]" \
            = weakref.WeakValueDictionary()
        # watchdog state: active rule key -> {"since", "reason"}; the
        # per-replica preemption counts from the previous evaluation
        # (the goodput rule fires on a crater RIGHT AFTER preemptions
        # grew, so it needs the delta)
        self._wd_state: Dict[str, dict] = {}
        self._wd_prev_preempt: Dict[str, int] = {}

        reg = self._registry = _obs.get_registry()
        lbl = {"fleet": self.fleet_id}
        self._fam_dispatch = reg.counter(
            "fleet_dispatch_total",
            "dispatch attempts by replica and outcome (ok / error / "
            "stale / probe_error / draining)")
        self._fam_retries = reg.counter(
            "fleet_retries_total",
            "request re-dispatches by reason (backoff_retry = placement "
            "retry within an episode, failover = replica-death "
            "re-dispatch)")
        self._fam_dispatch_s = reg.histogram(
            "fleet_dispatch_seconds",
            "submit-to-placed latency by outcome (hit = first attempt, "
            "retry = placed after backoff, failover = re-placed after a "
            "replica death)", unit="s")
        self._fam_vmismatch = reg.counter(
            "fleet_load_version_mismatch_total",
            "/load reports skipped for an unknown envelope version "
            "(deployment skew, not ill health: no breaker penalty)")
        self._fam_breaker = reg.gauge(
            "fleet_breaker_state",
            "per-replica circuit breaker (0 closed / 1 half-open / "
            "2 open)")
        self._g_draining = reg.gauge(
            "fleet_draining", "replicas currently draining").labels(**lbl)
        self._g_draining.set(0)
        self._g_skew = reg.gauge(
            "fleet_replica_skew",
            "max-min spread of per-replica load (queue depth + active "
            "slots) across live candidates").labels(**lbl)
        self._g_skew.set(0)

        for r in replicas:
            self.add_replica(r)
        # first consumer of the race tooling: every attr above is
        # mutated under _lock; the registry/flight handles hold their
        # own locks
        share_object(self, f"fleet.router[{self.fleet_id}]")
        _tr.register_introspection_source(self.fleet_id, self)
        _tr.register_fleet_source(self.fleet_id, self)

    # ------------------------------------------------------------------
    def add_replica(self, handle, name: Optional[str] = None) -> str:
        """Register a replica; returns its fleet name (the engine's
        ``engine_id`` unless overridden)."""
        name = name or getattr(handle, "engine_id", None)
        if name is None:
            raise ValueError("replica has no engine_id; pass name=")
        g = self._fam_breaker.labels(fleet=self.fleet_id, replica=name)
        g.set(BREAKER_CLOSED)
        rep = _Replica(name, handle,
                       CircuitBreaker(self.breaker_failures,
                                      self.breaker_probe_interval_s), g)
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = rep
        return name

    def replica_names(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    # labelled-inc helpers: label VALUES arrive as parameters (replica
    # names and small outcome/reason enums — bounded), never loop
    # targets or request ids, which keeps PHT005 provably clean on the
    # dispatch hot path
    def _count(self, name: str, outcome: str) -> None:
        self._fam_dispatch.labels(
            fleet=self.fleet_id, replica=name, outcome=outcome).inc()

    def _count_retry(self, reason: str) -> None:
        self._fam_retries.labels(fleet=self.fleet_id, reason=reason).inc()

    def _observe_dispatch(self, outcome: str, seconds: float) -> None:
        self._fam_dispatch_s.labels(
            fleet=self.fleet_id, outcome=outcome).observe(seconds)

    def _version_mismatch(self, rep: _Replica, version) -> None:
        """An unknown /load envelope version: count it, warn ONCE per
        replica, and skip the report for scoring — deployment skew is
        not ill health, so no breaker penalty (a mixed-version rollout
        must not open breakers fleet-wide)."""
        self._fam_vmismatch.labels(
            fleet=self.fleet_id, replica=rep.name).inc()
        warn = False
        with self._lock:
            if not rep.version_warned:
                rep.version_warned = True
                warn = True
        if warn:
            warnings.warn(
                f"fleet {self.fleet_id}: replica {rep.name!r} publishes "
                f"/load envelope version {version!r} (expected 1); its "
                f"reports are skipped for dispatch scoring until it "
                f"speaks version 1", RuntimeWarning, stacklevel=3)

    # ------------------------------------------------------------------
    # health + capacity
    def _health_ok(self, rep: _Replica) -> bool:
        """Staleness gate, the ``/healthz?max_age`` rule: a beacon
        older than ``health_max_age_s`` means the replica's loop is
        wedged mid-work — don't feed it.  No beacon = idle or external
        replica = fine (idle engines drop theirs by design).  The
        per-replica ``fleet.stale_health[<name>]`` fault point makes
        "replica goes stale" a deterministic drill."""
        try:
            _faults.point(f"fleet.stale_health[{rep.name}]")
        except _faults.InjectedFault:
            return False
        age = _tr.beacon_ages().get(rep.beacon)
        return age is None or age <= self.health_max_age_s

    def _probe_load(self, rep: _Replica) -> Optional[dict]:
        """One capacity poll (the in-process ``/load`` read).  None on
        failure — the caller books it against the breaker."""
        _faults.point(f"fleet.load_probe[{rep.name}]")
        return rep.handle.load_report()

    # pht-lint: hot-root (fleet dispatch path — every request crosses it)
    def _candidates(self):
        """Health- and breaker-gated replicas with their fresh load
        reports.  Breaker decisions run under the router lock; the
        probes run OUTSIDE it (a replica's load_report takes the
        engine lock — never nest it under ours while other submitters
        wait)."""
        now = time.monotonic()
        with self._lock:
            reps = [r for r in self._replicas.values() if not r.draining]
            allowed = [r for r in reps if r.breaker.allows(now)]
            for r in allowed:
                r.g_breaker.set(r.breaker.state)
        out = []
        for rep in allowed:
            if not self._health_ok(rep):
                self._count(rep.name, "stale")
                self._record_failure(rep)
                continue
            try:
                report = self._probe_load(rep)
            except Exception:  # noqa: BLE001 — probe failure is data
                self._count(rep.name, "probe_error")
                self._record_failure(rep)
                continue
            if not isinstance(report, dict):
                # a non-dict "report" is a broken probe, not skew
                self._count(rep.name, "probe_error")
                self._record_failure(rep)
                continue
            if report.get("version") != 1:
                # the router contract: consumers must check version.
                # Unknown version = deployment skew — counted + warned
                # (once) and skipped for scoring; NOT a breaker failure
                self._version_mismatch(rep, report.get("version"))
                continue
            if report.get("draining"):
                # replica-side drain (someone called engine.drain()
                # directly): honor it without a breaker penalty.  The
                # record is HELD as draining — dispatch stops now, and
                # the operator completes the removal with
                # router.drain(name) (idempotent against an already-
                # draining engine), which also returns fleet_draining
                # to 0.  Auto-removing here would shutdown() an engine
                # the operator may still be watching drain.
                self._mark_draining(rep)
                continue
            with self._lock:
                # cache the good report: the fleet load_report serves
                # it with a staleness age when a later probe fails
                rep.last_report = report
                rep.last_report_ts = time.monotonic()
            out.append((rep, report))
        if len(out) >= 2:
            # max-min spread of (class-blind) load across the live
            # candidates — the skew series the one-hot-replica watchdog
            # rule and dashboards read.  Host arithmetic on reports
            # already in hand: no extra probe.
            loads = [_queue_depth_for(rep) +
                     int((rep.get("slots") or {}).get("active") or 0)
                     for _, rep in out]
            self._g_skew.set(max(loads) - min(loads))
        return out

    def _mark_draining(self, rep: _Replica) -> int:
        """Stop dispatching to ``rep`` and publish the fleet_draining
        gauge — the one place the draining flag is set (router drain,
        replica-side drain observed by a probe, EngineDraining on
        submit).  Returns how many session pins were migrated off the
        replica (the ``fleet.drain_migration`` span reports it)."""
        with self._lock:
            rep.draining = True
            self._g_draining.set(
                sum(r.draining for r in self._replicas.values()))
            # unpin its sessions NOW: the next turn of each migrates to
            # a survivor instead of queuing behind a drain (the drained
            # engine donates retained chains to its prefix cache, so a
            # same-replica re-admission would have replayed — but the
            # replica is leaving; the survivor re-prefilles, tokens
            # stay exact)
            stale_pins = [s for s, n in self._session_pins.items()
                          if n == rep.name]
            for sid in stale_pins:
                del self._session_pins[sid]
            return len(stale_pins)

    def _record_failure(self, rep: _Replica) -> None:
        with self._lock:
            rep.breaker.record_failure(time.monotonic())
            rep.g_breaker.set(rep.breaker.state)

    def _record_success(self, rep: _Replica) -> None:
        with self._lock:
            rep.breaker.record_success()
            rep.g_breaker.set(rep.breaker.state)

    # pht-lint: hot-root (fleet dispatch path)
    def _try_dispatch(self, freq: FleetRequest, exclude) -> bool:
        """One placement attempt; True when the request landed.  False
        = no candidate right now (retry may help); raises on a submit
        failure (booked against that replica's breaker) so the retry
        loop backs off before trying again.

        Observability bracket around :meth:`_dispatch_once` (the actual
        pick+submit): bumps the request's attempt ordinal, emits the
        ``fleet.dispatch`` span on the request's fleet lane, and
        appends the hop record (replica, why chosen, outcome, cause)
        the ``/debug/requests`` forensics table renders.  Both are
        host-side dict work — nothing here touches the device or mints
        a metric label from an id."""
        with freq._lock:
            freq._attempts += 1
            attempt = freq._attempts
        sp = _tr.start_span(
            "fleet.dispatch", _tid=_FLEET_LANE + freq.fleet_rid,
            fleet=self.fleet_id, fleet_rid=freq.fleet_rid,
            attempt=attempt)
        hop = {"attempt": attempt}
        try:
            placed = self._dispatch_once(freq, exclude, hop)
            hop.setdefault("outcome", "ok" if placed else "no_candidate")
            return placed
        except BaseException as e:
            hop.setdefault("outcome", "error")
            hop["cause"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            with freq._lock:
                freq.hops.append(hop)
            sp.end(**{k: v for k, v in hop.items() if k != "attempt"})

    # pht-lint: hot-root (fleet dispatch path)
    def _dispatch_once(self, freq: FleetRequest, exclude,
                       hop: dict) -> bool:
        """The pick + submit of one placement attempt (see
        :meth:`_try_dispatch` for the contract); fills ``hop`` with the
        forensics of what it did."""
        _faults.point("fleet.dispatch")
        cands = self._candidates()
        by_name = {rep.name: (rep, report) for rep, report in cands
                   if rep.name not in exclude}
        if not by_name:
            return False
        need = int(len(freq.prompt)) + freq.max_new_tokens
        name = None
        with self._lock:
            # session stickiness: resolve the pin and ACT on it under
            # ONE lock hold (no TOCTOU window against _mark_draining's
            # pin purge) — the pinned replica retains this
            # conversation's KV pages, so land there while it is a
            # live candidate; a draining/unhealthy/excluded pin fell
            # out of by_name above, so the turn migrates via the
            # normal pick below
            if freq.session is not None:
                pinned = self._session_pins.get(freq.session)
                if pinned is not None and pinned in by_name:
                    name = pinned
                    hop["why"] = "session_pin"
            if name is None and self.policy == "round_robin":
                names = sorted(by_name)
                name = names[self._rr % len(names)]
                self._rr += 1
                hop["why"] = "round_robin"
        if name is None:
            digests = None
            sizes = {(rep.get("prefix_digest") or {}).get("page_size")
                     for _, rep in by_name.values()}
            sizes.discard(None)
            if len(sizes) == 1:
                # one fleet-wide page size (the deployment norm): hash
                # the prompt once.  Mixed page sizes would need one
                # chain per size — affinity is skipped instead of
                # guessed (docs/SERVING.md).
                digests = page_digests(freq.prompt, sizes.pop())
            explain = {}
            name = pick_replica(
                {n: rep for n, (_, rep) in by_name.items()}, need,
                digests=digests, priority=freq.priority, explain=explain)
            if name is None:
                return False
            hop.update(explain)
        rep, _report = by_name[name]
        hop["replica"] = name
        deadline_rem = None
        if freq.deadline_s is not None:
            # the engine measures from ITS submit stamp: hand the
            # replica only what remains of the caller's total budget
            deadline_rem = freq.deadline_s - (time.perf_counter()
                                              - freq._t_submit)
            if deadline_rem <= 0:
                raise DeadlineExceededError(
                    f"request spent its whole deadline_s="
                    f"{freq.deadline_s} before a replica accepted it")
        with self._lock:
            # atomic re-check + probe claim: _candidates gated on
            # allows() BEFORE the unlocked health/probe window, so a
            # concurrent dispatch may have claimed the half-open probe
            # (or re-opened the breaker) since — "exactly one probe"
            # is enforced here, at the dispatch decision, under the
            # router lock
            if not rep.breaker.allows(time.monotonic()):
                hop["outcome"] = "breaker_lost_race"
                return False
            rep.breaker.on_dispatch()     # half-open: this IS the probe
        on_token = None
        if freq._stream_q is not None:
            # bind THIS placement's generation (the re-dispatch count:
            # _recover bumps it before re-placing, and the initial
            # placement happens-before any recovery) so the stream
            # consumer can tell a dead generation's stale terminal
            # from the live one's real end
            with freq._lock:
                gen = freq._retries

            def on_token(tok, _freq=freq, _gen=gen):
                _freq._on_token(tok, _gen)
        try:
            req = rep.handle.submit(
                freq.prompt, freq.max_new_tokens,
                deadline_s=deadline_rem,
                on_token=on_token,
                trace_ctx=freq.trace_context(),
                **freq._kw)
        except EngineDraining:
            # not a failure: mark and let the retry pick elsewhere
            self._mark_draining(rep)
            self._count(rep.name, "draining")
            hop["outcome"] = "draining"
            return False
        except Exception as e:
            self._count(rep.name, "error")
            self._record_failure(rep)
            # this episode must not re-pick the replica that just
            # refused (the breaker only opens after a streak): the
            # caller owns the mutable exclude set
            exclude.add(rep.name)
            raise e
        self._count(rep.name, "ok")
        self._record_success(rep)
        if freq.session is not None:
            with self._lock:
                # (re)pin last-wins; re-insert for LRU recency so hot
                # conversations survive the bound
                self._session_pins.pop(freq.session, None)
                self._session_pins[freq.session] = rep.name
                while len(self._session_pins) > MAX_SESSION_PINS:
                    self._session_pins.pop(
                        next(iter(self._session_pins)))
        with freq._lock:
            freq._req = req
            freq._replica = rep.name
        self._flight.record(
            "fleet", phase="dispatch", fleet=self.fleet_id,
            replica=rep.name, rid=req.rid, fleet_rid=freq.fleet_rid,
            retries=freq.retries)
        return True

    def _place(self, freq: FleetRequest, exclude=(),
               is_retry: bool = False) -> None:
        """Bounded retry-with-backoff around :meth:`_try_dispatch`.
        A replica whose submit raised is excluded for the REST of this
        placement episode (the breaker only opens after a streak — one
        episode must not burn its whole budget on one broken replica).
        When every replica is excluded the last attempts run
        un-excluded: with the fleet degraded that far, a replica that
        failed earlier in the episode beats refusing outright.  Raises
        :class:`NoReplicaAvailableError` (last failure as cause) when
        the budget is spent, :class:`DeadlineExceededError` when the
        caller's budget died first."""
        exclude = set(exclude)
        last_err = None
        t0 = time.perf_counter()
        delay = self.backoff_s * _BACKOFF_FACTOR.get(freq.priority, 1.0)
        for attempt in range(self.max_retries + 1):
            if attempt or is_retry:
                # reason taxonomy: a failover episode's first attempt is
                # the failover itself; later attempts (either episode
                # kind) are backoff retries
                self._count_retry("failover" if is_retry and not attempt
                                  else "backoff_retry")
            if attempt:
                bsp = _tr.start_span(
                    "fleet.backoff", _tid=_FLEET_LANE + freq.fleet_rid,
                    fleet=self.fleet_id, fleet_rid=freq.fleet_rid,
                    attempt=attempt, delay_s=delay)
                time.sleep(delay)
                bsp.end()
                delay *= self.backoff_mult
            if exclude >= set(self.replica_names()):
                exclude = set()     # whole fleet excluded: start over
            try:
                if self._try_dispatch(freq, exclude):
                    # episode latency by how hard placement was: first
                    # attempt = hit, placed after backoff = retry, any
                    # failover re-placement = failover
                    self._observe_dispatch(
                        "failover" if is_retry
                        else ("retry" if attempt else "hit"),
                        time.perf_counter() - t0)
                    return
            except DeadlineExceededError:
                raise
            except Exception as e:  # noqa: BLE001 — injected fault or
                last_err = e        # submit error: retry elsewhere
        raise NoReplicaAvailableError(
            f"no replica accepted the request after "
            f"{self.max_retries + 1} attempts "
            f"(replicas={self.replica_names()}, excluded={sorted(exclude)})"
        ) from last_err

    # ------------------------------------------------------------------
    # public submission surface
    def submit(self, prompt, max_new_tokens: int = 32, *,
               temperature=None, top_k=None, top_p=None,
               deadline_s=None, stream: bool = False,
               session=None, priority=None) -> FleetRequest:
        """Dispatch a request to the best replica (module docstring has
        the scoring); returns a :class:`FleetRequest`.  Raises
        :class:`NoReplicaAvailableError` when no replica accepts within
        the retry budget.

        ``session=`` names a multi-turn conversation: the key is handed
        through to the replica (``ServingEngine.submit(session=)``
        resumes the retained KV chain there) and the router PINS the
        session to the replica that served it, so the next turn lands
        where its pages live.  A pinned replica that is draining,
        unhealthy or breaker-open is simply skipped — the turn migrates
        (the survivor replays from its prefix cache at best, a cold
        prefill at worst; tokens stay exact either way) and the pin
        follows the new placement.

        ``priority=`` (interactive/default/batch) rides to the replica
        verbatim (``ServingEngine.submit(priority=)`` — class-ordered
        admission, preemption) and shapes the ROUTER side too: queue
        scoring counts only the classes scheduled at or before this
        one (``_queue_depth_for``), and placement-retry backoff scales
        by class (``_BACKOFF_FACTOR``) so a degraded fleet serves its
        tightest SLOs first."""
        if priority is not None and priority not in PRIORITY_RANK:
            raise ValueError(
                f"priority must be one of {sorted(PRIORITY_RANK)}, "
                f"got {priority!r}")
        freq = FleetRequest(
            self, prompt, max_new_tokens,
            {"temperature": temperature, "top_k": top_k, "top_p": top_p,
             "session": session, "priority": priority},
            None if deadline_s is None else float(deadline_s), stream,
            session=session, priority=priority)
        with self._lock:
            # forensics registry (weak): /debug/requests renders the
            # live handles' hop histories; a dropped handle vanishes
            self._requests[freq.fleet_rid] = freq
        try:
            self._place(freq)
        except BaseException as e:
            with freq._lock:
                freq._failed = e
            freq._span_route.end(error=type(e).__name__)
            raise
        freq._span_route.end(replica=freq.replica, retries=freq.retries)
        return freq

    def submit_stream(self, prompt, max_new_tokens: int = 32, **kw):
        """Per-token streaming: returns a generator yielding token ids
        as the serving engine commits them, through a bounded queue
        whose blocking put is the backpressure (a slow consumer stalls
        the producing replica's decode loop — never the router).  When
        you also need the request handle (``.retries``, ``.replica``),
        use ``submit(..., stream=True)`` and call ``.stream()`` on
        it — this helper is the common one-liner."""
        return self.submit(prompt, max_new_tokens, stream=True,
                           **kw).stream()

    def _recover(self, freq: FleetRequest, req) -> None:
        """A replica failed ``req`` (engine loop death, deadline, ...):
        decide the FleetRequest's fate.  Serialized per request by its
        lock; idempotent — late waiters observing an already-recovered
        generation return immediately.

        - deadline aborts are terminal (the caller's budget died, not
          the replica);
        - a STARTED stream (committed tokens exist) fails loudly
          (:class:`StreamInterruptedError`) — re-running it would
          duplicate output;
        - a not-yet-started request books a breaker failure against the
          dead replica and re-dispatches everywhere else."""
        with freq._lock:
            if freq._req is not req or freq._failed is not None:
                return                    # another waiter already did it
            if req.error is None:
                # nothing to recover: a stream consumer can get here on
                # a STALE queue terminal (the dead generation's fail-all
                # enqueued None, another waiter already re-placed the
                # request) — recovering a healthy placement would book a
                # breaker failure against a live replica and double-
                # place the request
                return
            failed_on = freq._replica
            if isinstance(req.error, DeadlineExceededError):
                freq._failed = req.error
                return
            if req.tokens:
                freq._failed = StreamInterruptedError(
                    f"replica {failed_on} died after streaming "
                    f"{len(req.tokens)} token(s) of this request; not "
                    f"re-dispatched — a retry would silently duplicate "
                    f"output the caller already consumed")
                freq._failed.__cause__ = req.error
                self._wake_stream(freq)
                return
            freq._retries += 1
            freq.hops.append({
                "attempt": freq._attempts, "outcome": "failover",
                "replica": failed_on,
                "cause": f"{type(req.error).__name__}: {req.error}"})
            # the replica broke a placed request: that is a health
            # event even though the submit itself succeeded earlier
            with self._lock:
                rep = self._replicas.get(failed_on)
            if rep is not None:
                self._record_failure(rep)
            self._flight.record(
                "fleet", phase="failover", fleet=self.fleet_id,
                replica=failed_on, rid=req.rid,
                fleet_rid=freq.fleet_rid)
            fsp = _tr.start_span(
                "fleet.failover", _tid=_FLEET_LANE + freq.fleet_rid,
                fleet=self.fleet_id, fleet_rid=freq.fleet_rid,
                from_replica=failed_on,
                cause=type(req.error).__name__)
            try:
                # re-dispatch AWAY from the dead replica.  Still inside
                # freq._lock (an RLock): concurrent waiters block here
                # until the new generation is installed, so exactly one
                # recovery runs.  Concurrent SUBMITS keep flowing —
                # they never touch this request's lock.
                self._place(freq, exclude=frozenset((failed_on,)),
                            is_retry=True)
            except BaseException as e:
                freq._failed = e
                self._wake_stream(freq)
                fsp.end(outcome="failed", error=type(e).__name__)
            else:
                fsp.end(outcome="re_placed", replica=freq._replica)

    @staticmethod
    def _wake_stream(freq: FleetRequest) -> None:
        """Wake a consumer blocked in the stream queue so it observes
        the terminal state now, not at its next poll timeout.  The
        generation-less tag never matches the consumer's current
        generation — the entry exists only to unblock the get(); the
        consumer reads the real terminal from ``_failed``."""
        if freq._stream_q is not None:
            try:
                freq._stream_q.put_nowait((None, None))
            except queue.Full:
                pass

    # ------------------------------------------------------------------
    # lifecycle
    def drain(self, name: str, timeout: float = 60.0) -> None:
        """Gracefully remove replica ``name``: stop dispatching to it
        immediately, let its queued + inflight requests finish
        (``handle.drain``), then ``handle.shutdown()`` and forget it —
        a planned removal loses zero requests (the fault-drill twin is
        the UNPLANNED removal, where failover does the work).

        A FAILED drain (backlog outlived ``timeout``, or the engine
        crashed mid-drain and raised) leaves the replica REGISTERED and
        marked draining: the router keeps refusing to dispatch there,
        the operator retries ``drain`` or escalates to the replica's
        own ``shutdown`` — silently forgetting a live engine would
        leave its daemon loop to die at interpreter exit mid-device
        call.  Success removes the replica and drops its labelled
        series (replica churn must not grow the registry forever)."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"no replica {name!r} "
                               f"(have {sorted(self._replicas)})")
        migrated = self._mark_draining(rep)
        self._flight.record("fleet", phase="drain", fleet=self.fleet_id,
                            replica=name)
        # drain-migration span on the router's own (fleet-id) lane: a
        # removal is fleet-scoped work, not one request's
        dsp = _tr.start_span("fleet.drain_migration", _tid=_FLEET_LANE,
                             fleet=self.fleet_id, replica=name,
                             migrated_pins=migrated)
        # ONE budget for the whole removal: shutdown gets what the
        # backlog drain left, not a fresh full timeout (an operator
        # watchdog sized to `timeout` must not fire mid-removal).  The
        # small floor lets the engine's loop-stopped poll run at least
        # once — after a completed drain it passes immediately.
        end = time.monotonic() + float(timeout)
        try:
            rep.handle.drain(timeout=timeout)
            rep.handle.shutdown(timeout=max(0.05, end - time.monotonic()))
        except BaseException as e:
            dsp.end(outcome="failed", error=type(e).__name__)
            raise
        with self._lock:
            self._replicas.pop(name, None)
            self._g_draining.set(
                sum(r.draining for r in self._replicas.values()))
        self._registry.drop_labels(fleet=self.fleet_id, replica=name)
        dsp.end(outcome="removed")

    def shutdown(self, timeout: float = 60.0) -> None:
        """Hard stop: shut every replica down (no drain — use
        :meth:`drain` per replica for graceful removal), unregister the
        router's introspection source and drop its labelled series
        (router churn must not grow the process registry forever)."""
        with self._lock:
            reps = list(self._replicas.values())
            self._replicas.clear()
            self._session_pins.clear()
            self._g_draining.set(0)
        for rep in reps:
            try:
                rep.handle.shutdown(timeout=timeout)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        _tr.unregister_introspection_source(self.fleet_id)
        _tr.unregister_fleet_source(self.fleet_id)
        self._registry.drop_labels(fleet=self.fleet_id)

    def introspect_requests(self) -> dict:
        """Router table for ``/debug/requests``: per-replica breaker
        state, draining flag, failure streak (snapshot under the
        router lock; host dicts only) — plus per-request hop forensics
        (which replica each attempt picked and why, each retry's
        cause) and the active watchdog degradations."""
        state_names = {BREAKER_CLOSED: "closed",
                       BREAKER_HALF_OPEN: "half_open",
                       BREAKER_OPEN: "open"}
        with self._lock:
            replicas = {
                name: {"breaker": state_names[r.breaker.state],
                       "consecutive_failures":
                           r.breaker.consecutive_failures,
                       "draining": r.draining}
                for name, r in self._replicas.items()}
            pins = len(self._session_pins)
            degraded = [dict(v, rule=k)
                        for k, v in sorted(self._wd_state.items())]
        return {"fleet": self.fleet_id, "policy": self.policy,
                "session_pins": pins, "replicas": replicas,
                "requests": self._forensics(), "watchdog": degraded}

    def _forensics(self, limit: int = MAX_FORENSICS_ROWS) -> dict:
        """Hop histories of the live fleet requests (weak registry:
        dropped handles have already vanished).  Reads raw fields under
        each request's lock — deliberately NOT ``_settle()``:
        introspection must never trigger a recovery/re-placement as a
        side effect of being looked at."""
        with self._lock:
            items = sorted(self._requests.items())[:limit]
        out = {}
        # no router lock held here: freq._lock nests router->request
        # nowhere (dispatch nests request->router), so taking it after
        # releasing ours keeps the lock order acyclic
        for frid, freq in items:
            with freq._lock:
                req = freq._req
                out[str(frid)] = {
                    "rid": req.rid if req is not None else None,
                    "replica": freq._replica,
                    "priority": freq.priority,
                    "retries": freq._retries,
                    "attempts": freq._attempts,
                    "done": bool(freq._failed is not None
                                 or (req is not None and req.done)),
                    "error": (type(freq._failed).__name__
                              if freq._failed is not None else None),
                    "hops": [dict(h) for h in freq.hops]}
        return out

    # ------------------------------------------------------------------
    # fleet telemetry: federation, health, watchdog
    # (docs/OBSERVABILITY.md, "Fleet telemetry")
    def load_report(self) -> dict:
        """The federated fleet capacity document — the ``/fleet``
        endpoint body (registered via ``tracing.register_fleet_source``
        at construction).  One fresh ``/load`` probe per replica
        (version-gated; an unknown version counts
        ``fleet_load_version_mismatch_total`` and the replica's entry
        carries no trusted fields), each entry labelled with its
        staleness: ``age_s`` is 0 for a fresh report, the cache age
        when the probe failed and the last GOOD report is served
        instead (``stale: true``).  Plus fleet-only aggregates:
        per-outcome dispatch percentiles, replica skew, merged SLO
        percentiles over in-process replicas' rolling windows, and the
        active watchdog degradations."""
        now = time.monotonic()
        ages = _tr.beacon_ages()
        with self._lock:
            reps = list(self._replicas.values())
        replicas = {}
        loads = []
        slo_wins: Dict[str, list] = {}
        for rep in reps:
            entry = {"draining": rep.draining,
                     "breaker": rep.breaker.state,
                     "beacon_age_s": (round(ages[rep.beacon], 3)
                                      if rep.beacon in ages else None)}
            report = None
            try:
                report = self._probe_load(rep)
            except Exception as e:  # noqa: BLE001 — probe failure is data
                entry["probe_error"] = f"{type(e).__name__}: {e}"
            if isinstance(report, dict) and report.get("version") == 1:
                with self._lock:
                    rep.last_report = report
                    rep.last_report_ts = now
                entry["report"] = report
                entry["age_s"] = 0.0
                entry["version_ok"] = True
                if not rep.draining:
                    loads.append(_queue_depth_for(report) + int(
                        (report.get("slots") or {}).get("active") or 0))
            else:
                if isinstance(report, dict):
                    self._version_mismatch(rep, report.get("version"))
                    entry["version_ok"] = False
                with self._lock:
                    stale, ts = rep.last_report, rep.last_report_ts
                if stale is not None:
                    # serve the cached good report WITH its age — a
                    # scrape shows "stale since", never silently-fresh
                    # numbers from a replica that stopped answering
                    entry["report"] = stale
                    entry["age_s"] = round(now - ts, 3)
                    entry["stale"] = True
            sw = getattr(rep.handle, "slo_windows", None)
            if callable(sw) and not entry.get("stale"):
                try:
                    for k, h in sw().items():
                        slo_wins.setdefault(k, []).append(h)
                except Exception:  # noqa: BLE001 — aggregation is best-effort
                    pass
            replicas[rep.name] = entry
        skew = (max(loads) - min(loads)) if len(loads) >= 2 else 0
        self._g_skew.set(skew)
        slo_merged = {}
        for k, wins in sorted(slo_wins.items()):
            try:
                slo_merged[k] = _obs.merged_percentiles(wins)
            except ValueError:
                # mixed bucket bounds across replicas: skip the merge
                # rather than publish a wrong percentile
                slo_merged[k] = None
        dispatch = {}
        for outcome in ("hit", "retry", "failover"):
            h = self._fam_dispatch_s.labels(
                fleet=self.fleet_id, outcome=outcome)
            if h.count:
                dispatch[outcome] = {
                    "count": int(h.count),
                    "p50_s": h.quantile(0.5), "p99_s": h.quantile(0.99)}
        return {"version": 1, "kind": "fleet", "fleet": self.fleet_id,
                "ts": time.time(), "policy": self.policy,
                "replicas": replicas, "replica_skew": skew,
                "dispatch": dispatch,
                "slo_merged": slo_merged or None,
                "watchdog": self._watchdog_eval(replicas)}

    def health_report(self) -> dict:
        """The fleet block of ``/healthz``: per-replica beacon ages
        sorted STALEST FIRST (the wedged replica is the first thing a
        probe reader sees), breaker/draining state, and the active
        watchdog degradation reasons.  ``ok`` is false when any beacon
        breaches ``health_max_age_s`` or a degradation is active — one
        fleet probe trips instead of N per-replica ones."""
        ages = _tr.beacon_ages()
        state_names = {BREAKER_CLOSED: "closed",
                       BREAKER_HALF_OPEN: "half_open",
                       BREAKER_OPEN: "open"}
        with self._lock:
            reps = [(r.name, r.beacon, r.draining, r.breaker.state)
                    for r in self._replicas.values()]
            degraded = [dict(v, rule=k)
                        for k, v in sorted(self._wd_state.items())]
        rows = []
        for name, beacon, draining, bstate in reps:
            rows.append({"replica": name,
                         "beacon_age_s": (round(ages[beacon], 3)
                                          if beacon in ages else None),
                         "draining": draining,
                         "breaker": state_names[bstate]})
        # stalest first; beacon-less replicas (idle engines drop
        # theirs by design) sort last — they are fine, not unknown
        rows.sort(key=lambda r: (r["beacon_age_s"] is not None,
                                 r["beacon_age_s"] or 0.0), reverse=True)
        stale = [r["replica"] for r in rows
                 if r["beacon_age_s"] is not None
                 and r["beacon_age_s"] > self.health_max_age_s]
        return {"fleet": self.fleet_id,
                "ok": not stale and not degraded,
                "stale_replicas": stale, "replicas": rows,
                "degraded": degraded}

    def _watchdog_eval(self, replicas: dict) -> list:
        """Evaluate the degradation rules over fresh per-replica
        entries (called from :meth:`load_report` with the probe results
        already in hand — the watchdog never adds probes).  Rule keys
        embed replica NAMES (bounded) and live in ``_wd_state``;
        each fired/cleared transition emits a flight-recorder event so
        the forensics timeline shows WHEN the fleet degraded.  Returns
        the active degradations, named."""
        now = time.time()
        fired: Dict[str, str] = {}
        loads = []
        for name, entry in sorted(replicas.items()):
            doc = entry.get("report")
            if not isinstance(doc, dict) or entry.get("stale"):
                continue
            slo_cls = (doc.get("slo") or {}).get("classes") or {}
            ttft = (slo_cls.get("interactive") or {}).get("ttft") or None
            if ttft and ttft.get("p99") is not None \
                    and ttft["p99"] > self.watchdog_ttft_p99_s:
                fired[f"ttft_p99[{name}]"] = (
                    f"interactive ttft p99 {ttft['p99']:.3f}s breaches "
                    f"{self.watchdog_ttft_p99_s}s on {name}")
            gp = (doc.get("goodput") or {}).get("ratio")
            pre = int(((doc.get("scheduler") or {})
                       .get("preemptions")) or 0)
            with self._lock:
                prev = self._wd_prev_preempt.get(name, 0)
                self._wd_prev_preempt[name] = pre
            if gp is not None and gp < self.watchdog_goodput_ratio \
                    and pre > prev:
                fired[f"goodput[{name}]"] = (
                    f"goodput ratio {gp:.2f} cratered below "
                    f"{self.watchdog_goodput_ratio} right after "
                    f"preemptions grew ({prev} -> {pre}) on {name}")
            if not entry.get("draining"):
                loads.append(_queue_depth_for(doc) + int(
                    (doc.get("slots") or {}).get("active") or 0))
        if len(loads) >= 2 and max(loads) - min(loads) > self.watchdog_skew:
            fired["replica_skew"] = (
                f"replica load spread {max(loads) - min(loads)} exceeds "
                f"{self.watchdog_skew} (one replica is hoarding or "
                f"starving)")
        events = []
        with self._lock:
            for key in sorted(fired):
                if key not in self._wd_state:
                    self._wd_state[key] = {"since": now,
                                           "reason": fired[key]}
                    events.append((key, "fired", fired[key]))
                else:
                    self._wd_state[key]["reason"] = fired[key]
            for key in [k for k in sorted(self._wd_state)
                        if k not in fired]:
                events.append((key, "cleared",
                               self._wd_state[key]["reason"]))
                del self._wd_state[key]
            active = [dict(v, rule=k)
                      for k, v in sorted(self._wd_state.items())]
        # flight records outside the router lock (locks are leaves)
        for key, state, reason in events:
            self._flight.record(
                "fleet", phase="watchdog", fleet=self.fleet_id,
                rule=key, state=state, reason=reason)
        return active

    def expose_text(self) -> str:
        """One federated Prometheus scrape for the whole fleet: every
        replica's series re-labelled ``replica="<name>"`` (bounded by
        fleet size — the PHT005 rule for the injected label) plus the
        router's own ``fleet_*`` series.  A replica handle exposing
        ``metrics_text()`` (the HTTP shim contract) is scraped through
        it; in-process engines are sliced out of the shared registry by
        their ``engine=`` label."""
        with self._lock:
            reps = [(r.name, r.handle) for r in self._replicas.values()]
        parts = {}
        for name, handle in reps:
            mt = getattr(handle, "metrics_text", None)
            try:
                if callable(mt):
                    parts[name] = mt()
                else:
                    parts[name] = self._registry.expose_text(
                        label_filter={
                            "engine": getattr(handle, "engine_id", name)})
            except Exception as e:  # noqa: BLE001 — scrape must not die
                parts[name] = (f"# replica scrape failed: "
                               f"{type(e).__name__}\n")
        return (_obs.federate_text(parts)
                + self._registry.expose_text(
                    label_filter={"fleet": self.fleet_id}))
