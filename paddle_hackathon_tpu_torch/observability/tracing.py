"""Event-level tracing: request/step spans on the chrome-trace timeline.

The port's copy of the JAX package's ``observability/tracing.py``,
unchanged (host-only: it imports no JAX).

The metrics registry (``observability/metrics.py``) answers aggregate
questions — p99 TTFT, tokens/s.  When ONE request blows past p99 or one
training step stalls, aggregates cannot answer "what happened to *this*
request/step"; spans can.  This module is the span half of the triad
(metrics → spans → introspection):

- :func:`span` — ``with span("serving.tick", tickno=3):`` context
  manager for straight-line scopes.
- :func:`start_span` / :func:`end_span` — explicit pairs for lifecycles
  that interleave across many requests (a serving tick advances eight
  requests at once; no single ``with`` block brackets one request).
- :func:`add_span` — retroactive emission for work whose bounds were
  measured anyway (a device tick's wall clock times N slots at once:
  one call per slot lands each request's share on its own lane).

Cost model: tracing is DEFAULT-OFF.  Every entry point checks one
module-level flag and returns a shared no-op when disabled, so the
serving decode tick and the compiled fit loop keep their timings when
nobody is tracing.  ``profiler.Profiler`` arms tracing while recording
(the span sink feeds ``export_chrome_tracing``'s ``"ph": "X"`` events,
merged by ``profiler/cross_stack.py`` alongside the counter events), and
finished spans also land in the always-on flight recorder
(``observability/flight.py``) so a crash dump carries recent spans.

The module additionally keeps two tiny always-on registries the
introspection server (``observability/server.py``) reads:

- :func:`heartbeat` — named liveness beacons (the serving engine marks
  one per tick, the fit loop one per telemetry sync) for ``/healthz``.
- :func:`register_introspection_source` — live objects exposing
  ``introspect_requests()`` (the serving slot table) for
  ``/debug/requests``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, Optional

from .sanitizers import make_lock

__all__ = ["span", "start_span", "end_span", "add_span", "Span",
           "enable_tracing", "disable_tracing", "tracing_enabled",
           "set_span_sink", "heartbeat", "beacon_ages", "remove_beacon",
           "pin_beacon",
           "register_introspection_source",
           "unregister_introspection_source", "introspection_tables",
           "register_load_source", "unregister_load_source",
           "load_reports",
           "register_fleet_source", "unregister_fleet_source",
           "fleet_reports", "fleet_health_reports"]

_enabled = False
# Armed by profiler.Profiler while recording:
# fn(name, start_ns, end_ns, tid, attrs_dict_or_None).
_span_sink = None


def tracing_enabled() -> bool:
    return _enabled


def enable_tracing() -> None:
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def set_span_sink(fn) -> None:
    """Install (or clear, with None) the chrome-trace span sink."""
    global _span_sink
    _span_sink = fn


class Span:
    """One open span.  ``end()`` (or ``end_span``) closes it; attrs
    passed at end merge over the start attrs (e.g. the committed token
    count is only known when the request finishes)."""

    __slots__ = ("name", "attrs", "t0", "tid", "_open")

    def __init__(self, name: str, attrs: Optional[dict], tid=None):
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter_ns()
        self.tid = tid if tid is not None else threading.get_ident()
        self._open = True

    def set_attrs(self, /, **attrs):
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def end(self, /, **attrs):
        if not self._open:
            return
        self._open = False
        if attrs:
            self.set_attrs(**attrs)
        _emit(self.name, self.t0, time.perf_counter_ns(), self.tid,
              self.attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled — the
    disabled hot path is one flag check plus an attribute load."""

    __slots__ = ()

    def set_attrs(self, /, **attrs):
        pass

    def end(self, /, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NOOP = _NoopSpan()


def _emit(name, t0_ns, t1_ns, tid, attrs):
    sink = _span_sink
    if sink is not None:
        sink(name, t0_ns, t1_ns, tid, attrs)
    from . import flight as _flight
    # merge so the envelope keys win: a user attr named "name"/"dur_us"
    # must shadow, not TypeError, the traced hot path
    _flight.get_flight_recorder().record(
        "span", **{**(attrs or {}), "name": name,
                   "dur_us": (t1_ns - t0_ns) // 1000})


def start_span(name: str, /, _tid=None, **attrs):
    """Open a span; close it with :func:`end_span` (or ``.end()``).
    Returns a shared no-op when tracing is disabled — callers may hold
    and end it unconditionally.  ``name`` (like every span-API
    positional) is positional-only so an attr may share its name."""
    if not _enabled:
        return _NOOP
    return Span(name, attrs or None, tid=_tid)


def end_span(sp, /, **attrs) -> None:
    sp.end(**attrs)


def span(name: str, /, **attrs):
    """``with span("hapi.fit.superstep", step=i):`` — context-managed
    span for scopes that open and close on one frame."""
    if not _enabled:
        return _NOOP
    return Span(name, attrs or None)


def add_span(name: str, t0_ns: int, t1_ns: int, /, _tid=None,
             **attrs) -> None:
    """Emit an already-measured span (e.g. each slot's share of a device
    tick whose wall clock was timed for the tick histogram anyway).
    ``_tid`` overrides the chrome-trace lane — per-slot lanes keep one
    request's prefill/decode/verify spans on one row."""
    if not _enabled:
        return
    _emit(name, int(t0_ns), int(t1_ns),
          _tid if _tid is not None else threading.get_ident(), attrs or None)


# ---------------------------------------------------------------------------
# Liveness beacons (for /healthz)
# ---------------------------------------------------------------------------

_beacons: Dict[str, tuple] = {}   # name -> (last_beat_ts, owner_thread|None)


def heartbeat(name: str) -> None:
    """Mark ``name`` alive now.  One dict store — cheap enough for the
    serving engine to call every tick, always on.  The beating thread is
    recorded as the beacon's OWNER: :func:`beacon_ages` garbage-collects
    beacons whose owner thread has exited, so a worker that died without
    cleaning up does not sit in ``/healthz`` with an ever-growing age and
    false-trip a router health probe.  An activity that must alert by
    going stale after its thread dies (a crashed engine loop) pins
    itself first via :func:`pin_beacon`."""
    _beacons[name] = (time.time(), threading.current_thread())


def pin_beacon(name: str) -> None:
    """Detach ``name`` from its owner thread: the beacon survives the
    thread's exit and its age grows forever — exactly the ``?max_age``
    alert a CRASHED loop wants to leave behind (the serving engine's
    fail-all path pins before re-raising).  Keeps the last beat time;
    creates the beacon if it never beat."""
    rec = _beacons.get(name)
    _beacons[name] = (rec[0] if rec else time.time(), None)


def remove_beacon(name: str) -> None:
    """Forget a beacon.  A cleanly-stopped activity (engine shutdown,
    completed fit) must not 503 ``/healthz?max_age`` forever — and with
    engine churn the dict must not grow without bound.  A CRASHED
    activity keeps its beacon on purpose (see :func:`pin_beacon`):
    going stale is the alert."""
    _beacons.pop(name, None)


def beacon_ages() -> Dict[str, float]:
    """Seconds since each live beacon last beat.  Beacons whose owner
    thread has exited are dropped (and removed) here: a dead worker's
    frozen beat time would otherwise read as an ever-growing age and
    false-trip any ``?max_age`` probe — GC at the read keeps the write
    path one dict store.  Pinned beacons (owner None) never GC."""
    now = time.time()
    # dict(_beacons) snapshots atomically (single C-level op under the
    # GIL) — iterating the live dict would race an engine's first-tick
    # insert and 500 the /healthz probe
    out = {}
    for k, rec in sorted(dict(_beacons).items()):
        ts, owner = rec
        if owner is not None and not owner.is_alive():
            # drop only the record we judged: a concurrent re-beat (the
            # name re-used by a fresh thread) must not be evicted
            if _beacons.get(k) is rec:
                _beacons.pop(k, None)
            continue
        out[k] = now - ts
    return out


# ---------------------------------------------------------------------------
# Introspection sources (for /debug/requests)
# ---------------------------------------------------------------------------

_sources: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
# WeakValueDictionary iteration tolerates GC-driven removals (iteration
# guard) but a concurrent INSERT raises — serialize mutation vs snapshot
_sources_lock = make_lock("tracing.sources")


def register_introspection_source(name: str, obj) -> None:
    """Register a live object exposing ``introspect_requests() -> dict``
    (held weakly: a dropped engine vanishes from ``/debug/requests``
    without an unregister call)."""
    with _sources_lock:
        _sources[name] = obj


def unregister_introspection_source(name: str) -> None:
    with _sources_lock:
        _sources.pop(name, None)


def introspection_tables() -> dict:
    """``{name: source.introspect_requests()}`` over live sources; a
    source that fails mid-snapshot reports the error rather than taking
    the endpoint down."""
    with _sources_lock:
        items = sorted(_sources.items())
    out = {}
    # call outside the lock: a source's snapshot may take its own lock
    # (the engine does), and engines unregister while holding it —
    # calling under _sources_lock would be a lock-order inversion
    for name, obj in items:
        try:
            out[name] = obj.introspect_requests()
        except Exception as e:  # noqa: BLE001 — introspection must not throw
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


# ---------------------------------------------------------------------------
# Load/capacity report sources (for /load — the router contract)
# ---------------------------------------------------------------------------

_load_sources: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_load_sources_lock = make_lock("tracing.load_sources")


def register_load_source(name: str, obj) -> None:
    """Register a live object exposing ``load_report() -> dict`` (the
    serving engine's capacity/SLO document — docs/OBSERVABILITY.md,
    "SLO telemetry and the /load report").  Held weakly, like the
    introspection sources: a dropped engine vanishes from ``/load``."""
    with _load_sources_lock:
        _load_sources[name] = obj


def unregister_load_source(name: str) -> None:
    with _load_sources_lock:
        _load_sources.pop(name, None)


def load_reports() -> dict:
    """``{name: source.load_report()}`` over live sources — the body of
    the ``/load`` endpoint.  Snapshot-then-call, same lock discipline as
    :func:`introspection_tables`; a failing source reports its error
    instead of taking the router's poll down."""
    with _load_sources_lock:
        items = sorted(_load_sources.items())
    out = {}
    for name, obj in items:
        try:
            out[name] = obj.load_report()
        except Exception as e:  # noqa: BLE001 — the router poll must not die
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


# ---------------------------------------------------------------------------
# Fleet report sources (for /fleet and the fleet block of /healthz)
# ---------------------------------------------------------------------------

_fleet_sources: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()
_fleet_sources_lock = make_lock("tracing.fleet_sources")


def register_fleet_source(name: str, obj) -> None:
    """Register a live fleet router exposing ``load_report() -> dict``
    (the federated fleet document) and ``health_report() -> dict`` (the
    per-replica beacon digest).  Held weakly, same as the load sources:
    a dropped router vanishes from ``/fleet`` without unregister."""
    with _fleet_sources_lock:
        _fleet_sources[name] = obj


def unregister_fleet_source(name: str) -> None:
    with _fleet_sources_lock:
        _fleet_sources.pop(name, None)


def fleet_reports() -> dict:
    """``{fleet: router.load_report()}`` over live routers — the body of
    the ``/fleet`` endpoint.  Snapshot-then-call, same lock discipline
    as :func:`load_reports` (a router's report takes its own lock)."""
    with _fleet_sources_lock:
        items = sorted(_fleet_sources.items())
    out = {}
    for name, obj in items:
        try:
            out[name] = obj.load_report()
        except Exception as e:  # noqa: BLE001 — the fleet poll must not die
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def fleet_health_reports() -> dict:
    """``{fleet: router.health_report()}`` over live routers — the fleet
    block of ``/healthz`` (stalest replica named first in each)."""
    with _fleet_sources_lock:
        items = sorted(_fleet_sources.items())
    out = {}
    for name, obj in items:
        try:
            out[name] = obj.health_report()
        except Exception as e:  # noqa: BLE001 — a health probe must not die
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out
