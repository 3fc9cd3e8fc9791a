"""Always-on flight recorder: a bounded ring of recent structured events.

The port's copy of the JAX package's ``observability/flight.py``,
unchanged (host-only: it imports no JAX).

When a serving loop or training run dies, the aggregate metrics say
*that* it died, a profiler trace exists only if someone was recording —
the flight recorder is the black box that is ALWAYS running: a
fixed-capacity ring buffer of recent events (request lifecycle marks,
tick summaries, finished spans, warnings) cheap enough to leave on in
production (one deque append per event; the ring never grows past
``capacity``).

``ServingEngine.step`` and ``Model.fit`` call :func:`crash_dump` when
they escape with an exception, writing the ring to
``$PHT_FLIGHT_DIR`` (default: the system temp dir) so every crash
leaves a post-mortem of what the process was doing in its final
moments — including the failing request's span history.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Optional

from .sanitizers import make_lock, share_object

__all__ = ["FlightRecorder", "get_flight_recorder", "crash_dump"]

DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Thread-safe bounded event ring.

    ``record(kind, **fields)`` appends one event; fields must be
    JSON-able scalars (ints/floats/strs) — the dump is written by a
    crash handler that must not discover unserializable payloads the
    moment everything is already going wrong."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = True
        self._buf = collections.deque(maxlen=int(capacity))
        self._lock = make_lock("flight.recorder")
        self._dropped = 0
        # every subsystem records into this ring from its own thread:
        # lockset-checked under the race sanitizer, untouched otherwise
        share_object(self, "flight.recorder")

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def record(self, kind: str, /, **fields) -> None:
        # kind is positional-only so a field literally named "kind" (or
        # any span attr) can never TypeError the hot recording path
        if not self.enabled:
            return
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append((time.time(), kind, fields))

    def events(self) -> list:
        """Chronological copy of the ring as JSON-able dicts.  The
        ``ts``/``kind`` envelope keys win over same-named fields —
        shadowed, not crashed."""
        with self._lock:
            buf = list(self._buf)
        return [{**fields, "ts": ts, "kind": kind}
                for ts, kind, fields in buf]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def dump(self) -> dict:
        """JSON-able snapshot: the events plus enough context (pid,
        capacity, how many older events the ring already evicted) to
        read the post-mortem cold.  ``ts``/``perf_ns`` sample both
        clocks at one instant so ``profiler.merge_traces`` can place
        the wall-clocked events on the perf_counter span timeline."""
        return {"ts": time.time(), "perf_ns": time.perf_counter_ns(),
                "pid": os.getpid(),
                "capacity": self.capacity, "dropped": self._dropped,
                "events": self.events()}

    def dump_to_file(self, path: Optional[str] = None) -> str:
        """Write :meth:`dump` as JSON; default path lands in
        ``$PHT_FLIGHT_DIR`` (or the system temp dir) with a pid+time
        stamped name.  Returns the path written."""
        if path is None:
            d = os.environ.get("PHT_FLIGHT_DIR", tempfile.gettempdir())
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{os.getpid()}_{int(time.time() * 1000)}.json")
        with open(path, "w") as f:
            json.dump(self.dump(), f)
        return path


_default_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder every built-in site records into."""
    return _default_recorder


def crash_dump(origin: str, exc: BaseException) -> Optional[str]:
    """Record the crash event and write the ring to a file; called from
    exception paths in ``ServingEngine.step`` / ``Model.fit``, so it
    must NEVER raise (a broken disk must not mask the real error).
    Returns the dump path, or None if writing failed."""
    rec = _default_recorder
    try:
        rec.record("crash", origin=origin, error=type(exc).__name__,
                   message=str(exc)[:500])
        path = rec.dump_to_file()
    except Exception:  # noqa: BLE001 — never mask the original failure
        return None
    import warnings
    try:
        warnings.warn(f"{origin} failed ({type(exc).__name__}); "
                      f"flight-recorder dump written to {path}",
                      stacklevel=2)
    except Exception:  # noqa: BLE001
        pass
    return path
