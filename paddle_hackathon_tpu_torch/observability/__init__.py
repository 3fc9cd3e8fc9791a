"""Runtime telemetry: the port of the JAX package's ``observability/``.

Host-only code, copied from the JAX package (it imports no JAX there
either), which the serving engine reports through:

- :class:`MetricRegistry` — process-wide, thread-safe registry of
  :class:`Counter` / :class:`Gauge` / :class:`Histogram` families with
  Prometheus-style labels and fixed log-spaced histogram buckets;
  ``registry.expose_text()`` (Prometheus text exposition),
  ``registry.snapshot()`` / :func:`snapshot_delta` (JSON) and
  :func:`set_trace_sink` (counter events onto a trace timeline).
- :func:`record_device_memory` — the CUDA caching allocator's bytes in
  use, peak and reserved, per device (nothing without a CUDA device).
- ``tracing`` — request/tick spans (default-off), liveness beacons and
  the introspection registries.
- ``flight`` — always-on bounded ring of recent structured events,
  dumped when ``ServingEngine.step`` escapes with an exception.
- ``server`` — opt-in stdlib HTTP introspection
  (:func:`start_introspection_server`: ``/metrics``, ``/healthz``,
  ``/load``, ``/fleet``, ``/debug/flight``, ``/debug/requests``).
- ``faults`` — deterministic fault injection (named points,
  ``PHT_FAULTS`` seeded schedules; zero-cost while disarmed).
- ``sanitizers`` — the lock-order checker (``PHT_LOCK_SANITIZER=1``),
  the data-race checker (``PHT_RACE_SANITIZER=1``) and
  :func:`forbid_host_transfers` over ``torch.Tensor``, whose one allowed
  fetch is :func:`device_get`.

Not ported yet: ``programs.py`` (the program observatory),
``instrument_jit`` and the donation sanitizer.  They count and guard
compiled programs and donated buffers, which the port gets with the
CUDA-graph capture (ROADMAP Queue 1, item 6's rest).
"""

from . import faults, flight, sanitizers, tracing
from .faults import InjectedFault
from .flight import FlightRecorder, get_flight_recorder
from .metrics import (Counter, Gauge, Histogram, MetricRegistry,
                      SlidingWindowHistogram, get_registry, log_buckets,
                      record_device_memory, set_trace_sink, snapshot_delta)
from .sanitizers import (DataRaceError, HostTransferError, LockOrderError,
                         device_get, forbid_host_transfers, make_lock,
                         make_rlock, race_sanitizer, share_object)
from .tracing import (add_span, disable_tracing, enable_tracing, end_span,
                      span, start_span, tracing_enabled)

__all__ = ["MetricRegistry", "Counter", "Gauge", "Histogram",
           "SlidingWindowHistogram",
           "get_registry", "log_buckets",
           "record_device_memory", "set_trace_sink", "snapshot_delta",
           "span", "start_span", "end_span", "add_span", "enable_tracing",
           "disable_tracing", "tracing_enabled", "FlightRecorder",
           "get_flight_recorder", "start_introspection_server",
           "forbid_host_transfers", "device_get", "make_lock", "make_rlock",
           "race_sanitizer", "share_object",
           "HostTransferError", "LockOrderError", "DataRaceError",
           "InjectedFault", "faults", "flight", "sanitizers", "tracing"]


def start_introspection_server(*args, **kwargs):
    """Lazy re-export of :func:`server.start_introspection_server` —
    the ``http.server`` import stays off the serving import path until
    someone actually starts the server."""
    from .server import start_introspection_server as _start
    return _start(*args, **kwargs)
