"""Opt-in HTTP introspection server (stdlib-only, background thread).

The port's copy of the JAX package's ``observability/server.py``
(host-only), without ``/debug/programs``: the program observatory
(``programs.py``) waits for the CUDA-graph capture (ROADMAP Queue 1,
item 6's rest).

The third leg of the observability triad: metrics answer "how is the
fleet doing", spans answer "what happened to this request" — this
server is how an operator ASKS, with nothing but curl, while the
process is live:

    srv = start_introspection_server(9200)
    curl localhost:9200/metrics          # Prometheus exposition
    curl localhost:9200/healthz          # liveness beacons (tick/step age)
    curl localhost:9200/load             # machine-readable load/capacity
    curl localhost:9200/fleet            # federated fleet report(s)
    curl localhost:9200/debug/flight     # flight-recorder ring as JSON
    curl localhost:9200/debug/requests   # in-flight serving slot tables
    srv.stop()

``/load`` is the router contract (ROADMAP item 2): a VERSIONED JSON
capacity report per registered engine — slot/queue/page-pool headroom,
rolling TTFT/TPOT/e2e percentiles, goodput — the document a
least-loaded dispatcher polls (schema: docs/OBSERVABILITY.md, "SLO
telemetry and the /load report").

Opt-in by construction (nothing starts it implicitly), bound to
localhost by default, and pure stdlib ``http.server`` — no dependency
the container would have to grow.  Handlers read shared state through
the same snapshot paths tests use (``registry.expose_text()``,
``flight.dump()``, ``tracing.introspection_tables()``), so a scrape
never blocks the serving tick.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from . import flight as _flight
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["IntrospectionServer", "start_introspection_server"]


class _Handler(BaseHTTPRequestHandler):
    server_version = "pht-introspect/1"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, payload, code: int = 200):
        self._send(code, json.dumps(payload).encode(),
                   "application/json; charset=utf-8")

    def do_GET(self):  # noqa: N802 — http.server contract
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                text = self.server._registry.expose_text()
                self._send(200, text.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/healthz":
                self._healthz(url)
            elif url.path == "/load":
                # the router poll: one versioned envelope, one report
                # per live engine (tracing.load_reports snapshots then
                # calls, so a scrape never blocks the serving tick)
                self._send_json({"version": 1, "ts": time.time(),
                                 "engines": _tracing.load_reports()})
            elif url.path == "/fleet":
                # the fleet-tier federation: every live FleetRouter's
                # aggregated document — per-replica /load bodies with
                # staleness ages, dispatch percentiles, watchdog state
                # (docs/OBSERVABILITY.md, "Fleet telemetry")
                self._send_json({"version": 1, "ts": time.time(),
                                 "fleets": _tracing.fleet_reports()})
            elif url.path == "/debug/flight":
                self._send_json(_flight.get_flight_recorder().dump())
            elif url.path == "/debug/requests":
                self._send_json({"ts": time.time(),
                                 "sources": _tracing.introspection_tables()})
            else:
                self._send_json({"error": "not found",
                                 "endpoints": ["/metrics", "/healthz",
                                               "/load", "/fleet",
                                               "/debug/flight",
                                               "/debug/requests"]}, 404)
        except Exception as e:  # noqa: BLE001 — introspection must not die
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

    def _healthz(self, url):
        """Liveness: every registered beacon's age (serving engines beat
        per tick, the fit loop per telemetry sync).  ``?max_age=S``
        turns staleness into a 503 so a probe can alert on a wedged
        loop; without it the endpoint reports and leaves judgment to
        the caller (an idle drained engine stops ticking and is fine)."""
        ages = {k: round(v, 3) for k, v in _tracing.beacon_ages().items()}
        payload = {"ok": True, "ts": time.time(),
                   "uptime_s": round(time.time() - self.server._t_start, 3),
                   "beacons": ages}
        fleets = _tracing.fleet_health_reports()
        if fleets:
            # fleet tier: per-replica beacon ages aggregated per router
            # (stalest replica first), named watchdog degradations — a
            # wedged replica trips THIS one probe instead of N
            # per-replica ones.  Body-only: the top-level ok/503
            # judgment stays with ?max_age (the beacons above already
            # include every replica's) so existing probes keep their
            # exact semantics.
            payload["fleets"] = fleets
        # keep_blank_values: '?max_age=' (an unset template variable) must
        # hit the 400 below, not vanish from q and silently disable the
        # staleness alert the probe exists for
        q = parse_qs(url.query, keep_blank_values=True)
        if "max_age" in q:
            raw = q["max_age"][0]
            try:
                limit = float(raw)
            except (TypeError, ValueError):
                # a parse failure is the CALLER's malformed query — 400,
                # never the 500 an uncaught ValueError here produced
                limit = float("nan")
            if not math.isfinite(limit) or limit < 0:
                # NaN compares False against every age — a templated
                # probe expanding to 'nan' must not silently disable
                # the staleness alert it exists for; a negative limit
                # trips on EVERY beacon, which is a probe bug, not a
                # health signal
                self._send_json({"error": "max_age must be a finite "
                                          "number >= 0",
                                 "got": raw}, 400)
                return
            stale = {k: v for k, v in ages.items() if v > limit}
            if stale:
                # name the failing beacons explicitly (sorted, stalest
                # first) so an alert line can say WHICH worker wedged
                # without parsing the ages dict
                payload.update(ok=False, stale=stale,
                               stale_beacons=sorted(
                                   stale, key=stale.get, reverse=True))
                self._send_json(payload, 503)
                return
        self._send_json(payload)


class IntrospectionServer:
    """Running server handle: ``.port`` (resolved when ``port=0``),
    ``.url``, ``.stop()``."""

    def __init__(self, httpd: ThreadingHTTPServer, thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread
        self.host, self.port = httpd.server_address[:2]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self, timeout: float = 5.0) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout)
        self._httpd.server_close()


def start_introspection_server(
        port: int = 0, host: str = "127.0.0.1",
        registry: Optional[_metrics.MetricRegistry] = None
) -> IntrospectionServer:
    """Start the introspection server on a daemon thread and return its
    handle.  ``port=0`` binds an ephemeral port (read it back from
    ``.port`` — the test/dev default).  Serves the process-wide default
    registry unless ``registry`` overrides it."""
    httpd = ThreadingHTTPServer((host, int(port)), _Handler)
    httpd.daemon_threads = True
    httpd._registry = registry or _metrics.get_registry()
    httpd._t_start = time.time()
    thread = threading.Thread(target=httpd.serve_forever,
                              name="pht-introspection", daemon=True)
    thread.start()
    return IntrospectionServer(httpd, thread)
