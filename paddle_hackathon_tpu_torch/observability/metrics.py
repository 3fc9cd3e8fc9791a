"""Process-wide metrics registry: Counter/Gauge/Histogram families.

The port's copy of the JAX package's ``observability/metrics.py``:
the registry, the metric types and the exporters unchanged;
:func:`record_device_memory` reads the CUDA caching allocator;
``instrument_jit`` waits for the CUDA-graph capture, which gives it
something to count (ROADMAP Queue 1, item 6's rest).

Design notes
------------
- A *family* is one metric name + type + help/unit; a *child* is one
  labelled time series inside it (``family.labels(mode="decode")``).
  Families with no labels still have exactly one child (the empty label
  set) and proxy ``inc``/``set``/``observe`` straight to it.
- Thread-safety: every child guards its scalars with one small lock
  (CPython `+=` is not atomic across bytecodes); the registry guards
  family/child creation.  Locks are leaves — nothing is called while one
  is held — so instrumented code may update metrics under its own locks.
- Near-zero cost when disabled: every hot-path method checks one plain
  attribute (``registry.enabled``) before touching a lock.
- Histograms use FIXED buckets chosen at family creation (default
  log-spaced, :func:`log_buckets`) — observation is a binary search +
  two adds, and two snapshots subtract bucket-by-bucket
  (:func:`snapshot_delta`), which per-request reservoirs cannot do.
- Chrome-trace integration: a module-level sink (armed by
  ``profiler.Profiler`` while recording) receives every counter/gauge
  update as ``(name, labels, value, t_ns)`` and lands them as
  ``"ph": "C"`` counter events on the span timeline.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

from .sanitizers import make_lock, share_object

__all__ = ["MetricRegistry", "Counter", "Gauge", "Histogram",
           "SlidingWindowHistogram", "get_registry",
           "log_buckets", "record_device_memory", "set_trace_sink",
           "snapshot_delta", "federate_text", "merged_percentiles"]


def log_buckets(lo: float = 1e-6, hi: float = 64.0, per_decade: int = 3):
    """Fixed log-spaced bucket upper bounds covering [lo, hi] — the
    latency scale from microseconds (a cache-hit tick dispatch) to the
    minute class (a cold XLA compile).  ``per_decade`` steps per 10x."""
    out = []
    e = 0
    while True:
        b = lo * 10.0 ** (e / per_decade)
        out.append(float(f"{b:.6g}"))  # stable, JSON-friendly bounds
        if b >= hi:
            return tuple(out)
        e += 1


DEFAULT_BUCKETS = log_buckets()
# acceptance-rate style histograms: a ratio in [0, 1]
RATIO_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))

# Armed by profiler.Profiler while recording (see profiler._start_record):
# fn(name, labels_tuple, value, t_ns).  Module-level so the check on the
# metric hot path is one global load.
_trace_sink = None


def set_trace_sink(fn) -> None:
    """Install (or clear, with None) the chrome-trace counter sink."""
    global _trace_sink
    _trace_sink = fn


def _quantile_from_counts(buckets, counts, total, vmax, q):
    """Approximate q-quantile from per-bucket counts — the standard
    Prometheus ``histogram_quantile`` interpolation, shared by
    :class:`Histogram` and :class:`SlidingWindowHistogram`.  The +Inf
    overflow bucket interpolates up to the OBSERVED max instead of
    clamping to ``buckets[-1]`` (a 300 s stall must not quantile as the
    top bound)."""
    if not total:
        return float("nan")
    top = max(vmax, buckets[-1])
    rank = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if acc + c >= rank and c:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else top
            # clamp to the observed max: an empirical quantile can
            # never exceed it, but in-bucket interpolation toward the
            # bucket's upper bound can (all samples below the bound)
            return min(lo + (hi - lo) * ((rank - acc) / c), vmax)
        acc += c
    return min(top, vmax)


class _Child:
    __slots__ = ("name", "labels", "_reg", "_lock")

    def __init__(self, name, labels, reg):
        self.name = name
        self.labels = labels            # sorted tuple of (key, value)
        self._reg = reg
        self._lock = make_lock("metrics.child")


class Counter(_Child):
    """Monotonically increasing count (Prometheus counter)."""

    __slots__ = ("_value",)

    def __init__(self, name, labels, reg):
        super().__init__(name, labels, reg)
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += v
            val = self._value
        sink = _trace_sink
        if sink is not None:
            sink(self.name, self.labels, val, time.perf_counter_ns())

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Child):
    """Point-in-time value (queue depth, occupancy, bytes in use)."""

    __slots__ = ("_value",)

    def __init__(self, name, labels, reg):
        super().__init__(name, labels, reg)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value = float(v)
        sink = _trace_sink
        if sink is not None:
            sink(self.name, self.labels, float(v), time.perf_counter_ns())

    def inc(self, v: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += v
            val = self._value
        sink = _trace_sink
        if sink is not None:
            sink(self.name, self.labels, val, time.perf_counter_ns())

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Child):
    """Fixed-bucket distribution (latencies, ratios).

    ``buckets`` are upper bounds; an implicit +Inf bucket catches the
    tail.  ``quantile(q)`` interpolates within the bucket that crosses
    the requested rank — the standard Prometheus ``histogram_quantile``
    estimate, good to bucket resolution.  The observed maximum is
    tracked exactly: the +Inf overflow bucket interpolates up to it
    instead of clamping to ``buckets[-1]`` (which silently under-reports
    any tail beyond the top bound — a 300 s compile stall must not
    quantile as 64 s)."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_max")

    def __init__(self, name, labels, reg, buckets=DEFAULT_BUCKETS):
        super().__init__(name, labels, reg)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        """Largest value observed (NaN before any observation)."""
        return self._max if self._count else float("nan")

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1) from bucket counts."""
        with self._lock:
            counts, total, vmax = list(self._counts), self._count, self._max
        return _quantile_from_counts(self.buckets, counts, total, vmax, q)


class SlidingWindowHistogram:
    """Fixed-bucket histogram over (approximately) the last
    ``window_s`` seconds — the rolling-percentile primitive behind the
    serving SLO report (``ServingEngine.load_report`` / the ``/load``
    endpoint): a router wants "p99 TTFT over the last minute", and a
    lifetime :class:`Histogram` can never forget a cold start.

    Design: a ring of ``slices`` sub-windows, each a plain bucket-count
    array stamped with its epoch (``now // slice_width``).  ``observe``
    is LOCK-FREE on the hot path — one clock read, one bisect, three
    list/scalar bumps (GIL-atomic enough for telemetry); the only lock
    is taken on the rare slice rotation (once per ``window_s/slices``
    seconds), where the stale sub-window is reset before reuse.  A
    concurrent observe racing a rotation can at worst misplace ONE
    sample — acceptable for latency percentiles, never used for
    billing-grade counts.

    Reads (:meth:`quantile` / :meth:`snapshot`) merge the non-expired
    sub-windows — O(slices x buckets), no per-observation state — and
    interpolate quantiles exactly like :class:`Histogram` (bucket
    resolution, +Inf tail up to the observed max).  The covered span is
    slice-granular: between ``window_s - slice_width`` and ``window_s``
    seconds of history, the standard rolling-window trade.

    NOT a registry family on purpose: windows are per-instance working
    state (one per engine-side series), carry no labels, and never grow
    the process-wide registry — the tentpole's "no per-request metric
    labels" rule.  ``clock`` is injectable for tests."""

    __slots__ = ("buckets", "window_s", "slices", "_slice_s", "_wins",
                 "_rot_lock", "_clock")

    def __init__(self, window_s: float = 60.0, slices: int = 6,
                 buckets=DEFAULT_BUCKETS, clock=time.monotonic):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if slices < 1:
            raise ValueError("slices must be >= 1")
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.window_s = float(window_s)
        self.slices = int(slices)
        self._slice_s = self.window_s / self.slices
        # [epoch, counts, count, sum, max] per sub-window; epoch -1 =
        # never used (matches no real epoch, so it reads as expired)
        self._wins = [[-1, [0] * (len(self.buckets) + 1), 0, 0.0,
                       float("-inf")] for _ in range(self.slices)]
        self._rot_lock = make_lock("metrics.swh")
        self._clock = clock

    def observe(self, v: float) -> None:
        epoch = int(self._clock() // self._slice_s)
        w = self._wins[epoch % self.slices]
        if w[0] != epoch:
            # rotation: reset the expired sub-window before claiming it
            # (the one lock, taken once per slice width)
            with self._rot_lock:
                if w[0] != epoch:
                    w[1] = [0] * (len(self.buckets) + 1)
                    w[2], w[3], w[4] = 0, 0.0, float("-inf")
                    w[0] = epoch
        i = bisect.bisect_left(self.buckets, v)
        w[1][i] += 1
        w[2] += 1
        w[3] += v
        if v > w[4]:
            w[4] = v

    def _merged(self):
        """(counts, total, sum, max) over the live sub-windows."""
        cur = int(self._clock() // self._slice_s)
        lo = cur - self.slices + 1
        counts = [0] * (len(self.buckets) + 1)
        s, vmax = 0.0, float("-inf")
        for w in self._wins:
            if lo <= w[0] <= cur:
                for j, c in enumerate(w[1]):
                    counts[j] += c
                s += w[3]
                vmax = max(vmax, w[4])
        # total from the merged counts, not the per-window counters, so
        # quantile ranks stay internally consistent under racy observes
        total = sum(counts)
        if total and vmax == float("-inf"):
            # a reader racing the FIRST observe of an otherwise-empty
            # window can see the count bump before the max update:
            # report empty for this read rather than leak -inf into
            # strict-JSON consumers (/load) — the next read sees both
            return [0] * len(counts), 0, 0.0, float("-inf")
        return counts, total, s, vmax

    @property
    def count(self) -> int:
        return self._merged()[1]

    @property
    def sum(self) -> float:
        return self._merged()[2]

    @property
    def max(self) -> float:
        counts, total, _, vmax = self._merged()
        return vmax if total else float("nan")

    def quantile(self, q: float) -> float:
        """q-quantile over the window (NaN when empty)."""
        counts, total, _, vmax = self._merged()
        return _quantile_from_counts(self.buckets, counts, total, vmax, q)

    def percentiles(self, qs=(0.5, 0.95, 0.99)):
        """JSON-safe rolling summary: ``{"count", "mean", "max",
        "p50", "p95", "p99"}`` — or None when the window is empty
        (None, not NaN: NaN is not valid JSON and a router must be able
        to tell "no traffic" from a number)."""
        counts, total, s, vmax = self._merged()
        if not total:
            return None
        out = {"count": total, "mean": s / total, "max": vmax}
        for q in qs:
            out[f"p{int(q * 100)}"] = _quantile_from_counts(
                self.buckets, counts, total, vmax, q)
        return out

    def snapshot(self) -> dict:
        """Window metadata + :meth:`percentiles` (``values`` None when
        empty)."""
        return {"window_s": self.window_s, "slices": self.slices,
                "values": self.percentiles()}


class _Family:
    """One metric name: type + help + the labelled children."""

    def __init__(self, name, kind, help, unit, reg, buckets=None):
        self.name = name
        self.kind = kind                # 'counter' | 'gauge' | 'histogram'
        self.help = help
        self.unit = unit
        self.buckets = buckets
        self._reg = reg
        self._children: Dict[Tuple, _Child] = {}
        self._lock = make_lock("metrics.family")

    def labels(self, **kv) -> _Child:
        key = tuple(sorted((k, str(v)) for k, v in kv.items()))
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "counter":
                    child = Counter(self.name, key, self._reg)
                elif self.kind == "gauge":
                    child = Gauge(self.name, key, self._reg)
                else:
                    child = Histogram(self.name, key, self._reg,
                                      self.buckets or DEFAULT_BUCKETS)
                self._children[key] = child
        return child

    def children(self) -> Iterable[_Child]:
        return list(self._children.values())

    # unlabeled convenience: family.inc() == family.labels().inc()
    def inc(self, v=1.0):
        self.labels().inc(v)

    def set(self, v):
        self.labels().set(v)

    def dec(self, v=1.0):
        self.labels().dec(v)

    def observe(self, v):
        self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value


class MetricRegistry:
    """Thread-safe registry of metric families.

    ``enabled=False`` (or :meth:`disable`) turns every update into one
    attribute check + return — instrumented hot paths keep their cost
    even when nobody is scraping."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._families: Dict[str, _Family] = {}
        self._lock = make_lock("metrics.registry")
        # scraped/updated from every subsystem's threads: declared
        # shared for the race sanitizer (zero cost when off).  atomic:
        # `enabled` is a single GIL-atomic flag read on every metric
        # update — the designed lock-free hot path (its writers,
        # enable()/disable(), are test/setup-time operations).
        share_object(self, "metrics.registry", atomic=("enabled",))

    # -- lifecycle ---------------------------------------------------------
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        """Drop every family (test isolation)."""
        with self._lock:
            self._families.clear()

    # -- family constructors ----------------------------------------------
    def _family(self, name, kind, help, unit, buckets=None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, kind, help, unit, self, buckets)
                    self._families[name] = fam
        # validate OUTSIDE the creation branch: the loser of a concurrent
        # first registration must get the same checks as a late caller
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}")
        if kind == "histogram" and buckets is not None:
            want = tuple(sorted(float(b) for b in buckets))
            have = tuple(sorted(float(b)
                                for b in (fam.buckets or DEFAULT_BUCKETS)))
            if want != have:
                # silently keeping the first-registered layout would land
                # later observations in the wrong buckets (a 0..1 ratio
                # collapses into ~3 log-spaced latency buckets)
                raise ValueError(
                    f"metric {name!r} already registered with different "
                    f"buckets")
        return fam

    def counter(self, name, help: str = "", unit: str = "") -> _Family:
        return self._family(name, "counter", help, unit)

    def gauge(self, name, help: str = "", unit: str = "") -> _Family:
        return self._family(name, "gauge", help, unit)

    def histogram(self, name, help: str = "", unit: str = "",
                  buckets=None) -> _Family:
        return self._family(name, "histogram", help, unit, buckets)

    def get(self, name) -> Optional[_Family]:
        return self._families.get(name)

    def drop_labels(self, **labels) -> int:
        """Remove every series whose labels include the given key/values
        (e.g. ``drop_labels(engine="e3")`` when an engine is torn down),
        returning how many were dropped.  Without this, per-instance
        labels would grow the process-wide registry forever under
        instance churn.  Handles already held keep working — the series
        just stops being exported/snapshotted."""
        want = {(k, str(v)) for k, v in labels.items()}
        dropped = 0
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            with fam._lock:
                dead = [key for key, c in fam._children.items()
                        if want <= set(c.labels)]
                for key in dead:
                    del fam._children[key]
                dropped += len(dead)
        return dropped

    def total(self, name, **label_filter) -> float:
        """Sum of all children of ``name`` whose labels match the filter
        (counters/gauges: values; histograms: observation counts)."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        want = {(k, str(v)) for k, v in label_filter.items()}
        out = 0.0
        for c in fam.children():
            if want <= set(c.labels):
                out += c.count if isinstance(c, Histogram) else c.value
        return out

    # -- exporters ---------------------------------------------------------
    @staticmethod
    def _fmt_labels(labels, extra=None) -> str:
        items = list(labels) + (extra or [])
        if not items:
            return ""
        def esc(v):
            return str(v).replace("\\", r"\\").replace('"', r'\"') \
                         .replace("\n", r"\n")
        return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"

    def expose_text(self, label_filter: Optional[dict] = None) -> str:
        """Prometheus text exposition format (version 0.0.4).

        ``label_filter`` keeps only series whose labels are a superset of
        the given ``{key: value}`` pairs (same subset semantics as
        :meth:`total`) — the per-replica slice a fleet router federates
        when replicas share one in-process registry.  Families with no
        surviving series are omitted entirely (no orphan HELP/TYPE)."""
        want = ({(k, str(v)) for k, v in label_filter.items()}
                if label_filter else None)
        lines = []
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            children = [c for c in fam.children()
                        if want is None or want <= set(c.labels)]
            if want is not None and not children:
                continue
            help = fam.help + (f" [{fam.unit}]" if fam.unit else "")
            if help:
                # HELP escaping per the text format: backslash and
                # line feed (label VALUES additionally escape the quote
                # — see _fmt_labels)
                help = help.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {fam.name} {help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for c in children:
                if isinstance(c, Histogram):
                    with c._lock:
                        counts = list(c._counts)
                        s, n = c._sum, c._count
                    acc = 0
                    for b, cnt in zip(c.buckets, counts):
                        acc += cnt
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{self._fmt_labels(c.labels, [('le', f'{b:g}')])}"
                            f" {acc}")
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{self._fmt_labels(c.labels, [('le', '+Inf')])} {n}")
                    lines.append(
                        f"{fam.name}_sum{self._fmt_labels(c.labels)} {s}")
                    lines.append(
                        f"{fam.name}_count{self._fmt_labels(c.labels)} {n}")
                else:
                    lines.append(
                        f"{fam.name}{self._fmt_labels(c.labels)} {c.value}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able point-in-time dump of every series.

        Counters/gauges: ``value``.  Histograms: ``count``/``sum``,
        per-bucket cumulative counts and approximate p50/p90/p99."""
        with self._lock:
            fams = list(self._families.values())
        out = {"ts": time.time(), "metrics": {}}
        for fam in fams:
            series = []
            for c in fam.children():
                entry = {"labels": dict(c.labels)}
                if isinstance(c, Histogram):
                    with c._lock:
                        counts = list(c._counts)
                        entry["sum"] = c._sum
                        entry["count"] = c._count
                        entry["max"] = c._max if c._count else None
                    cum, acc = {}, 0
                    for b, cnt in zip(c.buckets, counts):
                        acc += cnt
                        cum[f"{b:g}"] = acc
                    cum["+Inf"] = entry["count"]
                    entry["buckets"] = cum
                    for q in (0.5, 0.9, 0.99):
                        entry[f"p{int(q * 100)}"] = c.quantile(q)
                else:
                    entry["value"] = c.value
                series.append(entry)
            out["metrics"][fam.name] = {"type": fam.kind, "help": fam.help,
                                        "unit": fam.unit, "series": series}
        return out


def snapshot_delta(prev: dict, cur: dict) -> dict:
    """What happened BETWEEN two :meth:`MetricRegistry.snapshot` calls.

    Counters and histogram counts/sums/buckets subtract; gauges keep the
    current value (a gauge delta is rarely meaningful).  Series absent
    from ``prev`` are treated as zero."""
    def key(entry):
        return tuple(sorted(entry["labels"].items()))

    out = {"ts": cur.get("ts"), "ts_prev": prev.get("ts"), "metrics": {}}
    pm = prev.get("metrics", {})
    for name, fam in cur.get("metrics", {}).items():
        old = {key(e): e for e in pm.get(name, {}).get("series", [])}
        series = []
        for e in fam["series"]:
            o = old.get(key(e), {})
            d = {"labels": e["labels"]}
            if fam["type"] == "histogram":
                d["count"] = e["count"] - o.get("count", 0)
                d["sum"] = e["sum"] - o.get("sum", 0.0)
                d["max"] = e.get("max")   # all-time max (delta-max needs
                ob = o.get("buckets", {})  # per-window tracking it lacks)
                d["buckets"] = {b: v - ob.get(b, 0)
                                for b, v in e["buckets"].items()}
            elif fam["type"] == "counter":
                d["value"] = e["value"] - o.get("value", 0.0)
            else:
                d["value"] = e["value"]
            series.append(d)
        out["metrics"][name] = {"type": fam["type"],
                                "help": fam.get("help", ""),
                                "unit": fam.get("unit", ""),
                                "series": series}
    return out


def federate_text(parts: Dict[str, str], label: str = "replica") -> str:
    """Merge several Prometheus text expositions into one fleet scrape.

    ``parts`` maps an instance name (e.g. a replica's engine id) to that
    instance's ``expose_text()`` output.  Every sample line gains a
    ``<label>="<instance>"`` label (injected FIRST, so a replica's own
    labels stay intact after it), and repeated ``# HELP``/``# TYPE``
    headers for the same family collapse to the first occurrence — the
    merged text stays valid exposition format.  Pure text transform: it
    never touches the source registries, so replicas behind HTTP
    federate exactly the same way as in-process ones.

    Cardinality note: the injected label's values are the fleet's
    replica names — bounded by fleet size, never request-derived."""
    def esc(v):
        return str(v).replace("\\", r"\\").replace('"', r'\"') \
                     .replace("\n", r"\n")

    out = []
    seen_meta = set()
    for inst in sorted(parts):
        inj = f'{label}="{esc(inst)}"'
        for line in parts[inst].splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                # "# HELP <name> ..." / "# TYPE <name> <kind>" — dedupe
                # per (directive, family): N replicas of one build emit
                # identical headers
                bits = line.split(None, 3)
                key = tuple(bits[:3])
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                out.append(line)
                continue
            brace = line.find("{")
            space = line.find(" ")
            if brace != -1 and (space == -1 or brace < space):
                close = line.rfind("}")
                labels = line[brace + 1:close]
                out.append(line[:brace] + "{" + inj
                           + ("," + labels if labels else "")
                           + "}" + line[close + 1:])
            else:
                name, _, tail = line.partition(" ")
                out.append(f"{name}{{{inj}}} {tail}")
    return "\n".join(out) + ("\n" if out else "")


def merged_percentiles(windows, qs=(0.5, 0.95, 0.99)):
    """Fleet-merged rolling summary over several replicas'
    :class:`SlidingWindowHistogram` windows (same shape as
    :meth:`SlidingWindowHistogram.percentiles`; None when every window
    is empty).  Bucket counts add; the merged max is the max of the
    observed maxes — and because :func:`_quantile_from_counts` clamps
    interpolation to that max, a merged quantile can NEVER exceed the
    largest value any single replica actually observed.  Requires
    identical bucket bounds (all built-in SLO windows share the default
    log buckets)."""
    windows = [w for w in windows if w is not None]
    if not windows:
        return None
    buckets = windows[0].buckets
    for w in windows[1:]:
        if w.buckets != buckets:
            raise ValueError("merged_percentiles needs identical buckets")
    counts = [0] * (len(buckets) + 1)
    total, s, vmax = 0, 0.0, float("-inf")
    for w in windows:
        wc, wt, ws, wm = w._merged()
        if not wt:
            continue
        for j, c in enumerate(wc):
            counts[j] += c
        total += wt
        s += ws
        vmax = max(vmax, wm)
    if not total:
        return None
    out = {"count": total, "mean": s / total, "max": vmax}
    for q in qs:
        out[f"p{int(q * 100)}"] = _quantile_from_counts(
            buckets, counts, total, vmax, q)
    return out


# ---------------------------------------------------------------------------
# Default (process-wide) registry
# ---------------------------------------------------------------------------

_default_registry = MetricRegistry(enabled=True)


def get_registry() -> MetricRegistry:
    """The process-wide default registry every built-in instrumentation
    site records into."""
    return _default_registry


# ---------------------------------------------------------------------------
# Device health
# ---------------------------------------------------------------------------

def record_device_memory(registry: Optional[MetricRegistry] = None) -> None:
    """Sample device-memory gauges from the CUDA caching allocator, one
    child per CUDA device: ``device_memory_bytes_in_use``
    (``torch.cuda.memory_allocated``), ``device_memory_bytes_peak``
    (``max_memory_allocated``) and ``device_memory_bytes_reserved``
    (``memory_stats``' reserved bytes).  A process with no CUDA device
    records nothing, as the JAX package's version records nothing where
    its backend has no stats; every probe is guarded so a sampling
    failure never fails the training or serving loop."""
    reg = registry or get_registry()
    if not reg.enabled:
        return
    try:
        import torch
        if not torch.cuda.is_available():
            return
        for i in range(torch.cuda.device_count()):
            dev = str(i)
            reg.gauge("device_memory_bytes_in_use",
                      "CUDA caching-allocator bytes in use",
                      unit="B").labels(device=dev).set(
                torch.cuda.memory_allocated(i))
            reg.gauge("device_memory_bytes_peak",
                      "CUDA caching-allocator peak bytes in use",
                      unit="B").labels(device=dev).set(
                torch.cuda.max_memory_allocated(i))
            reserved = torch.cuda.memory_stats(i).get(
                "reserved_bytes.all.current")
            if reserved is not None:
                reg.gauge("device_memory_bytes_reserved",
                          "CUDA caching-allocator bytes reserved",
                          unit="B").labels(device=dev).set(reserved)
    except Exception:  # noqa: BLE001 -- telemetry must not fail the loop
        pass
