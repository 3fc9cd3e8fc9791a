"""Deterministic fault-injection harness: named points, seeded schedules.

The port's copy of the JAX package's ``observability/faults.py``,
unchanged (host-only: it imports no JAX).

A crash-safety claim is only as good as the crashes it survives, so the
robustness layer ships with the tool that drills it: subsystems declare
named *fault points* (``faults.point("ckpt.shard_write")``) at the exact
places real failures strike — the checkpoint writer's shard/manifest
writes and commit rename, the elastic lease store's put/refresh, the
dataloader prefetch pull, the serving engine's tick loop — and a test
(or a chaos drill against a staging fleet) *arms* a schedule against any
of them.

Zero-cost contract (same as the PHT lock sanitizer,
``sanitizers.make_lock``): while nothing is armed, :func:`point` is ONE
dict probe against an empty dict — no lock, no branch tree, no import.
Production code can leave its points in permanently.

Arming — either source, same grammar:

- environment: ``PHT_FAULTS="<entry>[;<entry>...]"``, parsed once at
  module import (so a child process inherits its drill through the env,
  which is how the crash drill kills a fit mid-superstep);
- API: :func:`arm` with the same entry string, or the
  :func:`injected` context manager in tests.

Entry grammar (``docs/CHECKPOINTING.md`` has the howto)::

    entry   := name "=" kind [ "@" arg ] [ "," opt "=" val ... ]
    kind    := "fail"            raise InjectedFault on the @N-th hit
             | "crash"           os._exit(42) on the @N-th hit — the
                                 harness's kill -9: no atexit, no
                                 finally blocks, no flushed buffers
             | "delay"           sleep secs= on the @N-th hit, then pass
             | "prob"            every hit fires with probability @P,
                                 drawn from a random.Random(seed=) —
                                 the SAME seed replays the SAME
                                 fire/pass sequence
    opts    := seed=<int>        prob's RNG seed (default 0)
             | secs=<float>      delay duration (default 0.01)
             | flavor=fail|crash|delay   what a prob firing does
                                 (default fail)

Examples::

    PHT_FAULTS="ckpt.manifest_write=fail@2"
    PHT_FAULTS="io.prefetch=crash@7;elastic.refresh=prob@0.3,seed=11"

Every firing leaves a flight-recorder event (``kind="fault"``) so a
post-mortem distinguishes an injected failure from a real one.

Registered point names in-tree (grep ``faults.point`` for ground truth):
``ckpt.shard_write``, ``ckpt.manifest_write``, ``ckpt.commit``,
``elastic.put``, ``elastic.refresh``, ``io.prefetch``, ``serving.step``,
``serving.tick[<engine_id>]`` (per-replica — how a fleet drill kills ONE
engine of many in the same process), ``fleet.dispatch`` (per placement
attempt), ``fleet.load_probe[<replica>]`` (per capacity poll) and
``fleet.stale_health[<replica>]`` (inside the router's health gate — a
``fail`` firing reads as "this replica's beacon went stale").
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

from .sanitizers import make_lock

__all__ = ["InjectedFault", "FaultSpecError", "point", "arm", "arm_point",
           "disarm", "injected", "hits", "armed"]

_ENV = "PHT_FAULTS"
_CRASH_EXIT_CODE = 42

# name -> _Fault.  point() probes this dict DIRECTLY (no lock): arming /
# disarming happens at test-setup time, and dict get is GIL-atomic.
# While empty — the production steady state — a point() call is one
# failed dict probe.
_armed: Dict[str, "_Fault"] = {}


class InjectedFault(IOError):
    """The harness's default failure: an IOError look-alike, so code
    hardened against real I/O failures (retry loops, fallback paths)
    exercises the same except clauses under the drill."""


class FaultSpecError(ValueError):
    """A ``PHT_FAULTS`` / :func:`arm` entry did not parse."""


class _Fault:
    """One armed schedule. ``fire()`` is called on every hit of the
    point; the schedule decides whether this hit triggers."""

    __slots__ = ("name", "kind", "nth", "p", "secs", "flavor", "hits",
                 "fired", "_rng", "_lock")

    def __init__(self, name: str, kind: str, nth: int = 1, p: float = 0.0,
                 secs: float = 0.01, seed: int = 0, flavor: str = "fail"):
        if kind not in ("fail", "crash", "delay", "prob"):
            raise FaultSpecError(f"unknown fault kind {kind!r}")
        if flavor not in ("fail", "crash", "delay"):
            raise FaultSpecError(f"unknown fault flavor {flavor!r}")
        self.name = name
        self.kind = kind
        self.nth = int(nth)
        self.p = float(p)
        self.secs = float(secs)
        self.flavor = flavor if kind == "prob" else kind
        self.hits = 0
        self.fired = 0
        self._rng = random.Random(int(seed))
        # make_lock: every lock in the process must be visible to the
        # lock-order and race sanitizers (PHT009 sweep)
        self._lock = make_lock("faults.spec")

    def fire(self) -> None:
        with self._lock:
            self.hits += 1
            if self.kind == "prob":
                trigger = self._rng.random() < self.p
            else:
                # exactly the Nth hit (1-based): later hits pass, so a
                # retry loop around the point can be drilled to recover
                trigger = self.hits == self.nth
            if not trigger:
                return
            self.fired += 1
        self._trigger()

    def _trigger(self) -> None:
        # post-mortem breadcrumb: an injected failure must be
        # distinguishable from a real one in the flight dump
        from .flight import get_flight_recorder
        get_flight_recorder().record(
            "fault", point=self.name, flavor=self.flavor, hit=self.hits)
        if self.flavor == "delay":
            time.sleep(self.secs)
            return
        if self.flavor == "crash":
            # the kill -9 simulation: no exception, no cleanup, no
            # atexit — the process is simply gone, which is exactly the
            # torn-state premise atomic checkpointing must survive
            os._exit(_CRASH_EXIT_CODE)
        raise InjectedFault(
            f"injected fault at point {self.name!r} (hit {self.hits})")


def point(name: str) -> None:
    """Declare a hit of fault point ``name``.

    Disarmed (the production steady state) this is one probe of an
    empty dict — cheap enough for per-tick / per-batch paths."""
    f = _armed.get(name)
    if f is not None:
        f.fire()


def _parse_entry(entry: str) -> _Fault:
    entry = entry.strip()
    if "=" not in entry:
        raise FaultSpecError(f"fault entry {entry!r} has no '='")
    name, spec = entry.split("=", 1)
    parts = spec.split(",")
    head, opts = parts[0].strip(), parts[1:]
    if "@" in head:
        kind, arg = head.split("@", 1)
    else:
        kind, arg = head, None
    kw = {}
    kind = kind.strip()
    if kind == "prob":
        kw["p"] = float(arg) if arg is not None else 0.5
    elif arg is not None:
        kw["nth"] = int(arg)
    for o in opts:
        if "=" not in o:
            raise FaultSpecError(f"fault option {o!r} is not key=value")
        k, v = (s.strip() for s in o.split("=", 1))
        if k == "seed":
            kw["seed"] = int(v)
        elif k == "secs":
            kw["secs"] = float(v)
        elif k == "flavor":
            kw["flavor"] = v
        else:
            raise FaultSpecError(f"unknown fault option {k!r}")
    try:
        return _Fault(name.strip(), kind, **kw)
    except (TypeError, ValueError) as e:
        if isinstance(e, FaultSpecError):
            raise
        raise FaultSpecError(f"bad fault entry {entry!r}: {e}") from e


def arm(spec: str) -> None:
    """Arm one or more ``;``-separated entries (grammar: module doc).
    Parsing is all-or-nothing: a malformed entry raises
    :class:`FaultSpecError` and arms NOTHING — a partial arm would leave
    earlier entries live with no context manager ever disarming them."""
    parsed = [_parse_entry(e) for e in spec.split(";") if e.strip()]
    for f in parsed:
        _armed[f.name] = f


def arm_point(name: str, kind: str = "fail", **kw) -> None:
    """Programmatic :func:`arm` (kwargs: nth/p/secs/seed/flavor)."""
    _armed[name] = _Fault(name, kind, **kw)


def disarm(name: Optional[str] = None) -> None:
    """Disarm one point, or everything (``None``) — restoring the
    empty-dict zero-cost steady state."""
    if name is None:
        _armed.clear()
    else:
        _armed.pop(name, None)


def hits(name: str) -> int:
    """How many times an armed point was hit (0 if not armed)."""
    f = _armed.get(name)
    return f.hits if f is not None else 0


def armed(name: Optional[str] = None):
    """The armed :class:`_Fault` for ``name`` (None if disarmed), or —
    with no argument — the dict of all armed points (read-only use)."""
    if name is None:
        return dict(_armed)
    return _armed.get(name)


class injected:
    """Context manager for tests: arm on enter, disarm those points on
    exit (other armings are left alone)::

        with faults.injected("ckpt.shard_write=fail@1"):
            ...
    """

    def __init__(self, spec: str):
        self._spec = spec
        self._names = []

    def __enter__(self):
        arm(self._spec)
        # only the names THIS spec named are ours to clear
        self._names = [e.split("=", 1)[0].strip()
                       for e in self._spec.split(";") if e.strip()]
        return self

    def __exit__(self, *exc):
        for n in self._names:
            disarm(n)
        return False


# env arming happens once, at import: a child process spawned with
# PHT_FAULTS in its environment starts its drill armed before any
# subsystem constructs (the crash drill's delivery mechanism)
if os.environ.get(_ENV):
    arm(os.environ[_ENV])
