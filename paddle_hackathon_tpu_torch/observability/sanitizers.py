"""Runtime sanitizers: lock-order checking and host-transfer guarding.

The port's copy of the JAX package's ``observability/sanitizers.py``:
the lock-order and data-race sanitizers unchanged, the host-transfer
guard rebuilt over ``torch.Tensor``.  The donation sanitizer waits for
the CUDA-graph capture, where buffers are handed over as XLA donates
them (ROADMAP Queue 1, item 6's rest).

The static half of this defence lives in ``tools/pht_lint`` (PHT001
host-sync-in-hot-path, PHT003 lock-discipline).  Static analysis is
conservative — it can only see acquisition orders the AST spells out.
These sanitizers are the dynamic half: they watch what the process
*actually does* and fail fast, with stacks, at the first violation.

Three tools:

- :func:`make_lock` / :func:`make_rlock` — drop-in lock constructors the
  concurrent subsystems (serving engine, metric registry, tracing,
  flight recorder, dataloader) use instead of ``threading.Lock()``.
  Disabled (the default), they return the plain stdlib lock — zero
  added cost, not even a wrapper frame.  Enabled (``PHT_LOCK_SANITIZER=1``
  in the environment at lock creation, or under
  :func:`lock_sanitizer`), they return a :class:`_SanitizedLock` that
  records per-thread acquisition stacks, maintains a process-global
  lock-order graph, and raises :class:`LockOrderError` the moment any
  thread acquires two locks in an order that cycles against an order
  some thread (this one or another) has already used — i.e. it turns a
  once-in-a-blue-moon deadlock into a deterministic test failure with
  both acquisition stacks attached.

- :func:`forbid_host_transfers` — context manager hot-path tests wrap
  around steady-state decode ticks.  Inside it, an *implicit*
  device→host transfer of a ``torch.Tensor`` (``.item()``, ``.tolist()``,
  ``np.asarray`` through ``__array__``, ``bool()`` / ``float()`` /
  ``int()`` / ``__index__``) is a named :class:`HostTransferError`
  instead of a silent stall; the *explicit* fetch, :func:`device_get`,
  which every hot loop is designed around, stays allowed.  The methods
  are interposed on ``torch.Tensor`` itself, so tensors on every device
  are guarded, the CPU's included.

- :func:`share_object` / :func:`race_sanitizer` /
  ``PHT_RACE_SANITIZER=1`` — Eraser-style lockset checking over
  declared-shared objects (serving engine, metric registry, flight
  ring, dataloader prefetch state, TCPStore client): per attribute,
  the (thread, held-lockset) of every access is recorded — riding the
  lock sanitizer's per-thread bookkeeping — and a write/write or
  read/write pair with an EMPTY lockset intersection raises
  :class:`DataRaceError` carrying both access stacks and both
  locksets.  Static counterpart: pht-lint PHT009/PHT010.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import traceback
import weakref
from typing import Dict, List, Optional, Tuple


def _capture_stack(skip: int = 3):
    """Cheap stack capture for evidence: frame walk WITHOUT source-line
    reads (lookup_lines=False defers linecache to format time) — the
    stack is only ever rendered on an error path, so the steady-state
    sanitized acquire pays a tuple walk, not a traceback render.
    ``skip`` drops this helper + the sanitizer wrapper frames."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        f = sys._getframe(1)
    s = traceback.StackSummary.extract(
        traceback.walk_stack(f), limit=16, lookup_lines=False)
    s.reverse()             # oldest-first, like format_stack
    return s


def _fmt_stack(summary) -> str:
    return "".join(summary.format())

__all__ = ["LockOrderError", "HostTransferError", "DataRaceError",
           "make_lock", "make_rlock", "lock_sanitizer",
           "lock_sanitizer_enabled", "reset_lock_graph",
           "forbid_host_transfers", "device_get",
           "race_sanitizer", "race_sanitizer_enabled", "share_object",
           "reset_race_registry"]

_ENV_FLAG = "PHT_LOCK_SANITIZER"


class LockOrderError(RuntimeError):
    """Two locks were acquired in an order that cycles against an order
    already observed — a latent deadlock, reported deterministically."""


class DataRaceError(RuntimeError):
    """Two threads accessed the same declared-shared attribute (at least
    one a write) with NO common lock held — the Eraser lockset
    discipline, violated.  The message carries BOTH access stacks and
    the lockset each held."""


class HostTransferError(RuntimeError):
    """An implicit device→host transfer happened under
    :func:`forbid_host_transfers`."""


# ---------------------------------------------------------------------------
# lock-order sanitizer
# ---------------------------------------------------------------------------

_forced = 0                      # lock_sanitizer() nesting count
_graph_lock = threading.Lock()   # guards _edges (plain lock, never sanitized)
# (held_name, acquired_name) -> captured StackSummary of the first time
# this edge was taken (the evidence attached to a later cycle report;
# formatted only when a report actually fires)
_edges: Dict[Tuple[str, str], object] = {}
# thread ident -> [(lock, name, stack)].  A plain dict, NOT
# threading.local: stdlib Lock legally supports acquire-in-A /
# release-in-B (handoff pattern), and the releasing thread must be able
# to clear the OWNER's entry — per-key access is GIL-atomic.
_held_map: Dict[int, List] = {}


def lock_sanitizer_enabled() -> bool:
    """True when :func:`make_lock` should hand out instrumented locks.

    Checked at lock *creation* time: a lock built while the sanitizer is
    off stays a plain ``threading.Lock`` forever (that is the zero-cost
    contract), so enable the sanitizer *before* constructing the engine
    / registry / loader under test.

    The RACE sanitizer implies lock instrumentation: its per-access
    locksets ride the held-lock bookkeeping only instrumented locks
    maintain, so ``PHT_RACE_SANITIZER=1`` (or ``race_sanitizer()``)
    turns ``make_lock`` instrumentation on too."""
    return _forced > 0 or _race_forced > 0 \
        or os.environ.get(_ENV_FLAG, "") not in ("", "0") \
        or os.environ.get(_RACE_ENV, "") not in ("", "0")


@contextlib.contextmanager
def lock_sanitizer():
    """Force-enable :func:`make_lock` instrumentation for this block
    (test fixture path — no environment mutation, nests fine)."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def reset_lock_graph() -> None:
    """Drop every recorded edge AND held-stack entry (test isolation:
    one test's legitimate order must not veto another's opposite-but-
    unrelated order, and a lock leaked held by a failed test or dead
    thread must not phantom-poison a later thread that reuses the
    ident)."""
    with _graph_lock:
        _edges.clear()
        _held_map.clear()


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented iff the sanitizer is enabled
    at creation.  ``name`` identifies the lock in the order graph; locks
    sharing a name are one node (every ``ServingEngine._lock`` is
    ``"serving.engine"``), so cross-instance inversions count too."""
    if not lock_sanitizer_enabled():
        return threading.Lock()
    return _SanitizedLock(name, threading.Lock(), reentrant=False)


def make_rlock(name: str):
    """RLock variant of :func:`make_lock` (reentrant re-acquisition of
    the SAME instance records no edge and never errors)."""
    if not lock_sanitizer_enabled():
        return threading.RLock()
    return _SanitizedLock(name, threading.RLock(), reentrant=True)


def _held(ident: Optional[int] = None) -> List[Tuple[object, str, str]]:
    tid = threading.get_ident() if ident is None else ident
    h = _held_map.get(tid)
    if h is None:
        h = _held_map[tid] = []
    return h


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """Path src -> ... -> dst in the edge graph (caller holds _graph_lock)."""
    stack = [(src, [src])]
    seen = set()
    while stack:
        cur, path = stack.pop()
        if cur == dst:
            return path
        if cur in seen:
            continue
        seen.add(cur)
        for (a, b) in _edges:
            if a == cur:
                stack.append((b, path + [b]))
    return None


class _SanitizedLock:
    """Lock wrapper recording per-thread acquisition stacks and checking
    the global order graph on every nested acquisition.

    Works as the lock of a ``threading.Condition`` too — for the Lock
    AND the RLock variant: ``_release_save``/``_acquire_restore``/
    ``_is_owned`` delegate to the inner lock's own protocol (so a
    recursively-held RLock fully releases across ``wait()`` and its
    whole held-stack depth is restored on wake), and the ``_is_owned``
    probe goes straight to the inner lock, recording no order edges."""

    __slots__ = ("name", "_inner", "_reentrant", "_owners")

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant
        self._owners: List[int] = []   # thread idents, acquisition order

    # -- bookkeeping --------------------------------------------------------
    def _check_order(self, blocking: bool) -> None:
        held = _held()
        for lk, _, first_stk in held:
            if lk is self:
                if self._reentrant:
                    return        # same-instance RLock re-entry: no edge
                if blocking:
                    # any blocking acquire — timed or not — of a lock
                    # this thread already holds can only fail; raise
                    # instead of hanging (or burning the timeout)
                    raise LockOrderError(
                        f"lock `{self.name}` re-acquired by the thread "
                        f"already holding it (non-reentrant Lock) — "
                        f"this deadlocks\nfirst acquisition:\n"
                        f"{_fmt_stack(first_stk)}")
                return            # non-blocking try-acquire probe
        if not blocking:
            # try-acquire is the standard deadlock-AVOIDANCE pattern (it
            # backs off on failure, so reverse-order try-lock cannot
            # deadlock): neither cycle-checked nor recorded as order
            # evidence.  A later BLOCKING acquire while try-held locks
            # are in the held list still records its edges normally.
            return
        if not held:
            return
        # the stack is only captured when actually needed (a NEW edge
        # or an error): on the steady-state path — every edge already
        # known — a sanitized nested acquire costs one dict probe per
        # held lock, not a frame walk
        stack = None

        def _stk():
            nonlocal stack
            if stack is None:
                # _capture_stack <- _stk <- _check_order <- acquire
                stack = _capture_stack(skip=4)
            return stack

        with _graph_lock:
            for _, h_name, h_stk in held:
                if h_name == self.name:
                    # cite the MATCHED entry's stack — held[-1] may be
                    # a different, innocent lock acquired in between
                    raise LockOrderError(
                        f"lock `{self.name}` acquired while another "
                        f"instance of `{h_name}` is held — two threads "
                        f"nesting opposite instances deadlock\n"
                        f"holding:\n{_fmt_stack(h_stk)}\n"
                        f"acquiring:\n{_fmt_stack(_stk())}")
                edge = (h_name, self.name)
                if edge not in _edges:
                    back = _find_path(self.name, h_name)
                    if back is not None:
                        chain = " -> ".join(back)
                        raise LockOrderError(
                            f"lock-order cycle: this thread holds "
                            f"`{h_name}` and is acquiring `{self.name}`, "
                            f"but the order {chain} was already used"
                            f"\nreverse-order evidence (first "
                            f"{back[0]} -> {back[1]} site):\n"
                            f"{_fmt_stack(_edges[(back[0], back[1])])}"
                            f"\nthis acquisition:\n{_fmt_stack(_stk())}")
                    _edges[edge] = _stk()

    def _record(self) -> None:
        # _capture_stack <- _record <- acquire: evidence stays unformatted
        # until an error actually needs it
        stack = _capture_stack(skip=3)
        tid = threading.get_ident()
        _held(tid).append((self, self.name, stack))
        self._owners.append(tid)

    def _unrecord(self) -> None:
        """Clear the most recent OWNER's entry — which, for the stdlib
        handoff pattern, may live on a different thread's held list than
        the one calling release()."""
        if not self._owners:
            return
        tid = self._owners.pop()
        held = _held_map.get(tid)
        if held is None:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break
        # the emptied list is deliberately NOT popped from _held_map: a
        # cross-thread release racing the owner's concurrent _record
        # would orphan the list the owner is appending to, silently
        # hiding that hold.  An empty list per dead thread is the
        # (tiny, bounded-by-thread-count) price of correctness.

    # -- lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._check_order(bool(blocking))
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._record()
        return got

    def release(self):
        self._unrecord()
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- Condition protocol -------------------------------------------------
    # Condition prefers these over its acquire/release fallbacks; they
    # must fully release a (possibly recursive) hold across wait() and
    # restore the SAME held-stack depth on wake.
    def _release_save(self):
        held = _held()
        depth = sum(1 for lk, _, _ in held if lk is self)
        for _ in range(depth):
            self._unrecord()
        inner = self._inner
        if hasattr(inner, "_release_save"):
            state = inner._release_save()   # RLock: drops every level
        else:
            inner.release()
            state = None
        return (state, depth)

    def _acquire_restore(self, saved):
        state, depth = saved
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        for _ in range(max(depth, 1)):
            self._record()

    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # plain Lock: Condition's own probe semantics, against the
        # INNER lock directly — an ownership probe is not an
        # acquisition order event
        if inner.acquire(False):
            inner.release()
            return False
        return True


# ---------------------------------------------------------------------------
# host-transfer guard
# ---------------------------------------------------------------------------
#
# The implicit device→host conversions of a torch.Tensor: each one waits
# for the device and copies to the host behind the caller's back.  While
# a forbid_host_transfers() block is open they raise HostTransferError;
# the explicit fetch, device_get(), goes through none of them.  One
# dispatcher per method is installed while any block is open (blocks
# nest, and other threads see the guard too, as the reference's
# interposition on jaxlib's ArrayImpl did).

_patch_lock = threading.Lock()
_transfer_depth = 0          # forbid_host_transfers nesting
_installed_originals: Dict[str, object] = {}

_TRANSFER_NAMES = ("item", "tolist", "__array__", "__bool__", "__float__",
                   "__int__", "__index__")


def _dispatcher(name, orig):
    def dispatched(self, *a, **k):
        if _transfer_depth > 0:
            raise HostTransferError(
                f"implicit device→host transfer: `{name}` called on a "
                f"torch.Tensor under forbid_host_transfers() — fetch "
                f"once, explicitly, with observability.sanitizers."
                f"device_get(...) at the tick's designed sync point")
        return orig(self, *a, **k)

    dispatched.__name__ = getattr(orig, "__name__", name)
    return dispatched


def _guard_arm() -> None:
    global _transfer_depth
    import torch
    with _patch_lock:
        if _transfer_depth == 0:
            for n in _TRANSFER_NAMES:
                # the attribute as torch.Tensor resolves it (inherited
                # from the C base where Tensor does not define it)
                orig = getattr(torch.Tensor, n)
                _installed_originals[n] = torch.Tensor.__dict__.get(n)
                setattr(torch.Tensor, n, _dispatcher(n, orig))
        _transfer_depth += 1


def _guard_disarm() -> None:
    global _transfer_depth
    import torch
    with _patch_lock:
        _transfer_depth -= 1
        if _transfer_depth == 0:
            for n, orig in _installed_originals.items():
                if orig is None:
                    delattr(torch.Tensor, n)   # back to the C base's
                else:
                    setattr(torch.Tensor, n, orig)
            _installed_originals.clear()


def device_get(tree):
    """The explicit device→host fetch: the port's counterpart of
    ``jax.device_get``, and the one fetch :func:`forbid_host_transfers`
    allows.  Every ``torch.Tensor`` leaf of ``tree`` (a tensor, or
    nested lists / tuples / dicts of them) comes back as a numpy array;
    other leaves pass through.  The serving engine's tick and the
    drafters fetch their tokens through it, once a tick."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_get(t) for t in tree)
    if isinstance(tree, dict):
        return {k: device_get(v) for k, v in tree.items()}
    return tree


@contextlib.contextmanager
def forbid_host_transfers():
    """Fail loudly on any *implicit* device→host transfer in the block:
    ``item``, ``tolist``, ``__array__`` (``np.asarray``), ``__bool__``,
    ``__float__``, ``__int__`` and ``__index__`` on a ``torch.Tensor``
    raise :class:`HostTransferError`.

    :func:`device_get` (the explicit designed fetch) stays allowed — the
    point is to prove a steady-state tick performs its ONE designed sync
    and nothing else.  Host→device transfers are not restricted (tick
    inputs legitimately stream up).  The methods are guarded on tensors
    of every device, the CPU's included, as the reference's CPU mode
    does, so the CPU tests exercise the same guard the card runs."""
    _guard_arm()
    try:
        yield
    finally:
        _guard_disarm()


# ---------------------------------------------------------------------------
# data-race sanitizer (the dynamic half of pht-lint PHT009/PHT010)
# ---------------------------------------------------------------------------
#
# Eraser-style lockset checking over DECLARED-SHARED objects.  The
# concurrent subsystems (serving engine, metric registry, flight ring,
# dataloader prefetch state, TCPStore client) call
# ``share_object(self, label, atomic=(...))`` at the end of __init__:
#
# - Off (the default): ``share_object`` returns the object UNCHANGED —
#   not a wrapper, not a class swap, zero cost (the make_lock contract,
#   decided at declaration).
# - On (``PHT_RACE_SANITIZER=1`` at declaration, or under the
#   ``race_sanitizer()`` context in tests): the object's class is
#   swapped to a cached shim subclass whose ``__getattribute__``/
#   ``__setattr__`` record, per (object, attribute), the accessing
#   thread and the LOCKSET it held — riding the per-thread held-lock
#   bookkeeping the lock sanitizer already maintains (which is why the
#   race flag implies make_lock instrumentation).
#
# Per attribute the classic Eraser state machine runs: exclusive to the
# first thread (init writes are free), ONE silent ownership transfer
# (the engine's publish-then-hand-to-driver pattern), then shared —
# where the candidate lockset is intersected at every access and a
# write/write or read/write pair whose intersection is EMPTY raises
# :class:`DataRaceError` naming both access stacks and both locksets.
# ``atomic=`` names attributes exempted per the gil-atomic contract
# (single aligned read / single ``+=`` bump — the runtime mirror of the
# static ``# pht-lint: gil-atomic`` annotation).
#
# Granularity is the ATTRIBUTE BINDING: in-place container mutation
# (``self.d[k] = v``) reads the attribute, so the checker sees a read —
# rebinding races and scalar/flag races are caught, element races
# inside a shared dict are not (the static rules and the lock-order
# sanitizer carry those).

_RACE_ENV = "PHT_RACE_SANITIZER"
_race_forced = 0                 # race_sanitizer() nesting count
# RLock, deliberately: registrations hold weakrefs whose GC callback
# (_race_drop) re-acquires this lock to prune — an allocation inside a
# _race_access critical section can trigger that GC on the SAME
# thread, which would deadlock a plain Lock
_race_lock = threading.RLock()   # guards _race_table/_race_objects
# id(obj) -> (weakref-to-obj, label, frozenset(atomic), original class).
# WEAK refs: in env-flag mode the sanitizer is armed for the process
# lifetime, and per-epoch objects (a fresh dataloader _PrefetchIter
# every epoch) must not accumulate — the ref's GC callback prunes the
# object's registry and per-attribute entries.
_race_objects: Dict[int, Tuple[object, str, frozenset, type]] = {}
# (id(obj), attr) -> _RaceEntry
_race_table: Dict[Tuple[int, str], "_RaceEntry"] = {}
_race_env_armed = False
_shim_cache: Dict[type, type] = {}

# threading primitives living in instance dicts are synchronization
# OBJECTS, not shared data: accessing them lock-free is the discipline
_LOCKISH_TYPES = (type(threading.Lock()), type(threading.RLock()),
                  threading.Condition, threading.Event,
                  threading.Semaphore, threading.BoundedSemaphore)


def race_sanitizer_enabled() -> bool:
    """True when :func:`share_object` should instrument.  Checked at
    declaration time (the zero-cost-off contract): enable before
    constructing the objects under test."""
    return _race_forced > 0 or \
        os.environ.get(_RACE_ENV, "") not in ("", "0")


class _RaceEntry:
    __slots__ = ("owner", "state", "lockset", "last", "handoffs")
    # state: 0 exclusive / 1 shared (reads) / 2 shared-modified

    def __init__(self, owner):
        # owner is the THREAD OBJECT, compared by identity — raw
        # thread idents are recycled the moment a thread exits, so an
        # ident-keyed owner mistakes a brand-new thread for the
        # exclusive owner and silently skips the shared transition
        # (observed: the seeded-race tests passed standalone and went
        # quiet mid-suite, where ident reuse is routine).  The strong
        # ref pins the Thread object, making identity unambiguous.
        self.owner = owner
        self.state = 0
        self.lockset = None      # set of lock ids once shared
        self.last = None         # (thread, name, kind, lock_names,
        #                           lock_ids, stack)
        self.handoffs = 0


def _held_lockset():
    held = _held_map.get(threading.get_ident(), ())
    return (frozenset(id(lk) for lk, _, _ in held),
            tuple(nm for _, nm, _ in held))


def _race_drop(oid: int) -> None:
    """Weakref GC callback: a shared object died — prune its registry
    row and every per-attribute entry (env-flag mode runs for the
    process lifetime; per-epoch objects must not accumulate)."""
    with _race_lock:
        _race_objects.pop(oid, None)
        for key in [k for k in _race_table if k[0] == oid]:
            del _race_table[key]


def _race_access(obj, name, kind):
    rec = _race_objects.get(id(obj))
    if rec is None or rec[0]() is not obj or name in rec[2]:
        return
    lock_ids, lock_names = _held_lockset()
    me = threading.current_thread()
    # stack captured per access: it is the evidence a later conflicting
    # access reports — sanitizer-mode-only cost, lookup_lines deferred
    stack = _capture_stack(skip=3)
    acc = (me, me.name, kind, lock_names, lock_ids, stack)
    with _race_lock:
        ent = _race_table.get((id(obj), name))
        if ent is None:
            _race_table[(id(obj), name)] = ent = _RaceEntry(me)
            ent.last = acc
            return
        prev = ent.last
        ent.last = acc
        if ent.state == 0:
            if me is ent.owner:
                return
            if ent.handoffs == 0:
                # publish-then-hand-off (the init thread constructs,
                # ONE worker takes over): a single silent ownership
                # transfer, still exclusive — the single-driver engine
                # pattern would otherwise false-alarm on every attr
                ent.handoffs = 1
                ent.owner = me
                return
            # a third party (or the first thread returning): genuinely
            # shared — the candidate lockset starts as the intersection
            # of the two accesses that made it shared
            ent.lockset = set(prev[4] & lock_ids)
            ent.state = 2 if (kind == "write" or prev[2] == "write") else 1
        else:
            ent.lockset &= lock_ids
            if kind == "write":
                ent.state = 2
        if ent.state == 2 and not ent.lockset \
                and (kind == "write" or prev[2] == "write"):
            raise DataRaceError(_race_report(rec[1], name, prev, ent.last))


def _fmt_lockset(names) -> str:
    return "{" + ", ".join(sorted(names)) + "}" if names else "{} (none)"


def _race_report(label, name, a, b) -> str:
    def side(tag, acc):
        tid, tname, kind, lock_names, _ids, stack = acc
        return (f"{tag}: {kind} by thread {tname!r} holding "
                f"{_fmt_lockset(lock_names)}\n{_fmt_stack(stack)}")
    return (f"data race on `{label}.{name}`: two threads accessed it "
            f"(at least one write) with NO common lock held — the "
            f"lockset intersection is empty (Eraser discipline, "
            f"pht-lint PHT009)\n"
            f"{side('earlier access', a)}\n{side('this access', b)}\n"
            f"fix: guard every access with one lock (make_lock), or — "
            f"for a single GIL-atomic counter read/bump — declare the "
            f"attribute in share_object(atomic=...) and annotate the "
            f"static access `# pht-lint: gil-atomic`")


def _make_shim(cls: type) -> type:
    shim = _shim_cache.get(cls)
    if shim is not None:
        return shim

    def __getattribute__(self, name):
        if name[:2] != "__":
            try:
                d = object.__getattribute__(self, "__dict__")
            except AttributeError:      # __slots__-only object
                d = ()
            if name in d:
                _race_access(self, name, "read")
        return object.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if name[:2] != "__" and not isinstance(value, _LOCKISH_TYPES) \
                and not isinstance(value, _SanitizedLock):
            _race_access(self, name, "write")
        object.__setattr__(self, name, value)

    shim = type(f"_RaceShim_{cls.__name__}", (cls,), {
        "__getattribute__": __getattribute__,
        "__setattr__": __setattr__,
        "__module__": cls.__module__,
    })
    _shim_cache[cls] = shim
    return shim


def share_object(obj, label: str, atomic=()):
    """Declare ``obj`` shared-between-threads for the race sanitizer.

    Disabled (the default): returns ``obj`` unchanged — zero cost, not
    even a class swap.  Enabled: swaps in a shim subclass recording
    (thread, held-lockset) per attribute access and raising
    :class:`DataRaceError` on an empty-intersection write/write or
    read/write pair.  ``atomic`` names attributes exempt per the
    GIL-atomic contract (mirror of ``# pht-lint: gil-atomic``)."""
    if not race_sanitizer_enabled():
        return obj
    global _race_env_armed
    if _race_forced == 0:
        _race_env_armed = True    # env-flag mode: process-lifetime
    cls = type(obj)
    orig = cls
    if cls.__name__.startswith("_RaceShim_"):   # already shimmed
        return obj
    try:
        obj.__class__ = _make_shim(cls)
    except TypeError:
        # __slots__/extension classes can't swap: skip, stay plain
        return obj
    # skip attrs already holding locks at declaration (scan once)
    skip = set(atomic)
    for k, v in list(getattr(obj, "__dict__", {}).items()):
        if isinstance(v, _LOCKISH_TYPES) or isinstance(v, _SanitizedLock):
            skip.add(k)
    oid = id(obj)
    try:
        ref = weakref.ref(obj, lambda _r, oid=oid: _race_drop(oid))
    except TypeError:
        # un-weakref-able (slots without __weakref__): pin it — rare,
        # and none of the in-repo shared classes hit this
        ref = (lambda o=obj: o)
    with _race_lock:
        _race_objects[oid] = (ref, label, frozenset(skip), orig)
    return obj


def reset_race_registry() -> None:
    """Restore every (live) shared object's original class and drop all
    per-attribute state (test isolation; env-mode disarm for tests)."""
    with _race_lock:
        for ref, _, _, orig in list(_race_objects.values()):
            obj = ref()
            if obj is None:
                continue
            try:
                obj.__class__ = orig
            except TypeError:
                pass
        _race_objects.clear()
        _race_table.clear()


def _reset_race_sanitizer_for_tests() -> None:
    global _race_env_armed
    _race_env_armed = False
    reset_race_registry()


@contextlib.contextmanager
def race_sanitizer():
    """Force-enable :func:`share_object` (and, implicitly, make_lock
    instrumentation — the locksets ride the lock sanitizer's held-lock
    bookkeeping) for this block.  Construct the engine/loader/registry
    under test INSIDE the block; exiting restores every shared object's
    original class and clears the race state."""
    global _race_forced
    _race_forced += 1
    try:
        yield
    finally:
        _race_forced -= 1
        if _race_forced == 0 and not _race_env_armed:
            reset_race_registry()
