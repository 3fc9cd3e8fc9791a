"""The port's native host runtime (``native/runtime.cc`` built with g++ by
``core/native.py``) against the JAX package's build of its own copy: each
scenario runs through both packages' bindings and must give the same
result (the staging ring's order and slot contract, the work queue's DAG,
the host allocator's counters, the flag registry, the native trace and its
chrome dump).  The port's library lands in ``paddle_hackathon_tpu_torch/
_build/`` under a name carrying a hash of its source."""

import hashlib
import json
import threading

import numpy as np
import pytest

from paddle_hackathon_tpu.core import native as jnative
from paddle_hackathon_tpu_torch.core import native as tnative

SIDES = [jnative, tnative]


def test_builds_with_gxx_into_the_ports_build_dir():
    assert tnative.available()
    lib = tnative.load()
    src = tnative._SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    path = tnative._BUILD_DIR / f"libpht_runtime_{tag}.so"
    assert path.exists() and lib._name == str(path)
    assert tnative._BUILD_DIR.name == "_build"
    assert tnative._BUILD_DIR.parent.name == "paddle_hackathon_tpu_torch"
    # the same C ABI as the JAX package's runtime
    for sym in ("pht_reader_create", "pht_reader_stage", "pht_reader_next",
                "pht_reader_release", "pht_wq_run_dag", "pht_alloc",
                "pht_mem_stat", "pht_trace_dump_chrome", "pht_flag_set",
                "pht_store_server_start", "pht_store_connect"):
        assert hasattr(lib, sym), sym


def _ring_order(native):
    """Out-of-order producers; the consumer sees strict seq order, and a
    slot's address is the same each time it comes round."""
    ring = native.StagingRing(n_slots=4, slot_bytes=256)
    order = [3, 1, 0, 2, 5, 4, 7, 6]

    def produce(seq):
        ring.stage(np.full(8, seq, np.int32), seq)

    threads = [threading.Thread(target=produce, args=(s,)) for s in order]
    for t in threads:
        t.start()
    seen, addr = [], {}
    for _ in order:
        slot, arr = ring.next(np.int32, (8,))
        seen.append(int(arr[0]))
        assert addr.setdefault(slot, arr.ctypes.data) == arr.ctypes.data
        ring.release(slot)
    for t in threads:
        t.join()
    ring.close()
    drained = ring.next(np.int32, (8,))
    return seen, drained


def _ring_release_contract(native):
    """A slot stays out of the free list until released: with every slot
    held the stager blocks, and one release lets exactly one block in;
    a slot read after its release holds the next block's bytes."""
    ring = native.StagingRing(n_slots=2, slot_bytes=64)
    for s in range(2):
        ring.stage(np.full(4, s, np.int64), s)
    s0, a0 = ring.next(np.int64, (4,))
    s1, a1 = ring.next(np.int64, (4,))
    done = threading.Event()

    def stage_third():
        ring.stage(np.full(4, 2, np.int64), 2)
        done.set()

    t = threading.Thread(target=stage_third)
    t.start()
    blocked = not done.wait(0.3)
    ring.release(s0)
    t.join(5)
    unblocked = done.is_set()
    stale = int(a0[0])          # the released slot now holds block 2
    s2, a2 = ring.next(np.int64, (4,))
    out = (blocked, unblocked, s2 == s0, stale, int(a1[0]), int(a2[0]))
    ring.release(s1)
    ring.release(s2)
    ring.close()
    return out


def _timeout(native):
    ring = native.StagingRing(n_slots=2, slot_bytes=64)
    try:
        ring.next(np.int32, (1,), timeout_ms=50)
    except TimeoutError:
        return "timeout"
    finally:
        ring.close()
    return "no timeout"


def _dag(native):
    """A diamond and a chain: every task runs after its predecessors."""
    wq = native.WorkQueue(4)
    log, lock = [], threading.Lock()

    def task(i):
        def run():
            with lock:
                log.append(i)
        return run

    succ = [[1, 2], [3], [3], [4], []]
    wq.run_dag([task(i) for i in range(5)], succ)
    pos = {t: k for k, t in enumerate(log)}
    ok = all(pos[a] < pos[b] for a, bs in enumerate(succ) for b in bs)
    mapped = wq.map(lambda x: x * x, list(range(16)))
    try:
        wq.run_dag([lambda: None, lambda: 1 / 0], [[1], []])
        err = None
    except RuntimeError as e:
        err = str(e).split(":")[0]
    wq.close()
    return sorted(log), ok, mapped, err


def _alloc(native):
    before = native.memory_stats()
    a = native.HostAllocation(1 << 16)
    mid = native.memory_stats()
    arr = a.as_numpy(np.float32, (128,))
    arr[:] = np.arange(128)
    total = float(arr.sum())
    a.free()
    after = native.memory_stats()
    return ({k: mid[k] - before[k] for k in before},
            {k: after[k] - mid[k] for k in before if k != "reserved"}, total)


def _flags(native):
    native.sync_flags({"check_nan_inf": "True", "custom": "42"})
    return (native.flag_get("check_nan_inf"), native.flag_get("custom"),
            native.flag_get("missing_flag"))


def _trace(native, tmp_path):
    native.trace_clear()
    native.trace_enable(True)
    native.trace_push("outer")
    native.trace_push('inner "q"\\x')
    native.trace_pop()
    native.trace_pop()
    native.trace_enable(False)
    count = native.trace_count()
    path = str(tmp_path / f"{native.__name__}.json")
    n = native.trace_dump_chrome(path, pid=7)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    native.trace_clear()
    return count, n, sorted((e["name"], e["ph"], e["pid"]) for e in events)


_SCENARIOS = {"ring_order": _ring_order,
              "ring_release_contract": _ring_release_contract,
              "ring_timeout": _timeout, "workqueue_dag": _dag,
              "host_allocation": _alloc, "flags": _flags}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_bindings_match_jax(name):
    want, got = (_SCENARIOS[name](n) for n in SIDES)
    assert got == want
    if name == "ring_order":
        assert got[0] == list(range(8)) and got[1] == (None, None)
    if name == "ring_release_contract":
        assert got == (True, True, True, 2, 1, 2)


def test_trace_dump_matches_jax(tmp_path):
    want, got = (_trace(n, tmp_path) for n in SIDES)
    assert got == want and got[0] == got[1] == 2
