"""ctypes bindings for the native host runtime (``native/runtime.cc``).

The port's copy of the JAX package's ``core/native.py``: the same C ABI
and the same Python wrappers over it.  ``runtime.cc`` is built with
``g++`` at first use into ``paddle_hackathon_tpu_torch/_build/``; the
library's name carries a hash of the source, so an edited source
rebuilds.  The runtime is host code: the staging ring the DataLoader
copies batches through (:class:`StagingRing`), the dependency-counted
:class:`WorkQueue`, the host allocator (:class:`HostAllocation`,
:func:`memory_stats`), the native trace and the flag registry.  Its TCP
store server and client are in the library too; the Python store over
them (``parallel/store.py``) is ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

from ..observability.sanitizers import make_lock

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "runtime.cc"
_BUILD_DIR = _PKG / "_build"

_lib = None
_lib_failed = False
_lib_lock = make_lock("core.native_build")
_TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int32)


def _build() -> Path:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"libpht_runtime_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.tmp%d" % os.getpid())
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-fvisibility=hidden", str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native runtime; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        try:
            path = _build()
            lib = ctypes.CDLL(str(path))
        except Exception:
            _lib_failed = True  # remember; don't re-run g++ on every call
            return None
        _declare(lib)
        _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.pht_flag_set.argtypes = [c.c_char_p, c.c_char_p]
    lib.pht_flag_get.argtypes = [c.c_char_p, c.c_char_p, c.c_int32]
    lib.pht_flag_get.restype = c.c_int32
    lib.pht_alloc.argtypes = [c.c_uint64]
    lib.pht_alloc.restype = c.c_void_p
    lib.pht_free.argtypes = [c.c_void_p]
    lib.pht_mem_stat.argtypes = [c.c_int32]
    lib.pht_mem_stat.restype = c.c_int64
    lib.pht_mem_reset_peak.argtypes = []
    lib.pht_trace_enable.argtypes = [c.c_int32]
    lib.pht_trace_push.argtypes = [c.c_char_p]
    lib.pht_trace_pop.argtypes = []
    lib.pht_trace_record.argtypes = [c.c_char_p, c.c_int64, c.c_int64]
    lib.pht_trace_count.restype = c.c_int64
    lib.pht_trace_dump_chrome.argtypes = [c.c_char_p, c.c_int64]
    lib.pht_trace_dump_chrome.restype = c.c_int64
    lib.pht_wq_create.argtypes = [c.c_int32]
    lib.pht_wq_create.restype = c.c_void_p
    lib.pht_wq_destroy.argtypes = [c.c_void_p]
    lib.pht_wq_run_dag.argtypes = [c.c_void_p, c.c_int32, _TASK_FN,
                                   c.c_void_p, c.POINTER(c.c_int32),
                                   c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                                   c.c_int32]
    lib.pht_store_server_start.argtypes = [c.c_int32]
    lib.pht_store_server_start.restype = c.c_void_p
    lib.pht_store_server_port.argtypes = [c.c_void_p]
    lib.pht_store_server_port.restype = c.c_int32
    lib.pht_store_server_stop.argtypes = [c.c_void_p]
    lib.pht_store_connect.argtypes = [c.c_char_p, c.c_int32, c.c_int32]
    lib.pht_store_connect.restype = c.c_void_p
    lib.pht_store_disconnect.argtypes = [c.c_void_p]
    lib.pht_store_set.argtypes = [c.c_void_p, c.c_char_p,
                                  c.POINTER(c.c_uint8), c.c_int32]
    lib.pht_store_set.restype = c.c_int32
    lib.pht_store_get.argtypes = [c.c_void_p, c.c_char_p,
                                  c.POINTER(c.c_uint8), c.c_int32, c.c_int64]
    lib.pht_store_get.restype = c.c_int32
    lib.pht_store_add.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.pht_store_add.restype = c.c_int64
    lib.pht_reader_create.argtypes = [c.c_int32, c.c_int64]
    lib.pht_reader_create.restype = c.c_void_p
    lib.pht_reader_stage.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                     c.c_int64]
    lib.pht_reader_stage.restype = c.c_int32
    lib.pht_reader_next.argtypes = [c.c_void_p, c.POINTER(c.c_void_p),
                                    c.POINTER(c.c_int64), c.c_int64]
    lib.pht_reader_next.restype = c.c_int32
    lib.pht_reader_release.argtypes = [c.c_void_p, c.c_int32]
    lib.pht_reader_close.argtypes = [c.c_void_p]
    lib.pht_reader_destroy.argtypes = [c.c_void_p]
    lib.pht_store_check.argtypes = [c.c_void_p, c.c_char_p]
    lib.pht_store_check.restype = c.c_int32
    lib.pht_store_delete.argtypes = [c.c_void_p, c.c_char_p]
    lib.pht_store_delete.restype = c.c_int32


# ---------------------------------------------------------------------------
# Memory (host staging allocator; ref memory/stats.h DEVICE_MEMORY_STAT_*)
# ---------------------------------------------------------------------------

class HostAllocation:
    """An aligned host buffer from the native auto-growth best-fit
    allocator (pageable: ``torch.cuda.cudart().cudaHostRegister`` page-locks
    it where a caller copies from it to the card)."""

    def __init__(self, nbytes: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self.nbytes = nbytes
        self.ptr = lib.pht_alloc(nbytes)
        if not self.ptr:
            raise MemoryError(f"pht_alloc({nbytes}) failed")

    def as_numpy(self, dtype, shape):
        import numpy as np
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if n > self.nbytes:
            raise ValueError("buffer too small")
        buf = (ctypes.c_char * self.nbytes).from_address(self.ptr)
        buf._owner = self  # keep the allocation alive through the view chain
        return np.frombuffer(buf, dtype=dtype,
                             count=int(np.prod(shape))).reshape(shape)

    def free(self):
        if self.ptr:
            self._lib.pht_free(self.ptr)
            self.ptr = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


def memory_stats() -> dict:
    """Host allocator counters (ref ``memory/stats.h:112`` peak/current)."""
    lib = load()
    if lib is None:
        return {}
    return {
        "current_in_use": lib.pht_mem_stat(0),
        "peak_in_use": lib.pht_mem_stat(1),
        "reserved": lib.pht_mem_stat(2),
        "alloc_count": lib.pht_mem_stat(3),
        "free_count": lib.pht_mem_stat(4),
    }


def reset_peak_memory_stats() -> None:
    lib = load()
    if lib is not None:
        lib.pht_mem_reset_peak()


# ---------------------------------------------------------------------------
# WorkQueue (ref new_executor dependency-counted scheduling)
# ---------------------------------------------------------------------------

class WorkQueue:
    """Dependency-counted DAG executor over a native thread pool (the
    standalone executor's instruction scheduler, ``interpretercore.cc:653``
    ``ExecuteInstructionList`` with ``RunNextInstructions:710``): tasks
    become ready when their predecessor count reaches zero; worker threads
    drain the ready queue concurrently.  Host-side work only.
    """

    def __init__(self, num_threads: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._wq = lib.pht_wq_create(num_threads)

    def run_dag(self, tasks: Sequence, successors: Sequence[Sequence[int]],
                trace: bool = False):
        """Run callables honouring the DAG: ``successors[i]`` lists task
        indices that depend on task i. Blocks until all tasks ran."""
        n = len(tasks)
        if n == 0:
            return
        if len(successors) != n:
            raise ValueError("successors must have one entry per task")
        dep = [0] * n
        for succs in successors:
            for s in succs:
                dep[s] += 1
        adj, off = [], [0]
        for succs in successors:
            adj.extend(succs)
            off.append(len(adj))
        errors = []

        def runner(_arg, idx):
            try:
                tasks[idx]()
            except BaseException as e:  # propagate after the run
                errors.append((idx, e))

        cb = _TASK_FN(runner)
        c_dep = (ctypes.c_int32 * n)(*dep)
        c_adj = (ctypes.c_int32 * max(len(adj), 1))(*(adj or [0]))
        c_off = (ctypes.c_int32 * (n + 1))(*off)
        self._lib.pht_wq_run_dag(self._wq, n, cb, None, c_dep, c_adj, c_off,
                                 1 if trace else 0)
        if errors:
            idx, err = errors[0]
            raise RuntimeError(f"workqueue task {idx} failed: {err!r}") from err

    def map(self, fn, items, trace: bool = False):
        """Independent-task convenience: run fn over items concurrently."""
        out = [None] * len(items)

        def make(i):
            def task():
                out[i] = fn(items[i])
            return task

        self.run_dag([make(i) for i in range(len(items))],
                     [[] for _ in items], trace=trace)
        return out

    def close(self):
        if self._wq:
            self._lib.pht_wq_destroy(self._wq)
            self._wq = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Native host tracer (ref platform/profiler host_event_recorder.h)
# ---------------------------------------------------------------------------

def trace_enable(on: bool = True) -> None:
    lib = load()
    if lib is not None:
        lib.pht_trace_enable(1 if on else 0)


def trace_push(name: str) -> None:
    lib = load()
    if lib is not None:
        lib.pht_trace_push(name.encode())


def trace_pop() -> None:
    lib = load()
    if lib is not None:
        lib.pht_trace_pop()


def trace_count() -> int:
    lib = load()
    return int(lib.pht_trace_count()) if lib is not None else 0


def trace_clear() -> None:
    lib = load()
    if lib is not None:
        lib.pht_trace_clear()


def trace_dump_chrome(path: str, pid: Optional[int] = None) -> int:
    """Dump native events as chrome://tracing JSON (ref
    ``chrometracing_logger.cc``); returns event count."""
    lib = load()
    if lib is None:
        return 0
    return int(lib.pht_trace_dump_chrome(path.encode(),
                                         pid if pid is not None else os.getpid()))


def sync_flags(flags: dict) -> None:
    """Mirror Python-side flags into the native registry so C++ components
    observe them (ref global_value_getter_setter.cc round-trip)."""
    lib = load()
    if lib is None:
        return
    for k, v in flags.items():
        lib.pht_flag_set(str(k).encode(), str(v).encode())


def flag_get(name: str) -> Optional[str]:
    lib = load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(4096)
    n = lib.pht_flag_get(name.encode(), buf, 4096)
    if n < 0:
        return None
    return buf.value.decode()


class StagingRing:
    """Native staging ring for DataLoader batches (ref buffered_reader.cc).

    Producer threads call :meth:`stage` (the batch memcpy runs in C++ with
    the GIL released); the consumer pops in sequence order with
    :meth:`next` and returns slots via :meth:`release`.  A slot's buffer
    holds ``slot_bytes`` at a fixed address while the blocks staged into
    it fit (a larger block moves it): the address :meth:`next` returns for
    a slot is the same each time.  A consumer that reads a slot after
    :meth:`release` (an asynchronous copy still in flight) reads whatever
    the stager wrote there next.
    """

    def __init__(self, n_slots: int = 4, slot_bytes: int = 1 << 20):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self.n_slots = max(int(n_slots), 2)
        self.slot_bytes = int(slot_bytes)
        self._ring = lib.pht_reader_create(n_slots, slot_bytes)

    def stage(self, array, seq: int) -> int:
        import numpy as np
        a = np.ascontiguousarray(array)
        return self._lib.pht_reader_stage(
            self._ring, a.ctypes.data_as(ctypes.c_void_p), a.nbytes, seq)

    def next(self, dtype, shape, timeout_ms: int = 60000):
        """Pop the next staged block viewed as (dtype, shape) numpy array.
        Returns (slot, array-copy-free-view) or (None, None) when drained;
        raises ``TimeoutError`` after ``timeout_ms``."""
        import numpy as np
        ptr = ctypes.c_void_p()
        nbytes = ctypes.c_int64()
        slot = self._lib.pht_reader_next(self._ring, ctypes.byref(ptr),
                                         ctypes.byref(nbytes), timeout_ms)
        if slot == -1:
            raise TimeoutError("staging ring timed out")
        if slot == -2:
            return None, None
        n = nbytes.value
        buf = (ctypes.c_char * n).from_address(ptr.value)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        return slot, arr

    def release(self, slot: int) -> None:
        self._lib.pht_reader_release(self._ring, slot)

    def close(self) -> None:
        if getattr(self, "_ring", None):
            self._lib.pht_reader_close(self._ring)

    def __del__(self):
        try:
            self.close()
            if getattr(self, "_ring", None):
                self._lib.pht_reader_destroy(self._ring)
                self._ring = None
        except Exception:
            pass
