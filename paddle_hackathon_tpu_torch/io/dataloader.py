"""DataLoader (the JAX package's ``io/dataloader.py``; ref
``fluid/reader.py:275`` DataLoader, ``fluid/dataloader/dataloader_iter.py``).

Batches are assembled on the host and land on the current place (the
card unless ``paddle.set_device("cpu")``) as ``Tensor``s made on the
consumer's thread.  The iterators are the JAX package's:

- ``num_workers=0``: the caller's thread fetches and collates;
- ``_PrefetchIter``: worker threads fetch and collate into a bounded
  in-order window.  With the default ``collate_fn`` they collate to numpy
  (``_np_collate``) and the consumer makes the tensors, so no worker
  thread starts a copy to the card;
- ``_BufferedPrefetchIter`` (``use_buffer_reader``, with the native
  runtime built): a stager thread copies each collated array into a slot
  of the native staging ring (``core/native.StagingRing``).  To the card
  the consumer copies a slot straight from the ring: the slots are
  page-locked once (``cudaHostRegister``), each copy runs ``non_blocking``
  on one copy stream and records an event, the consumer stream waits on
  that event before the batch is used, and the slot goes back to the ring
  only once its event has completed;
- ``_ProcPrefetchIter`` (``use_process_workers``): worker processes
  started with ``forkserver`` (or ``spawn``), never ``fork()``; the
  payload must pickle.  Children do numpy work only and never initialise
  CUDA; numeric arrays come back through POSIX shared memory.

``device_prefetch`` stages numpy leaves through pinned host memory onto
the card ahead of the consumer.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..core import device as _device
from ..core.tensor import Tensor
from ..observability.sanitizers import make_lock, share_object
from .dataset import IterableDataset
from .sampler import BatchSampler

_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, wid, num_workers, dataset):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset


def default_collate_fn(batch):
    """Stack samples into batched Tensors on the current place (ref
    ``fluid/dataloader/collate.py`` default_collate_fn)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(torch.stack([s._value for s in batch]))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([s[i] for s in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return _place(_np_collate(batch))


def _np_collate(batch):
    """The numpy-only collate that worker threads and processes run: the
    consumer makes the tensors (:func:`_place`)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, (list, tuple)):
        return tuple(_np_collate([s[i] for s in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _np_collate([s[k] for s in batch]) for k in sample}
    raise TypeError(
        f"cannot collate type {type(sample)}; datasets used with the "
        "default collate_fn must yield numpy/scalar/Tensor/list/dict "
        "samples")


def _place(batch):
    """numpy leaves of a collated batch -> ``Tensor``s on the current
    place (non-numeric arrays and other leaves pass through)."""
    if isinstance(batch, np.ndarray):
        if batch.dtype.kind in "OUSV":
            return batch
        return Tensor(torch.from_numpy(np.ascontiguousarray(batch)).to(
            _device.current_device()))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_place(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _place(v) for k, v in batch.items()}
    return batch


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_shared_memory = use_shared_memory
        self.use_process_workers = use_process_workers
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle,
                batch_size=batch_size if batch_size is not None else 1,
                drop_last=drop_last)
        self._no_batch = batch_size is None

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset DataLoader is unknown")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_single()
        if self.use_process_workers:
            return iter(_ProcPrefetchIter(self))
        if self.use_buffer_reader:
            from ..core import native
            if native.available():
                return iter(_BufferedPrefetchIter(self))
        return iter(_PrefetchIter(self))

    def _iter_single(self):
        for batch_idx in self.batch_sampler:
            samples = [self.dataset[i] for i in batch_idx]
            if self._no_batch:
                yield samples[0]
            else:
                yield self.collate_fn(samples)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == (self.batch_size or 1):
                yield self.collate_fn(batch)
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield self.collate_fn(batch)


def device_prefetch(iterator, size=2, device=None):
    """Device-prefetch iterator (ref ``buffered_reader.cc``'s H2D staging
    stage): pull up to ``size`` batches ahead of the consumer and start
    their host-to-device copies at once.

    numpy leaves are copied into pinned host memory and on to ``device``
    (default the current place) ``non_blocking`` on the device's copy
    stream, with an event the consumer stream waits on when the batch is
    yielded; they come out as torch tensors.  Tensors and torch tensors
    pass through (already on the device or in flight).  Works on any
    iterator of (nested) batches: tuples, lists and dicts of arrays.

    Each host-side pull is timed into the
    ``input_wait_seconds{site=device_prefetch}`` histogram, the
    input-starvation signal; ``io.prefetch`` is its fault point.
    """
    import time as _time

    from ..observability import faults as _faults
    from ..observability import metrics as _obs
    from .transfer import TransferRing, side_stream
    wait_hist = _obs.get_registry().histogram(
        "input_wait_seconds",
        "host wait per batch pulled from the input pipeline",
        unit="s").labels(site="device_prefetch")
    dev = _device.current_device() if device is None else \
        _device.resolve_device(device)

    def _put_leaf(a, events):
        if not (isinstance(a, np.ndarray) and a.dtype.kind not in "OUSV"):
            return a
        if dev.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        host = torch.empty(a.shape, dtype=torch.from_numpy(
            np.empty(0, a.dtype)).dtype, pin_memory=True)
        host.numpy()[...] = a
        copy = side_stream(dev)
        with torch.cuda.stream(copy):
            out = torch.empty(host.shape, dtype=host.dtype, device=dev)
            out.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy)
        events.append((ev, out))
        return out

    def _put(batch):
        events = []

        def walk(b):
            if isinstance(b, (list, tuple)):
                return type(b)(walk(x) for x in b)
            if isinstance(b, dict):
                return {k: walk(v) for k, v in b.items()}
            return _put_leaf(b, events)
        return walk(batch), events

    def _ready(entry):
        batch, events = entry
        if events:
            cur = torch.cuda.current_stream(dev)
            for ev, out in events:
                cur.wait_event(ev)
                out.record_stream(cur)
        return batch

    it = iter(iterator)
    size = max(int(size), 1)
    # a buffer of ``size`` batches = ``size - 1`` still in flight after
    # each yield (the ring pops the oldest once it is over depth)
    ring = TransferRing(depth=size - 1)
    while True:
        try:
            _faults.point("io.prefetch")
            t0 = _time.perf_counter()
            nxt = next(it)
            wait_hist.observe(_time.perf_counter() - t0)
        except StopIteration:
            for b in ring.drain():
                yield _ready(b)
            return
        ready = ring.push(_put(nxt))
        if ready is not None:
            yield _ready(ready)


class _PrefetchIter:
    """Thread-pool prefetching iterator (ref
    ``_DataLoaderIterMultiProcess`` ``dataloader_iter.py:342``: outstanding
    batch queue + in-order reordering).  ``place=False`` hands out the
    workers' batches as they are (numpy under the default collate): the
    buffered iterator stages those."""

    def __init__(self, loader: DataLoader, place: bool = True):
        self.loader = loader
        self.collate = (_np_collate
                        if loader.collate_fn is default_collate_fn
                        else loader.collate_fn)
        self.place = place and self.collate is _np_collate
        self.batches = list(loader.batch_sampler)
        self.max_outstanding = loader.num_workers * loader.prefetch_factor
        self.task_q: "queue.Queue" = queue.Queue()
        self.results = {}
        self.next_emit = 0
        self.lock = make_lock("dataloader.prefetch")
        self.cv = threading.Condition(self.lock)
        self.error = None
        for i, b in enumerate(self.batches):
            self.task_q.put((i, b))
        self.n_tasks = len(self.batches)
        self.workers = []
        # declared shared BEFORE the workers start: every worker access
        # from here on is lockset-checked when the race sanitizer is armed
        share_object(self, "dataloader.prefetch")
        for wid in range(loader.num_workers):
            t = threading.Thread(target=self._worker, args=(wid,), daemon=True)
            t.start()
            self.workers.append(t)

    def _worker(self, wid):
        _worker_info.info = WorkerInfo(wid, self.loader.num_workers,
                                       self.loader.dataset)
        if self.loader.worker_init_fn is not None:
            self.loader.worker_init_fn(wid)
        while True:
            try:
                i, idxs = self.task_q.get_nowait()
            except queue.Empty:
                return
            try:
                samples = [self.loader.dataset[j] for j in idxs]
                batch = self.collate(samples)
            except Exception as e:  # propagate to consumer
                with self.cv:
                    self.error = e
                    self.cv.notify_all()
                return
            with self.cv:
                while i > self.next_emit + self.max_outstanding and \
                        self.error is None:
                    self.cv.wait(timeout=1.0)
                self.results[i] = batch
                self.cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        import time as _time
        timeout = self.loader.timeout or None
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self.cv:
            # the drained check reads next_emit under the cv: it is
            # written under the cv below (check-then-act)
            if self.next_emit >= self.n_tasks:
                raise StopIteration
            while self.next_emit not in self.results and self.error is None:
                left = 1.0 if deadline is None else \
                    deadline - _time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"DataLoader worker timed out after {timeout}s")
                self.cv.wait(timeout=min(left, 1.0))
            if self.error is not None:
                raise self.error
            batch = self.results.pop(self.next_emit)
            self.next_emit += 1
            self.cv.notify_all()
        return _place(batch) if self.place else batch


def _proc_worker(dataset, collate_fn, worker_init_fn, wid, num_workers,
                 task_q, data_q, use_shm):
    """Worker-process body (ref ``fluid/dataloader/worker.py``
    ``_worker_loop``): fetch index batches from ``task_q``, collate, ship
    results back, numeric arrays through shared memory when ``use_shm``,
    everything else pickled on the queue."""
    import traceback
    _worker_info.info = WorkerInfo(wid, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        task = task_q.get()
        if task is None:
            return
        i, idxs = task
        try:
            batch = collate_fn([dataset[j] for j in idxs])
            arrays, structure = _flatten_batch(batch)
            metas = []
            for a in arrays:
                if use_shm and a.dtype.kind not in "OUSV" and a.nbytes > 0:
                    from multiprocessing import (resource_tracker,
                                                 shared_memory)
                    shm = shared_memory.SharedMemory(create=True,
                                                     size=a.nbytes)
                    np.ndarray(a.shape, a.dtype, buffer=shm.buf)[...] = a
                    metas.append(("shm", shm.name, a.dtype.str, a.shape))
                    shm.close()
                    # ownership passes to the parent, which unlinks after
                    # copying: drop this process's tracker registration
                    try:
                        resource_tracker.unregister(
                            shm._name, "shared_memory")
                    except Exception:
                        pass
                else:
                    metas.append(("raw", a))
            data_q.put((i, metas, structure))
        except Exception as e:  # noqa: BLE001 -- relayed to the parent
            data_q.put(("error", f"{type(e).__name__}: {e}\n"
                                 f"{traceback.format_exc(limit=8)}", None))
            return


class _ProcPrefetchIter:
    """Worker-PROCESS prefetching iterator (ref
    ``_DataLoaderIterMultiProcess`` ``dataloader_iter.py:342``): index
    batches fan out to worker processes; results return in submission
    order through a bounded outstanding-task window.  This is the path
    for Python-heavy (GIL-bound) per-sample transforms.

    Workers start with ``forkserver`` where the platform has it, else
    ``spawn``: never ``fork()``, which would copy a parent holding CUDA
    state and running threads.  So the payload (dataset, collate_fn,
    worker_init_fn) must pickle, and one that does not raises
    ``TypeError`` here.  Children do numpy work only (``_np_collate``
    under the default collate) and never initialise CUDA; the parent makes
    the tensors."""

    @staticmethod
    def _pick_context(loader, collate):
        import multiprocessing
        cached = getattr(loader, "_proc_mp_start_method", None)
        if cached is not None:
            return multiprocessing.get_context(cached)
        method = ("forkserver"
                  if "forkserver" in multiprocessing.get_all_start_methods()
                  else "spawn")
        # probe picklability through a null sink: no bytes are kept, so a
        # large in-memory dataset costs one serialisation pass
        import io as _io
        import pickle

        class _Null(_io.RawIOBase):
            def writable(self):
                return True

            def write(self, b):
                return len(b)

        try:
            pickle.Pickler(_Null(), protocol=pickle.HIGHEST_PROTOCOL).dump(
                (loader.dataset, collate, loader.worker_init_fn))
        except Exception as e:
            raise TypeError(
                f"DataLoader(use_process_workers=True) starts its workers "
                f"with {method!r}, never fork(), so the dataset, "
                f"collate_fn and worker_init_fn must pickle: {e!r}; use "
                f"thread workers (use_process_workers=False) for a payload "
                f"that does not") from e
        loader._proc_mp_start_method = method  # probe once per loader
        return multiprocessing.get_context(method)

    def __init__(self, loader: DataLoader):
        self.loader = loader
        collate = (loader.collate_fn
                   if loader.collate_fn is not default_collate_fn
                   else _np_collate)
        ctx = self._pick_context(loader, collate)
        if loader.use_shared_memory:
            # one tracker for the parent and its children: a private one
            # in a child would unlink segments the parent still needs
            from multiprocessing import resource_tracker
            resource_tracker.ensure_running()
        self.batches = list(loader.batch_sampler)
        self.n_tasks = len(self.batches)
        self.max_outstanding = max(
            loader.num_workers * loader.prefetch_factor, 1)
        self.task_q = ctx.Queue()
        self.data_q = ctx.Queue()
        self.results = {}
        self.next_emit = 0
        self.next_task = 0
        # close() runs from the consumer and from __del__: the closed
        # check-then-set is atomic
        self._close_lock = make_lock("dataloader.close")
        self._closed = False
        self.workers = [
            ctx.Process(target=_proc_worker,
                        args=(loader.dataset, collate,
                              loader.worker_init_fn, wid,
                              loader.num_workers, self.task_q, self.data_q,
                              loader.use_shared_memory),
                        daemon=True)
            for wid in range(loader.num_workers)]
        for w in self.workers:
            w.start()
        while (self.next_task < self.n_tasks
               and self.next_task < self.max_outstanding):
            self._submit()

    def _submit(self):
        self.task_q.put((self.next_task, self.batches[self.next_task]))
        self.next_task += 1

    def _reconstruct(self, metas, structure):
        from multiprocessing import shared_memory
        arrays = []
        for meta in metas:
            if meta[0] == "raw":
                arrays.append(_place(meta[1]))
                continue
            _, name, dtype, shape = meta
            shm = shared_memory.SharedMemory(name=name)
            try:
                view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf)
                arrays.append(_place(view.copy()))
            finally:
                shm.close()
                shm.unlink()
        return _unflatten_batch(arrays, structure)

    def __iter__(self):
        return self

    def __next__(self):
        if self.next_emit >= self.n_tasks:
            self.close()
            raise StopIteration
        timeout = self.loader.timeout or None
        while self.next_emit not in self.results:
            try:
                item = self.data_q.get(
                    timeout=timeout if timeout else 5.0)
            except Exception:
                if timeout:
                    self.close()
                    raise RuntimeError(
                        f"DataLoader worker timed out after {timeout}s")
                # a worker killed mid-task never delivers its batch
                dead = [w for w in self.workers
                        if w.exitcode not in (None, 0)]
                if dead:
                    codes = [w.exitcode for w in dead]
                    self.close()
                    raise RuntimeError(
                        f"DataLoader worker process(es) died "
                        f"(exitcode {codes}); their in-flight batches "
                        "are lost") from None
                if not any(w.is_alive() for w in self.workers):
                    self.close()
                    raise RuntimeError(
                        "all DataLoader worker processes exited "
                        "unexpectedly") from None
                continue
            if item[0] == "error":
                self.close()
                raise RuntimeError(
                    f"DataLoader worker raised:\n{item[1]}")
            i, metas, structure = item
            self.results[i] = (metas, structure)
        metas, structure = self.results.pop(self.next_emit)
        self.next_emit += 1
        if self.next_task < self.n_tasks:
            self._submit()
        elif self.next_emit >= self.n_tasks:
            for _ in self.workers:
                self.task_q.put(None)  # drain workers at epoch end
        return self._reconstruct(metas, structure)

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # graceful first: sentinels let each worker finish its current
        # task and flush its queue feeder
        for _ in self.workers:
            self.task_q.put(None)
        pending = list(self.results.values())
        self.results.clear()
        import queue as _q
        import time as _time
        deadline = _time.monotonic() + 5.0
        while (any(w.is_alive() for w in self.workers)
               and _time.monotonic() < deadline):
            try:
                item = self.data_q.get(timeout=0.1)
            except _q.Empty:
                continue
            if item and not isinstance(item[0], str):
                pending.append((item[1], item[2]))
        for w in self.workers:
            if w.is_alive():
                w.terminate()
            w.join()
        while True:
            try:
                item = self.data_q.get_nowait()
            except Exception:
                break
            if item and not isinstance(item[0], str):
                pending.append((item[1], item[2]))
        # unlink segments parked in results or undrained in the queue: an
        # early-terminated epoch must not leak /dev/shm
        from multiprocessing import shared_memory
        for metas, _ in pending:
            for meta in metas:
                if meta[0] == "shm":
                    try:
                        shm = shared_memory.SharedMemory(name=meta[1])
                        shm.close()
                        shm.unlink()
                    except FileNotFoundError:
                        pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _BufferedPrefetchIter:
    """Prefetch iterator over the native staging ring (ref
    ``operators/reader/buffered_reader.cc``).

    Pipeline: worker threads (dataset fetch + collate) -> stager thread
    (C++ memcpy into recycled slots, GIL released during the copy) ->
    consumer.  Metadata for each batch is queued before its arrays are
    staged, so the consumer drains slots while the stager fills them.
    Non-numeric arrays, and arrays larger than a slot (which would move
    the slot's page-locked buffer), travel on the metadata queue.

    On the card the consumer copies each slot to the device
    (:meth:`_copy_to_card`: ``non_blocking`` on the copy stream, then an
    event), makes the current stream wait on that event, and hands the
    slot back to the ring only after the event has completed
    (:meth:`_release_when_copied`, reaped before the next pop).  On the
    CPU it copies the slot on the host and releases it at once, as the JAX
    package does.
    """

    slot_bytes = 1 << 20

    def __init__(self, loader: DataLoader):
        from ..core import native
        self.inner = _PrefetchIter(loader, place=False)
        self.device = _device.current_device()
        n_slots = max(4, loader.num_workers * loader.prefetch_factor * 2)
        self.ring = native.StagingRing(n_slots=n_slots,
                                       slot_bytes=self.slot_bytes)
        self.meta_q: "queue.Queue" = queue.Queue()
        self._pinned = {}        # slot -> its page-locked address
        self._pending = []       # (event, slot) of copies in flight
        self._copy_stream = None
        if self.device.type == "cuda":
            from .transfer import side_stream
            self._copy_stream = side_stream(self.device)
        self._close_lock = make_lock("dataloader.close")
        self._closed = False
        # the thread target closes over (inner, ring, meta_q) directly --
        # NOT self -- so an abandoned iterator can be garbage-collected,
        # firing __del__ -> close() -> ring.close(), which unblocks it
        self._stager = threading.Thread(
            target=_stage_loop,
            args=(self.inner, self.ring, self.meta_q, self.slot_bytes),
            daemon=True)
        self._stager.start()

    def close(self):
        """Unblock and tear down (also called on abandonment via __del__):
        the copies in flight complete before their slots are unpinned."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self.ring.close()  # unblocks a stager stuck waiting for a free slot
        with self.inner.cv:
            if self.inner.error is None:
                self.inner.error = GeneratorExit("DataLoader iterator closed")
            self.inner.cv.notify_all()
        for ev, _ in self._pending:
            ev.synchronize()
        self._pending = []
        if self._pinned:
            rt = torch.cuda.cudart()
            for ptr in self._pinned.values():
                rt.cudaHostUnregister(ptr)
            self._pinned = {}

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self.meta_q.get()
        if item is None:
            self.close()
            raise StopIteration
        if isinstance(item, Exception):
            self.close()
            raise item
        metas, structure = item
        arrays = []
        for meta in metas:
            if meta[0] == "raw":
                arrays.append(_place(meta[1]))
                continue
            dtype, shape = meta
            self._reap()
            slot, view = self.ring.next(dtype, shape)
            if slot is None:
                self.close()
                raise RuntimeError(
                    "staging ring drained mid-batch (stager failed)")
            if self._copy_stream is None:
                # the host copy is made before the slot is recycled
                arrays.append(Tensor(torch.from_numpy(np.array(view)).to(
                    self.device)))
                self.ring.release(slot)
                continue
            self._pin(slot, view)
            out, ev = self._copy_to_card(view)
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            out.record_stream(cur)
            arrays.append(Tensor(out))
            self._release_when_copied(ev, slot)
        return _unflatten_batch(arrays, structure)

    def _pin(self, slot, view):
        """Page-lock ``slot``'s buffer at its first use (its address stays
        while the blocks fit the slot)."""
        ptr = view.ctypes.data
        have = self._pinned.get(slot)
        if have == ptr:
            return
        if have is not None:
            raise RuntimeError(f"staging slot {slot} moved from {have:#x} "
                               f"to {ptr:#x}")
        err = torch.cuda.cudart().cudaHostRegister(ptr, self.ring.slot_bytes,
                                                   0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of staging slot {slot} "
                               f"failed ({err})")
        self._pinned[slot] = ptr

    def _copy_to_card(self, view):
        """Start the copy of a page-locked slot to the card on the copy
        stream; returns (the device tensor, the event after the copy)."""
        src = torch.from_numpy(view)
        with torch.cuda.stream(self._copy_stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        return out, ev

    def _release_when_copied(self, ev, slot):
        """Hand ``slot`` back to the ring once ``ev`` (its copy) has
        completed: :meth:`_reap` releases it."""
        self._pending.append((ev, slot))

    def _reap(self):
        """Release the slots whose copies have completed.  Before the
        consumer pops again, fewer than half the slots may stay held, so
        the stager always has one to fill: the oldest copies are waited
        for (the copy stream carries only these copies, so they finish
        within microseconds)."""
        keep = []
        for ev, slot in self._pending:
            if ev.query():
                self.ring.release(slot)
            else:
                keep.append((ev, slot))
        while len(keep) >= max(self.ring.n_slots // 2, 1):
            ev, slot = keep.pop(0)
            ev.synchronize()
            self.ring.release(slot)
        self._pending = keep


def _stage_loop(inner, ring, meta_q, slot_bytes):
    """Stager thread body (module-level: must not keep the iterator alive)."""
    seq = 0
    try:
        for batch in inner:
            arrays, structure = _flatten_batch(batch)
            metas = []
            ringable = []
            for a in arrays:
                if a.dtype.kind in "OUSV" or a.nbytes > slot_bytes:
                    metas.append(("raw", a))
                else:
                    metas.append((a.dtype, a.shape))
                    ringable.append(a)
            # meta first: the consumer starts draining slots while the
            # arrays stream through the ring (no capacity deadlock)
            meta_q.put((metas, structure))
            for a in ringable:
                if ring.stage(a, seq) < 0:
                    raise RuntimeError("staging ring closed mid-epoch")
                seq += 1
        meta_q.put(None)
    except Exception as e:
        meta_q.put(e)
    except BaseException:  # GeneratorExit from close(): silent exit
        meta_q.put(None)
    finally:
        ring.close()


def _flatten_batch(batch):
    """Split a collated batch into (list of numpy arrays, structure)."""
    if isinstance(batch, dict):
        arrays, struct = [], []
        for k in batch:
            a, s = _flatten_batch(batch[k])
            struct.append((k, len(a), s))
            arrays.extend(a)
        return arrays, ("dict", struct)
    if isinstance(batch, (list, tuple)):
        arrays, struct = [], []
        for item in batch:
            a, s = _flatten_batch(item)
            struct.append((len(a), s))
            arrays.extend(a)
        return arrays, (type(batch).__name__, struct)
    if isinstance(batch, Tensor):
        return [np.asarray(batch.numpy())], "tensor"
    return [np.asarray(batch)], "array"


def _unflatten_batch(arrays, structure):
    if structure in ("tensor", "array"):
        return arrays[0]
    kind, struct = structure
    if kind == "dict":
        out = {}
        i = 0
        for k, n, s in struct:
            out[k] = _unflatten_batch(arrays[i:i + n], s)
            i += n
        return out
    out = []
    i = 0
    for n, s in struct:
        out.append(_unflatten_batch(arrays[i:i + n], s))
        i += n
    return tuple(out) if kind == "tuple" else out
