"""The port's input pipeline (``io/``) against the JAX package's.

- ``Dataset``s, samplers and ``default_collate_fn`` give the JAX
  package's items, index orders (numpy's global ``np.random`` seeded the
  same) and batches;
- the thread, buffered-ring and process ``DataLoader``s yield the JAX
  package's batches in its order, shuffled too; process workers start
  with ``forkserver`` or ``spawn`` (never ``fork``) and an unpicklable
  payload raises; worker errors reach the consumer and ``timeout`` fires;
- the buffered iterator hands a slot back to the ring only once its
  copy's event has completed, and routes arrays larger than a slot
  around the ring;
- ``device_prefetch`` passes batches through unchanged and in order,
  timing each pull into ``input_wait_seconds``.
"""

import time

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu_torch.io import dataloader as tdl


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def _flat(batch):
    """A batch as nested lists of numpy arrays (either package)."""
    if isinstance(batch, dict):
        return {k: _flat(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_flat(b) for b in batch]
    return _np(batch)


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _rows(n=37):
    rng = np.random.RandomState(3)
    return (rng.randn(n, 3).astype(np.float32),
            np.arange(n, dtype=np.int64), rng.randint(0, 9, (n, 4)))


def _dataset(mod, n=37, kind="tuple"):
    x, y, z = _rows(n)

    class Rows(mod.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            if kind == "dict":
                return {"x": x[i], "pair": (y[i], z[i])}
            return x[i], y[i]
    return Rows()


# -- datasets, samplers, collate ---------------------------------------------

def _datasets(mod):
    x, y, z = _rows(12)
    td = mod.io.TensorDataset([x, y])
    return {
        "tensor": td,
        "compose": mod.io.ComposeDataset([td, mod.io.TensorDataset([z])]),
        "concat": mod.io.ConcatDataset([td, mod.io.TensorDataset([z, y])]),
        "subset": mod.io.Subset(td, [5, 1, 9]),
    }


@pytest.mark.parametrize("name", ["tensor", "compose", "concat", "subset"])
def test_datasets_match_jax(name):
    jd, td = _datasets(jp)[name], _datasets(tp)[name]
    assert len(td) == len(jd)
    for i in list(range(len(jd))) + [-1]:
        _assert_same(_flat(td[i]), _flat(jd[i]))


def test_chain_dataset_and_random_split():
    class It(tp.io.IterableDataset):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def __iter__(self):
            return iter(range(self.lo, self.hi))

    assert [v for v in tp.io.ChainDataset([It(0, 3), It(3, 5)])] == \
        list(range(5))
    with pytest.raises(RuntimeError):
        It(0, 1)[0]
    td = _datasets(tp)["tensor"]
    gen = torch.Generator().manual_seed(0)
    parts = tp.io.random_split(td, [5, 7], generator=gen)
    idx = parts[0].indices + parts[1].indices
    assert [len(p) for p in parts] == [5, 7] and sorted(idx) == list(range(12))
    again = tp.io.random_split(td, [5, 7],
                               generator=torch.Generator().manual_seed(0))
    assert again[0].indices == parts[0].indices
    assert [len(p) for p in tp.io.random_split(td, [0.25, 0.75])] == [3, 9]
    with pytest.raises(ValueError):
        tp.io.random_split(td, [5, 5])


def _samplers(mod):
    ds = list(range(23))
    io = mod.io
    return {
        "sequence": lambda: list(io.SequenceSampler(ds)),
        "random": lambda: list(io.RandomSampler(ds)),
        "random_replacement": lambda: list(io.RandomSampler(
            ds, replacement=True, num_samples=40)),
        "subset_random": lambda: list(io.SubsetRandomSampler([3, 8, 1, 17])),
        "weighted": lambda: list(io.WeightedRandomSampler(
            np.arange(1, 24), 30)),
        "batch_drop_last": lambda: list(io.BatchSampler(
            ds, shuffle=True, batch_size=5, drop_last=True)),
        "batch": lambda: list(io.BatchSampler(ds, batch_size=5)),
        "distributed": lambda: _dist(io, ds),
    }


def _dist(io, ds):
    s = io.DistributedBatchSampler(ds, batch_size=4, num_replicas=3, rank=1,
                                   shuffle=True)
    s.set_epoch(2)
    one = io.DistributedBatchSampler(ds, batch_size=4)
    return list(s), len(s), (one.nranks, one.local_rank), list(one)


@pytest.mark.parametrize("name", sorted(_samplers(jp)))
def test_samplers_match_jax(name):
    np.random.seed(11)
    want = _samplers(jp)[name]()
    np.random.seed(11)
    got = _samplers(tp)[name]()
    assert got == want


@pytest.mark.parametrize("kind", ["tuple", "dict"])
def test_default_collate_matches_jax(kind):
    jd, td = _dataset(jp, 6, kind), _dataset(tp, 6, kind)
    want = jp.io.default_collate_fn([jd[i] for i in range(6)])
    got = tp.io.default_collate_fn([td[i] for i in range(6)])
    _assert_same(_flat(got), _flat(want))
    leaves = list(got.values()) if isinstance(got, dict) else list(got)
    assert isinstance(leaves[0], tp.Tensor)
    # Tensor samples stack into a Tensor
    t = tp.io.default_collate_fn([tp.to_tensor(np.ones(3, np.float32))] * 2)
    assert isinstance(t, tp.Tensor) and t.shape == [2, 3]


# -- the loaders -------------------------------------------------------------

_LOADERS = {
    "single": dict(num_workers=0),
    "threads": dict(num_workers=2, use_buffer_reader=False),
    "buffered_ring": dict(num_workers=2, use_buffer_reader=True),
}
_ITER = {"single": "generator", "threads": "_PrefetchIter",
         "buffered_ring": "_BufferedPrefetchIter"}


def _jax_batches(n, kind, shuffle, **kw):
    np.random.seed(4)
    dl = jp.io.DataLoader(_dataset(jp, n, kind), batch_size=5,
                          shuffle=shuffle, **kw)
    return [_flat(b) for b in dl]


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
@pytest.mark.parametrize("kind", ["tuple", "dict"])
@pytest.mark.parametrize("loader", sorted(_LOADERS))
def test_loaders_yield_the_jax_batches_in_order(loader, kind, shuffle):
    want = _jax_batches(37, kind, shuffle)
    np.random.seed(4)
    dl = tp.io.DataLoader(_dataset(tp, 37, kind), batch_size=5,
                          shuffle=shuffle, **_LOADERS[loader])
    it = iter(dl)
    assert type(it).__name__ == _ITER[loader]
    got = list(it)
    assert len(got) == len(dl) == 8
    leaf = got[0]["x"] if kind == "dict" else got[0][0]
    assert isinstance(leaf, tp.Tensor) and leaf.place.is_cpu_place()
    _assert_same([_flat(b) for b in got], want)


def test_buffered_ring_routes_oversized_arrays_around_the_ring(monkeypatch):
    monkeypatch.setattr(tdl._BufferedPrefetchIter, "slot_bytes", 32)
    want = _jax_batches(37, "dict", False)
    dl = tp.io.DataLoader(_dataset(tp, 37, "dict"), batch_size=5,
                          num_workers=2)
    _assert_same([_flat(b) for b in dl], want)


def test_process_workers_match_jax_and_never_fork():
    x, y, _ = _rows(37)
    np.random.seed(4)
    want = [_flat(b) for b in jp.io.DataLoader(
        jp.io.TensorDataset([x, y]), batch_size=5, shuffle=True)]
    np.random.seed(4)
    dl = tp.io.DataLoader(tp.io.TensorDataset([x, y]), batch_size=5,
                          shuffle=True, num_workers=2,
                          use_process_workers=True)
    it = iter(dl)
    assert type(it).__name__ == "_ProcPrefetchIter"
    assert dl._proc_mp_start_method in ("forkserver", "spawn")
    assert all(w._popen.method != "fork" for w in it.workers)
    _assert_same([_flat(b) for b in it], want)


class _Unpicklable(tp.io.Dataset):
    def __init__(self):
        self.fn = lambda i: i       # a lambda does not pickle

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.float32(self.fn(i))


def test_unpicklable_process_payload_raises_without_fork(monkeypatch):
    import multiprocessing
    started = []
    real = multiprocessing.get_context

    def spy(method=None):
        started.append(method)
        return real(method)

    monkeypatch.setattr(multiprocessing, "get_context", spy)
    dl = tp.io.DataLoader(_Unpicklable(), batch_size=2, num_workers=2,
                          use_process_workers=True)
    with pytest.raises(TypeError, match="never fork"):
        iter(dl)
    assert "fork" not in started


def test_process_worker_errors_reach_the_consumer():
    x, y, _ = _rows(8)
    dl = tp.io.DataLoader(tp.io.TensorDataset([x, y]),
                          batch_sampler=[[0, 1], [99]], num_workers=2,
                          use_process_workers=True)
    with pytest.raises(RuntimeError, match="IndexError"):
        list(dl)


class _Failing(tp.io.Dataset):
    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 7:
            raise KeyError("bad sample 7")
        return np.float32(i)


class _Slow(tp.io.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        time.sleep(1.0)
        return np.float32(i)


@pytest.mark.parametrize("buffered", [False, True], ids=["threads",
                                                         "buffered_ring"])
def test_thread_worker_errors_and_timeout(buffered):
    dl = tp.io.DataLoader(_Failing(), batch_size=2, num_workers=2,
                          use_buffer_reader=buffered)
    with pytest.raises(KeyError, match="bad sample 7"):
        list(dl)
    dl = tp.io.DataLoader(_Slow(), batch_size=2, num_workers=1, timeout=0.2,
                          use_buffer_reader=buffered)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="timed out"):
        list(dl)
    assert time.perf_counter() - t0 < 5


# -- the slot-release contract of the buffered iterator ----------------------

class _Event:
    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


class _Ring:
    n_slots = 8

    def __init__(self):
        self.released = []

    def release(self, slot):
        self.released.append(slot)


def test_slots_are_released_only_after_their_copy_event():
    it = tdl._BufferedPrefetchIter.__new__(tdl._BufferedPrefetchIter)
    it.ring, it._pending = _Ring(), []
    busy, done = _Event(False), _Event(True)
    it._release_when_copied(busy, 3)
    it._release_when_copied(done, 5)
    assert it.ring.released == []          # nothing before the reap
    it._reap()
    assert it.ring.released == [5] and not busy.waited
    busy.done = True
    it._reap()
    assert it.ring.released == [5, 3]
    # half the slots held by copies in flight: the oldest is waited for,
    # so the stager always finds a free slot
    evs = [_Event(False) for _ in range(5)]
    for s, ev in enumerate(evs):
        it._release_when_copied(ev, 10 + s)
    it._reap()
    assert it.ring.released == [5, 3, 10, 11] and evs[0].waited
    assert [s for _, s in it._pending] == [12, 13, 14]


# -- device_prefetch ---------------------------------------------------------

def test_device_prefetch_passes_batches_through_in_order():
    from paddle_hackathon_tpu_torch.observability import metrics as obs
    fam = obs.get_registry().histogram("input_wait_seconds", "",
                                       unit="s").labels(site="device_prefetch")
    before = fam.count
    rng = np.random.RandomState(0)
    batches = [({"a": rng.randn(2, 3).astype(np.float32)},
                (rng.randint(0, 5, 4), tp.to_tensor(np.full(2, i, np.int32))))
               for i in range(5)]
    for size in (1, 2, 3):
        out = list(tdl.device_prefetch(iter(batches), size=size))
        assert len(out) == len(batches)
        for (d, (ids, t)), (d0, (ids0, t0)) in zip(out, batches):
            assert isinstance(d["a"], torch.Tensor)
            np.testing.assert_array_equal(d["a"].numpy(), d0["a"])
            np.testing.assert_array_equal(ids.numpy(), ids0)
            assert t is t0                  # a Tensor passes through
    assert fam.count - before == 3 * 5


def test_loader_raises_without_a_place(monkeypatch):
    from paddle_hackathon_tpu_torch.core import device as pdevice
    monkeypatch.setattr(pdevice, "_current", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in _LOADERS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            list(tp.io.DataLoader(_dataset(tp, 10), batch_size=5, **kw))


def test_transfer_ring_and_the_d2h_pipe():
    """``TransferRing`` pops the oldest entry once over depth (depth 0 is
    synchronous); ``start_d2h`` / ``finish_d2h`` give a tree's tensors
    back as numpy, in its structure (the pinned copies run on the card)."""
    from paddle_hackathon_tpu_torch.io import (TransferRing, finish_d2h,
                                               start_d2h)
    ring = TransferRing(depth=2)
    assert [ring.push(i) for i in range(4)] == [None, None, 0, 1]
    assert list(ring.drain()) == [2, 3] and len(ring) == 0
    assert TransferRing(depth=0).push("x") == "x"
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": (tp.to_tensor(np.ones(2, np.float32)), "tag")}
    out = finish_d2h(start_d2h(tree))
    np.testing.assert_array_equal(out["a"], np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(out["b"][0], np.ones(2, np.float32))
    assert out["b"][1] == "tag" and isinstance(out["b"], tuple)
