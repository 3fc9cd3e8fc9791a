"""Depth-bounded in-order async-transfer ring (the JAX package's
``io/transfer.py``).

``TransferRing`` is the FIFO the input pipeline keeps its in-flight
transfers in: ``push`` a started transfer, get back the oldest once more
than ``depth`` are outstanding, and complete that one while the younger
ones stream underneath.  It never touches a device API: entries are
opaque handles for work already started, and the ring holds a reference
to each until it is popped, so a buffer an async copy reads stays alive.

``start_d2h`` / ``finish_d2h`` are the device-to-host half: every CUDA
tensor leaf of a tree is copied ``non_blocking`` into a pinned host
tensor on a side stream (which first waits for the work queued on the
current stream), with one CUDA event per leaf; ``finish_d2h`` waits on the
events and returns numpy arrays.
"""

from __future__ import annotations

import collections

import torch

__all__ = ["TransferRing", "start_d2h", "finish_d2h"]


class TransferRing:
    """FIFO pipeline of in-flight transfers, at most ``depth`` deep.

    ``depth=1`` is classic double-buffering (one transfer hides behind
    one completion); ``depth=0`` degenerates to fully synchronous
    (``push`` returns its own argument) so callers can expose the knob
    without branching.
    """

    def __init__(self, depth: int = 1):
        self._depth = max(int(depth), 0)
        self._buf = collections.deque()

    @property
    def depth(self) -> int:
        return self._depth

    def __len__(self) -> int:
        return len(self._buf)

    def push(self, entry):
        """Enqueue a started transfer; returns the oldest entry when the
        ring is over depth (the caller completes it), else ``None``."""
        self._buf.append(entry)
        if len(self._buf) > self._depth:
            return self._buf.popleft()
        return None

    def drain(self):
        """Yield the remaining in-flight entries, oldest first."""
        while self._buf:
            yield self._buf.popleft()


class _D2H:
    """One leaf's device-to-host copy in flight: the pinned host tensor
    it lands in and the event recorded after it."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host, self.event = host, event


_side_streams: dict = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The copy stream of ``device`` (one per device, made at first use)."""
    dev = torch.device(device)
    s = _side_streams.get(dev.index)
    if s is None:
        s = _side_streams[dev.index] = torch.cuda.Stream(device=dev)
    return s


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _start(a):
    from ..core.tensor import Tensor
    if isinstance(a, Tensor):
        a = a._value
    if not (isinstance(a, torch.Tensor) and a.is_cuda):
        return a
    a = a.detach()
    cur = torch.cuda.current_stream(a.device)
    side = side_stream(a.device)
    side.wait_stream(cur)
    host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(a, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(side)
    a.record_stream(side)
    return _D2H(host, ev)


def start_d2h(tree):
    """Start the device-to-host copy of every CUDA tensor (or CUDA
    ``Tensor``) leaf of ``tree`` without blocking; returns the tree with
    those leaves replaced by their copies in flight, for
    :func:`finish_d2h`.  Other leaves pass through."""
    return _map(_start, tree)


def _finish(a):
    from ..core.tensor import Tensor, _to_numpy
    if isinstance(a, _D2H):
        a.event.synchronize()
        return _to_numpy(a.host)
    if isinstance(a, Tensor):
        return a.numpy()
    if isinstance(a, torch.Tensor):
        return _to_numpy(a)
    return a


def finish_d2h(tree):
    """Materialise a (previously :func:`start_d2h`'d) tree as host numpy:
    the only blocking step of the pipe (bf16 leaves as their ``uint16``
    bit views)."""
    return _map(_finish, tree)
