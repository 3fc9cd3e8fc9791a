"""Device resolution for the port's entry points, and Paddle's places.

The JAX package picks its default place from the visible platforms
(``core/device.py``).  The port is written for one CUDA card: every entry
point resolves ``device=None`` to ``cuda`` and raises when there is no
card, so a run that meant the GPU never carries on quietly on the CPU.
The CPU is taken only when the caller names it, as the tests do.

Paddle's ``Place`` / ``set_device`` surface sits on top: ``"gpu"`` and
``"gpu:N"`` are ``cuda:N``, and the default place is the card, so a
tensor made with no place and no ``set_device("cpu")`` raises without
one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); ``"cpu"`` -> the CPU;
    ``"cuda"``/``"cuda:N"``/a ``torch.device`` -> that device, checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


# ---------------------------------------------------------------------------
# Places and the current device (the JAX package's ``core/device.py``)
# ---------------------------------------------------------------------------

class Place:
    """A device handle: ``Place("gpu", 0)`` is ``cuda:0``, ``Place("cpu")``
    the host.  Equality is (device_type, device_id)."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "cuda":
            device_type = "gpu"
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this place, checked as
        :func:`resolve_device` checks it."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if self.device_type != "gpu":
            raise ValueError(f"unsupported place {self}: use 'gpu' or 'cpu'")
        return resolve_device(f"cuda:{self.device_id}")

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    def is_tpu_place(self):
        return False

    def get_device_id(self):
        return self.device_id


def to_place(device) -> Place:
    """A Paddle device string (``"gpu"``, ``"gpu:1"``, ``"cpu"``; torch's
    ``"cuda[:N]"`` too), a ``torch.device`` or a :class:`Place` ->
    :class:`Place`."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return Place(device.type, device.index or 0)
    dev_type, _, idx = str(device).partition(":")
    return Place(dev_type, int(idx or 0))


# one process-wide current place (the JAX package keeps one per thread);
# None means the default, the card
_current: Optional[Place] = None


def set_device(device) -> Place:
    """``paddle.set_device``: ``"gpu"``, ``"gpu:N"`` (``cuda:N``) or
    ``"cpu"``; a card that is not there raises."""
    place = to_place(device)
    place.torch_device  # validate eagerly
    global _current
    _current = place
    return place


def current_place() -> Place:
    """The place new tensors land on: the last :func:`set_device`, else
    the card (``gpu:0``), whether or not one is present: making a tensor
    there raises without one, as :func:`resolve_device` does."""
    return _current if _current is not None else Place("gpu", 0)


def current_device() -> torch.device:
    """``current_place()`` as a checked ``torch.device``."""
    return current_place().torch_device


def parameter_device(device: DeviceLike = None) -> torch.device:
    """Where a layer puts its parameters: ``device`` when given, else the
    current place, as Paddle's layers do.  On a machine without a card,
    before any :func:`set_device`, that is the CPU, so model code can be
    built before a place is chosen; a tensor made there with no place
    still raises (:func:`current_place`)."""
    if device is not None:
        return resolve_device(device)
    if _current is None and not torch.cuda.is_available():
        return torch.device("cpu")
    return current_device()


def get_device() -> str:
    p = current_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.device_id}"


def device_count(device_type: Optional[str] = None) -> int:
    if device_type is None:
        device_type = current_place().device_type
    if device_type == "cpu":
        return 1
    if device_type in ("gpu", "cuda"):
        return torch.cuda.device_count()
    return 0


def synchronize(place=None) -> None:
    """Block until the card's queued work is done (a no-op on the CPU)."""
    place = to_place(place) if place is not None else current_place()
    if place.is_gpu_place():
        torch.cuda.synchronize(place.torch_device)


def memory_stats(place=None) -> dict:
    """The card's allocator statistics under the JAX package's keys
    (zeros on the CPU)."""
    place = to_place(place) if place is not None else current_place()
    if not place.is_gpu_place():
        return {"allocated.current": 0, "allocated.peak": 0,
                "reserved.total": 0, "num_allocs": 0}
    dev = place.torch_device
    stats = torch.cuda.memory_stats(dev)
    return {"allocated.current": stats.get("allocated_bytes.all.current", 0),
            "allocated.peak": stats.get("allocated_bytes.all.peak", 0),
            "reserved.total": stats.get("reserved_bytes.all.current", 0),
            "num_allocs": stats.get("allocation.all.allocated", 0)}


def max_memory_allocated(place=None) -> int:
    return memory_stats(place)["allocated.peak"]


def memory_allocated(place=None) -> int:
    return memory_stats(place)["allocated.current"]


# capability probes: the port is built for CUDA and nothing else
def get_cudnn_version():
    return torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu():
    return False


def is_compiled_with_rocm():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_mlu():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False

