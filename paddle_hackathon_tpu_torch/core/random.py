"""Seeded ``torch.Generator``s, one per device.

The JAX package threads one global PRNG key (``core/random.py``).  The
port passes an explicit ``torch.Generator`` wherever randomness is drawn
(weight init, dropout, sampling); a caller that passes none gets the
default generator of the tensor's device, seeded by :func:`seed`.  The two
frameworks give different numbers from the same seed, so tests that
compare them make their inputs with numpy.
"""

from __future__ import annotations

import contextlib

import torch

_DEFAULT_SEED = 0
_seed = _DEFAULT_SEED
_generators: dict = {}
_scoped: list = []   # generators installed by rng_scope, innermost last


def seed(s: int) -> None:
    """Re-seed every device's default generator."""
    global _seed
    _seed = int(s)
    _generators.clear()


def default_generator(device) -> torch.Generator:
    """The default generator of ``device``, created at first use from the
    last :func:`seed`."""
    dev = torch.device(device)
    for gen in reversed(_scoped):
        if gen.device.type == dev.type:
            return gen
    key = (dev.type, dev.index)
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_seed)
        _generators[key] = gen
    return gen


@contextlib.contextmanager
def rng_scope(gen: torch.Generator):
    """Within the block, :func:`default_generator` of ``gen``'s device type
    returns ``gen`` (the train step's per-step ``rng``)."""
    _scoped.append(gen)
    try:
        yield gen
    finally:
        _scoped.pop()


def get_rng_state():
    """The generator state: the seed and every default generator made
    since it (``set_rng_state`` takes it back)."""
    return {"seed": _seed,
            "states": {key: gen.get_state()
                       for key, gen in _generators.items()}}


def set_rng_state(state) -> None:
    """Restore a :func:`get_rng_state` snapshot."""
    global _seed
    _seed = int(state["seed"])
    _generators.clear()
    for (dtype, index), st in state["states"].items():
        gen = default_generator(torch.device(dtype, index))
        gen.set_state(st)
