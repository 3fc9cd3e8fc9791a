"""Framework-level utilities (the JAX package's ``framework/``): save and
load."""

from .io import load, save  # noqa: F401


def in_dynamic_mode() -> bool:
    """True: the port runs eagerly (there is no ``to_static`` trace)."""
    return True


def in_dygraph_mode() -> bool:
    return in_dynamic_mode()
