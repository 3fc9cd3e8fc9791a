from .convert import load_jax_state, state_to_numpy

__all__ = ["load_jax_state", "state_to_numpy"]
