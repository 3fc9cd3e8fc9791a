from .convert import load_jax_state

__all__ = ["load_jax_state"]
