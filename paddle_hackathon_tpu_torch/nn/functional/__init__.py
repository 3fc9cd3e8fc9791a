from .activation import gelu

__all__ = ["gelu"]
