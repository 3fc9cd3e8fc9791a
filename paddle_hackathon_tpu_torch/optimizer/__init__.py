from .optimizer import Optimizer
from .optimizers import Adam, adam_update

__all__ = ["Adam", "Optimizer", "adam_update"]
