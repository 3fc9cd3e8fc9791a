from .api import make_functional_train_step, make_sharded_train_step

__all__ = ["make_functional_train_step", "make_sharded_train_step"]
