from .api import make_sharded_train_step

__all__ = ["make_sharded_train_step"]
