from .api import (get_mesh, make_functional_train_step,
                  make_sharded_train_step, set_mesh)

__all__ = ["get_mesh", "make_functional_train_step",
           "make_sharded_train_step", "set_mesh"]
