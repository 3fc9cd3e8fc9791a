from . import lr
from .optimizer import L1Decay, L2Decay, Optimizer
from .optimizers import (Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Lars,
                         LarsMomentum, Momentum, RMSProp, SGD, adam_update,
                         adam_update_multi, lamb_update, lars_update)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "L1Decay",
           "L2Decay", "Lamb", "Lars", "LarsMomentum", "Momentum", "Optimizer",
           "RMSProp", "SGD", "adam_update", "adam_update_multi",
           "lamb_update", "lars_update", "lr"]
