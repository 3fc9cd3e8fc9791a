from .activation import gelu
from .loss import cross_entropy, fused_softmax_ce_rows

__all__ = ["cross_entropy", "fused_softmax_ce_rows", "gelu"]
