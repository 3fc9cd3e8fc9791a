from .activation import gelu
from .attention import scaled_dot_product_attention, sequence_mask
from .loss import cross_entropy, fused_softmax_ce_rows

__all__ = ["cross_entropy", "fused_softmax_ce_rows", "gelu",
           "scaled_dot_product_attention", "sequence_mask"]
