from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .attention import scaled_dot_product_attention, sequence_mask
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss

__all__ = sorted(set(_activation) | set(_loss) |
                 {"scaled_dot_product_attention", "sequence_mask"})
