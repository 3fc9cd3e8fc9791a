from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .attention import scaled_dot_product_attention, sequence_mask
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm

__all__ = sorted(set(_activation) | set(_common) | set(_loss) | set(_norm)
                 | {"scaled_dot_product_attention", "sequence_mask"})
