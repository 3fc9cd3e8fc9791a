from .activation import *  # noqa: F401,F403
from .common import Dropout, Embedding, Linear
from .loss import *  # noqa: F401,F403
from .norm import LayerNorm
