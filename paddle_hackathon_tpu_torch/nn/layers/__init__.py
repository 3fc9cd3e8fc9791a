from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
