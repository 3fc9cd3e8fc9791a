from .paged import PagePool, PrefixCache, pages_for
from .serving import Request, ServingEngine

__all__ = ["PagePool", "PrefixCache", "Request", "ServingEngine",
           "pages_for"]
