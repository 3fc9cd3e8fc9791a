from .paged import PagePool, PrefixCache, pages_for
from .serving import (Request, ServingEngine, TornArtifactError,
                      load_for_serving, save_for_serving)

__all__ = ["PagePool", "PrefixCache", "Request", "ServingEngine",
           "TornArtifactError", "load_for_serving", "pages_for",
           "save_for_serving"]
