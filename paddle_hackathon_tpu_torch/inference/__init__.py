from .paged import PagePool, PrefixCache, page_digests, pages_for
from .serving import (PRIORITY_RANK, DeadlineExceededError, EngineDraining,
                      Request, ServingEngine, TornArtifactError,
                      load_for_serving, save_for_serving)

__all__ = ["DeadlineExceededError", "EngineDraining", "PRIORITY_RANK",
           "PagePool", "PrefixCache", "Request", "ServingEngine",
           "TornArtifactError", "load_for_serving", "page_digests",
           "pages_for", "save_for_serving"]
