"""paddle.inference in the port: the deployment surface over the serving
engine (the JAX package's ``inference/``).

- ``Config`` / ``AnalysisConfig`` and ``PassBuilder`` (``config.py``), and
  ``create_predictor`` / ``Predictor`` / ``PredictorPool`` with the
  zero-copy handle ``InferTensor`` (``predictor.py``), over a
  ``save_for_serving`` artifact;
- the continuous-batching ``ServingEngine`` and its artifact
  (``serving.py``), the paged-KV host bookkeeping (``paged.py``);
- the serving fleet (``fleet.py``): a health-driven router over engine
  replicas (failover, deadlines, retry and backoff, graceful drain,
  per-token streaming);
- the speculative-decoding drafters, re-exported from ``nn/decode.py``
  because serving is where users reach for them.
"""

from ..nn.decode import ModelDrafter, NGramDrafter
from .config import AnalysisConfig, Config, PassBuilder
from .fleet import (CircuitBreaker, FleetRequest, FleetRouter,
                    NoReplicaAvailableError, StreamInterruptedError)
from .paged import PagePool, PrefixCache, page_digests, pages_for
from .predictor import (Predictor, PredictorPool, create_predictor,
                        get_version)
from .predictor import Tensor as InferTensor
from .serving import (PRIORITY_RANK, DeadlineExceededError, EngineDraining,
                      Request, ServingEngine, TornArtifactError,
                      load_for_serving, save_for_serving)

__all__ = [
    "Config", "AnalysisConfig", "PassBuilder", "Predictor", "PredictorPool",
    "InferTensor", "create_predictor", "get_version",
    "Request", "ServingEngine", "NGramDrafter", "ModelDrafter",
    "PagePool", "PrefixCache", "pages_for", "page_digests",
    "FleetRouter", "FleetRequest", "CircuitBreaker",
    "DeadlineExceededError", "EngineDraining",
    "NoReplicaAvailableError", "StreamInterruptedError",
    "PRIORITY_RANK", "TornArtifactError", "load_for_serving",
    "save_for_serving",
]
