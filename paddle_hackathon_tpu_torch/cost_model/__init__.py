"""paddle.cost_model (the JAX package's ``cost_model/``): the analytic
FLOPs and peak behind the trainers' MFU gauge."""

from .cost_model import (CostModel, device_peak_flops,  # noqa: F401
                         train_flops_per_token)

__all__ = ["CostModel", "train_flops_per_token", "device_peak_flops"]
