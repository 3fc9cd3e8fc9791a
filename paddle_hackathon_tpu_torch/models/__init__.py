from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_config,
                  param_sharding_spec)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "gpt_config",
           "param_sharding_spec"]
