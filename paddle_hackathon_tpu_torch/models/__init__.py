from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_config

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "gpt_config"]
