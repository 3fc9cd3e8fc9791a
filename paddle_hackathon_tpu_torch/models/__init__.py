from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   ErnieForPretraining, ErnieForSequenceClassification,
                   ErnieModel, bert_config, bert_mlm_pipeline,
                   bert_param_sharding_spec, ernie_config, masked_mlm_loss)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_config,
                  param_sharding_spec)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel",
           "ErnieForPretraining", "ErnieForSequenceClassification",
           "ErnieModel", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "bert_config", "bert_mlm_pipeline", "bert_param_sharding_spec",
           "ernie_config", "gpt_config", "masked_mlm_loss",
           "param_sharding_spec"]
