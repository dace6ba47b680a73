from fengshen_tpu_torch.models.llama.configuration_llama import LlamaConfig
from fengshen_tpu_torch.models.llama.convert import (params_from_jax,
                                                     params_to_numpy)
from fengshen_tpu_torch.models.llama.modeling_llama import (
    CacheView, KVCache, LlamaAttention, LlamaDecoderLayer, LlamaForCausalLM,
    LlamaMLP, LlamaModel, make_self_draft)

__all__ = ["LlamaConfig", "params_from_jax", "params_to_numpy",
           "CacheView", "KVCache", "LlamaAttention", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel", "make_self_draft"]
