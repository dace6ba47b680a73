from fengshen_tpu_torch.models.llama.configuration_llama import LlamaConfig
from fengshen_tpu_torch.models.llama.convert import (load_hf_pretrained,
                                                     lora_from_jax,
                                                     params_from_jax,
                                                     params_to_numpy,
                                                     torch_to_params)
from fengshen_tpu_torch.models.llama.modeling_llama import (
    CacheView, KVCache, LlamaAttention, LlamaDecoderLayer, LlamaForCausalLM,
    LlamaMLP, LlamaModel, make_self_draft)

__all__ = ["LlamaConfig", "load_hf_pretrained", "lora_from_jax",
           "params_from_jax",
           "params_to_numpy", "torch_to_params",
           "CacheView", "KVCache", "LlamaAttention", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel", "make_self_draft"]
