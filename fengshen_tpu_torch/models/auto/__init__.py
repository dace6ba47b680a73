"""Auto classes: the port of ``fengshen_tpu/models/auto`` (a lazy
model/config/tokenizer registry keyed by ``model_type``)."""

from fengshen_tpu_torch.models.auto.auto_factory import (AutoConfig,
                                                         AutoModel,
                                                         AutoTokenizer,
                                                         register_model)

__all__ = ["AutoConfig", "AutoModel", "AutoTokenizer", "register_model"]
