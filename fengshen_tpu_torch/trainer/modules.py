"""Reusable TrainModules: the port of ``fengshen_tpu/trainer/modules.py``
(:class:`CausalLMModule`, :16)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from fengshen_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy)
from fengshen_tpu_torch.trainer.module import TrainModule


class CausalLMModule(TrainModule):
    """Causal-LM training: shift-by-one CE with -100 label masking.

    ``model`` is a port model holding its weights; ``pretrained_state``,
    when set, is a state dict that :meth:`init_params` loads instead of
    making random weights (the reference's pretrained-params hook)."""

    def __init__(self, args: Any, model, config):
        super().__init__(args)
        self.model = model
        self.config = config
        self.pretrained_state: Optional[dict] = None

    def init_params(self, generator: torch.Generator) -> torch.nn.Module:
        """Weights made from ``generator`` on the model's device, or the
        pretrained state dict when one is set."""
        if self.pretrained_state is not None:
            self.model.load_state_dict(self.pretrained_state)
        else:
            self.model.init_weights(generator)
        return self.model

    def _fused_ce_mode(self) -> str:
        """``"off"`` without ``fused_ce_chunks``; otherwise the chunked
        fused head+CE over a replicated head (the port has no tensor
        axis), which needs kernel K2."""
        return "replicated" if getattr(self.config, "fused_ce_chunks", 0) \
            else "off"

    def training_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        labels = batch.get("labels", batch["input_ids"])
        extra = {}
        if "position_ids" in batch:      # packed rows restart positions
            extra["position_ids"] = batch["position_ids"]
        mode = self._fused_ce_mode()
        if mode != "off":
            raise NotImplementedError(
                f"fused_ce_chunks={self.config.fused_ce_chunks} (fused CE "
                f"mode {mode!r}) needs kernel K2 (fused LM-head "
                "cross-entropy), not yet ported; use fused_ce_chunks=0")
        logits = self.model(batch["input_ids"],
                            attention_mask=batch.get("attention_mask"),
                            **extra)
        shifted_logits = logits[:, :-1]
        shifted_labels = labels[:, 1:]
        loss, n_tokens = vocab_parallel_cross_entropy(shifted_logits,
                                                      shifted_labels)
        with torch.no_grad():
            valid = shifted_labels != -100
            hit = (shifted_logits.argmax(-1) == shifted_labels) & valid
            acc = hit.sum() / torch.clamp(valid.sum(), min=1)
        return loss, {"acc": acc, "n_tokens": n_tokens}

    def flops_per_token(self) -> Optional[float]:
        """Forward plus backward matmul FLOPs per token, 6 x the
        parameters in the matrix products (the head included, the
        embedding table excluded), plus attention's 12 x layers x hidden
        x sequence (counted at the full sequence)."""
        cfg = self.config
        n = sum(p.numel() for name, p in self.model.named_parameters()
                if p.dim() >= 2 and "embed_tokens" not in name)
        seq = getattr(self.args, "max_seq_length", 0) or 0
        return 6.0 * n + 12.0 * cfg.num_hidden_layers * \
            cfg.hidden_size * seq
