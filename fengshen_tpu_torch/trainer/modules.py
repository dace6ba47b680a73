"""Reusable TrainModules: the port of ``fengshen_tpu/trainer/modules.py``
(:class:`CausalLMModule`, :16)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from fengshen_tpu_torch.ops.kernels.fused_ce import fused_ce_loss
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
        """Which path :meth:`training_loss` takes (the reference's
        ``_fused_ce_mode``, :46): ``"off"`` without ``fused_ce_chunks``
        (logits, then CE); ``"replicated"`` with them and no tensor axis
        (the fused head + CE through the seam of kernel K2, as the
        reference's docstring has it; its code runs the chunked scan,
        the same function); ``"vocab_parallel"`` with a tensor degree
        above 1, which the port does not run yet."""
        if not getattr(self.config, "fused_ce_chunks", 0):
            return "off"
        tensor = getattr(self.args, "tensor_model_parallel_size", 1) or 1
        return "replicated" if tensor <= 1 else "vocab_parallel"

    def _lm_head_kernel(self) -> torch.Tensor:
        """The ``[H, V]`` head for the fused path (:60): the tied
        embedding or the ``lm_head`` weight, transposed."""
        model = self.model
        if getattr(self.config, "tie_word_embeddings", False):
            return model.model.embed_tokens.weight.T
        return model.lm_head.weight.T

    def training_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        labels = batch.get("labels", batch["input_ids"])
        extra = {}
        if "position_ids" in batch:      # packed rows restart positions
            extra["position_ids"] = batch["position_ids"]
        mode = self._fused_ce_mode()
        if mode == "vocab_parallel":
            raise NotImplementedError(
                "fused_ce_chunks over a tensor-parallel head (fused CE "
                "mode 'vocab_parallel') is not yet ported (ROADMAP.md "
                "queue 1 item 9: parallelism)")
        if mode == "replicated":
            hidden = self.model(batch["input_ids"],
                                attention_mask=batch.get("attention_mask"),
                                return_hidden=True, **extra)
            kernel = self._lm_head_kernel().to(hidden.dtype)
            # causal_fused_loss's shift, then the K2 seam
            loss, n_tokens, n_correct = fused_ce_loss(
                hidden[:, :-1], kernel, labels[:, 1:],
                num_chunks=self.config.fused_ce_chunks)
            acc = n_correct / torch.clamp(n_tokens, min=1)
            return loss, {"acc": acc, "n_tokens": n_tokens}
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
        x sequence (counted at the full sequence: ``--max_seq_length``,
        else the config's ``max_position_embeddings``)."""
        cfg = self.config
        n = sum(p.numel() for name, p in self.model.named_parameters()
                if p.dim() >= 2 and "embed_tokens" not in name)
        seq = getattr(self.args, "max_seq_length", 0) or \
            getattr(cfg, "max_position_embeddings", 0) or 0
        return 6.0 * n + 12.0 * cfg.num_hidden_layers * \
            cfg.hidden_size * seq
