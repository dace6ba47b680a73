"""Reusable TrainModules: the port of ``fengshen_tpu/trainer/modules.py``
(:class:`CausalLMModule`, :16; :class:`LoraTrainModule`, :249, with
:func:`add_lora_args` and :func:`maybe_wrap_lora`)."""

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


class LoraTrainModule(TrainModule):
    """LoRA fine-tuning of any TrainModule (:249). ``init_params`` makes
    (or loads) the inner module's weights, then adapts the projections
    ``target_regex`` selects (``ops/lora.init_lora``: the merge happens
    inside each layer's forward). Every base parameter is frozen
    (``requires_grad=False``, the reference's ``stop_gradient``) except
    those matching ``train_regex``, which train fully (the
    ``modules_to_save`` of standard LoRA: a random-init head frozen
    would leave the logits a fixed random projection). The optimizer
    then holds moments for the trainable tensors only, with the
    no-decay mask of ``model_utils.configure_optimizers``; ``grad_norm``
    and clipping cover the same tensors. ``pretrained_lora`` (the
    adapter entries of ``convert.lora_from_jax``) replaces the drawn
    adapters. ``python -m fengshen_tpu_torch.ops.lora`` merges a
    checkpoint of this module into a servable directory."""

    def __init__(self, inner: TrainModule, rank: int,
                 alpha: Optional[float] = None,
                 target_regex: str = r"(q_proj|k_proj|v_proj|o_proj)",
                 train_regex: Optional[str] = None):
        super().__init__(inner.args)
        self.inner = inner
        self.rank, self.alpha, self.target_regex = rank, alpha, \
            target_regex
        self.train_regex = train_regex
        self.model = getattr(inner, "model", None)
        self.config = getattr(inner, "config", None)
        self.pretrained_lora: Optional[dict] = None

    def setup(self, stage: str = "fit") -> None:
        self.inner.setup(stage)

    def init_params(self, generator: torch.Generator) -> torch.nn.Module:
        from fengshen_tpu_torch.ops.lora import (init_lora,
                                                 train_path_matches)
        model = self.inner.init_params(generator)
        init_lora(model, generator, self.rank, self.target_regex,
                  alpha=self.alpha)
        if self.pretrained_lora is not None:
            _, unexpected = model.load_state_dict(
                self.pretrained_lora, strict=False)
            adapters = {k for k in model.state_dict()
                        if k.rsplit(".", 1)[-1] in
                        ("lora_a", "lora_b", "lora_scale")}
            if unexpected or adapters - set(self.pretrained_lora):
                lost = sorted(adapters - set(self.pretrained_lora))
                raise KeyError(f"pretrained_lora does not fit the adapted "
                               f"model: unexpected {unexpected[:4]}, "
                               f"missing {lost[:4]}")
        base_names = [n for n, _ in model.named_parameters()
                      if n.rsplit(".", 1)[-1] not in ("lora_a", "lora_b")]
        if self.train_regex and not any(
                train_path_matches(n, self.train_regex)
                for n in base_names):
            raise ValueError(
                f"lora train_regex {self.train_regex!r} matches no "
                "base parameter (--lora_train_modules typo?)")
        for name, p in model.named_parameters():
            p.requires_grad_(name.rsplit(".", 1)[-1] in ("lora_a", "lora_b")
                             or train_path_matches(name, self.train_regex))
        self.model = model
        return model

    def training_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        return self.inner.training_loss(batch)

    def validation_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        return self.inner.validation_loss(batch)

    def predict_step(self, batch: dict, **kw):
        hook = getattr(self.inner, "predict_step", None)
        if hook is None:
            raise AttributeError(
                f"{type(self.inner).__name__} defines no predict_step")
        return hook(batch, **kw)

    def flops_per_token(self) -> Optional[float]:
        return self.inner.flops_per_token()

    def tokens_in_batch(self, batch) -> int:
        return self.inner.tokens_in_batch(batch)


def add_lora_args(parser, targets_default: str,
                  train_default: Optional[str] = None):
    """The shared ``--lora_*`` flags (:375)."""
    parser.add_argument(
        "--lora_rank", default=0, type=int,
        help="LoRA fine-tuning: freeze the base model and train rank-r "
             "adapters (merge back with `python -m "
             "fengshen_tpu_torch.ops.lora`). 0 = full fine-tune")
    parser.add_argument("--lora_alpha", default=None, type=float,
                        help="LoRA scale numerator (default 2*rank)")
    parser.add_argument(
        "--lora_targets", default=targets_default, type=str,
        help="regex over projection paths (model/layers/0/self_attn/"
             "q_proj) selecting the ones that get adapters")
    parser.add_argument(
        "--lora_train_modules", default=train_default, type=str,
        help="regex of base parameters (lm_head/weight) to train fully "
             "alongside the adapters")
    return parser


def maybe_wrap_lora(module: TrainModule, args) -> TrainModule:
    """``module`` in a :class:`LoraTrainModule` when ``--lora_rank`` is
    set (:394), refusing ``--offload_params`` with it as the reference
    does."""
    if not getattr(args, "lora_rank", 0):
        return module
    if getattr(args, "offload_params", False):
        raise ValueError("--lora_rank already shrinks optimizer state "
                         "to the adapters; combine with "
                         "--offload_optimizer if needed, not "
                         "--offload_params")
    return LoraTrainModule(module, rank=args.lora_rank,
                           alpha=getattr(args, "lora_alpha", None),
                           target_regex=args.lora_targets,
                           train_regex=getattr(args, "lora_train_modules",
                                               None))
