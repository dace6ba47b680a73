"""Greedy KV-cached generation: the port of
``fengshen_tpu/utils/generate.py`` (``_select_token`` :144, greedy
``generate`` :152, ``_prefill_cache`` :256).

The reference runs the decode loop as one ``lax.scan`` inside jit; here
it is a Python loop of eager forwards over a lockstep :class:`KVCache`
with a scalar cursor. Sampling and the logits controls are not yet
ported and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from fengshen_tpu_torch.device import check_module_device
from fengshen_tpu_torch.models.llama.modeling_llama import (KVCache,
                                                            torch_dtype)


def _select_token(logits: torch.Tensor, do_sample: bool = False
                  ) -> torch.Tensor:
    """Greedy selection: argmax of the fp32 logits."""
    if do_sample:
        raise NotImplementedError("sampling is not yet ported")
    return logits.float().argmax(-1)


def _prefill_cache(model, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor,
                   position_ids: torch.Tensor,
                   max_len: Optional[int] = None):
    """Make a zeros lockstep cache of ``max_len`` positions (default: the
    model's ``max_position_embeddings``) and run the prompt through it.
    Returns (prompt logits, primed cache)."""
    cfg = model.config
    cache = KVCache.zeros(cfg, input_ids.shape[0],
                          max_len or cfg.max_position_embeddings,
                          device=input_ids.device,
                          dtype=torch_dtype(cfg.dtype))
    logits = model(input_ids, attention_mask=attention_mask,
                   position_ids=position_ids, cache=cache)
    return logits, cache


def position_ids_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Left-pad aware positions: ``clip(cumsum(mask) - 1, 0)``."""
    return (attention_mask.long().cumsum(-1) - 1).clamp(min=0)


def _check_controls(do_sample, repetition_penalty, no_repeat_ngram_size,
                    min_length) -> None:
    if do_sample:
        raise NotImplementedError("sampling is not yet ported")
    if repetition_penalty != 1.0 or no_repeat_ngram_size or min_length:
        raise NotImplementedError("logits controls are not yet ported")


@torch.no_grad()
def generate(model, input_ids, attention_mask=None,
             max_new_tokens: int = 32, do_sample: bool = False,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             repetition_penalty: float = 1.0, no_repeat_ngram_size: int = 0,
             min_length: int = 0, device=None) -> torch.Tensor:
    """Greedy batched decode with a preallocated KV cache.

    ``input_ids`` is LEFT-padded ``[B, S]``; ``attention_mask`` marks real
    tokens. Returns ``[B, S + max_new_tokens]`` with pad after eos.
    ``device=None`` means ``cuda``; the model must live on the device."""
    dev = check_module_device(model, device)
    _check_controls(do_sample, repetition_penalty, no_repeat_ngram_size,
                    min_length)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    batch, prompt_len = input_ids.shape
    if max_new_tokens <= 0:
        return input_ids
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    attention_mask = torch.as_tensor(attention_mask, device=dev).long()
    total_len = prompt_len + max_new_tokens

    position_ids = position_ids_from_mask(attention_mask)
    logits, cache = _prefill_cache(model, input_ids, attention_mask,
                                   position_ids)
    buf = torch.full((batch, total_len), pad_token_id, dtype=torch.long,
                     device=dev)
    buf[:, :prompt_len] = input_ids
    token = _select_token(logits[:, -1])
    buf[:, prompt_len] = token
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    if eos_token_id is not None:
        finished |= token == eos_token_id
    pos = position_ids[:, -1] + 1
    for t in range(prompt_len + 1, total_len):
        logits = model(token[:, None], attention_mask=attention_mask,
                       position_ids=pos[:, None], cache=cache)
        nxt = _select_token(logits[:, -1])
        nxt = torch.where(finished, pad_token_id, nxt)
        if eos_token_id is not None:
            finished |= nxt == eos_token_id
        buf[:, t] = nxt
        token, pos = nxt, pos + 1
    return buf
