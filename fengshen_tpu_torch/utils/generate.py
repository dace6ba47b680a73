"""KV-cached generation, sampling and speculative decoding: the port of
``fengshen_tpu/utils/generate.py`` (filters :26-150, ``generate`` :152,
``_rollback_cache`` :241, ``_prefill_cache`` :256, speculative decoding
and prompt lookup :278-677), and its seq2seq decoding: greedy and
sampled :func:`seq2seq_generate`, :func:`seq2seq_beam_search` and
:func:`seq2seq_predict_step`.

The reference runs each decode loop as one ``lax.scan`` or
``lax.while_loop`` inside jit; here each is a Python loop of eager
forwards over a lockstep :class:`KVCache` with a scalar cursor.

Random draws come from :mod:`.rng`: a draw is a pure function of the
call's ``seed``, the row and a draw counter, so sampled output cannot
match the reference's threefry bits; it matches its distributions (the
tests hold both to ``_spec_dist``'s exact probabilities). Not yet
ported: the causal-LM helpers ``sample_sequence_batch`` and
``generate_with_prompts`` (``fengshen_tpu/utils/generate.py:1137``,
``:1157``).
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional

import torch
import torch.nn.functional as F

from fengshen_tpu_torch.device import check_module_device
from fengshen_tpu_torch.models.llama.modeling_llama import (KVCache,
                                                            torch_dtype)
from fengshen_tpu_torch.utils.rng import Draws, categorical

#: stream words under a draw counter (the counterpart of the reference's
#: key splits): the token of a plain step, the speculative round's
#: accept / residual / bonus draws, and draft step ``i`` at DRAFT + i
STREAM_TOKEN, STREAM_ACCEPT, STREAM_RESIDUAL, STREAM_BONUS = 0, 1, 2, 3
STREAM_ROUND, STREAM_DRAFT = 8, 16


# -- filters and logits controls ---------------------------------------

def top_k_logits(logits: torch.Tensor, k: int = 0, p: float = 0.0,
                 filter_value: float = -1e9) -> torch.Tensor:
    """Combined top-k then nucleus filtering (``:26``)."""
    if k > 0:
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, filter_value, logits)
    if p > 0.0:
        logits = top_p_logits(logits, p, filter_value)
    return logits


def top_p_logits(logits: torch.Tensor, p: float,
                 filter_value: float = -1e9) -> torch.Tensor:
    """Nucleus filtering (``:38``): keep the smallest set of tokens with
    cumulative probability >= p (always keeps the argmax)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # mask tokens whose prefix (excluding themselves) already reaches p
    cutoff = (cum - probs) >= p
    threshold = torch.where(cutoff, torch.inf, sorted_logits).min(
        dim=-1, keepdim=True).values
    return torch.where(logits < threshold, filter_value, logits)


def _seen(history: torch.Tensor, valid: torch.Tensor,
          vocab: int) -> torch.Tensor:
    """``[N, V]`` bool: token v occurs at a valid history position."""
    return torch.zeros(history.shape[0], vocab, dtype=torch.int32,
                       device=history.device).scatter_reduce(
        1, history.long(), valid.to(torch.int32), reduce="amax").bool()


def apply_logits_controls(logits, history, cur_index, *,
                          repetition_penalty: float = 1.0,
                          no_repeat_ngram_size: int = 0,
                          min_length: int = 0,
                          eos_token_id: Optional[int] = None,
                          history_mask=None):
    """HF-``generate``-compatible logits processors (``:52``).

    ``logits [N, V]``; ``history [N, L]`` tokens so far (prompt
    included); ``cur_index``: count of valid history tokens, an int or
    an ``[N, 1]`` tensor (the serving pool's per-lane cursors);
    ``history_mask [N, L]`` marks real tokens (left-padded prompts)."""
    n_rows, vocab = logits.shape
    length = history.shape[1]
    dev = logits.device
    logits = logits.float()
    valid = torch.arange(length, device=dev)[None, :] < cur_index
    if history_mask is not None:
        valid = valid & history_mask.bool()

    if repetition_penalty != 1.0:
        penalized = torch.where(logits > 0, logits / repetition_penalty,
                                logits * repetition_penalty)
        logits = torch.where(_seen(history, valid, vocab), penalized,
                             logits)

    if no_repeat_ngram_size == 1:
        # HF semantics at size 1: ban every previously generated token
        logits = torch.where(_seen(history, valid, vocab), -1e9, logits)
    elif no_repeat_ngram_size > 1:
        n = no_repeat_ngram_size
        n_win = length - n + 1
        if n_win > 0:
            # windows [s, s+n) inside the valid prefix; candidate v is
            # banned when the last (n-1)-gram plus v matches one of them
            # (the reference slices at a scalar cursor, clamped as
            # dynamic_slice clamps)
            cur = int(cur_index)
            idx = torch.arange(n_win, device=dev)[:, None] + \
                torch.arange(n - 1, device=dev)[None, :]
            wins = history[:, idx]                            # [N, W, n-1]
            nxt_pos = torch.arange(n - 1, length, device=dev)
            nxt = history[:, nxt_pos]                         # [N, W]
            win_ok = valid[:, idx].all(-1) & valid[:, nxt_pos]
            start = min(max(cur - (n - 1), 0), length - (n - 1))
            last = history[:, start:start + n - 1]
            match = (wins == last[:, None, :]).all(-1) & win_ok
            match = match & (cur >= n - 1)
            banned = _seen(nxt, match, vocab)
            logits = torch.where(banned, -1e9, logits)

    if min_length > 0 and eos_token_id is not None:
        eos_col = torch.arange(vocab, device=dev) == eos_token_id
        logits = torch.where(eos_col[None] & (cur_index < min_length),
                             -1e9, logits)
    return logits


def _controls_active(repetition_penalty, no_repeat_ngram_size,
                     min_length) -> bool:
    return (repetition_penalty != 1.0 or no_repeat_ngram_size > 0 or
            min_length > 0)


def _make_control(control_kw: dict, history_mask=None):
    """``control(logits, history, cur_index)``: identity when no control
    is active, else :func:`apply_logits_controls` bound to the settings
    (``:122``)."""
    if not _controls_active(control_kw["repetition_penalty"],
                            control_kw["no_repeat_ngram_size"],
                            control_kw["min_length"]):
        return lambda logits, history, cur: logits
    return functools.partial(apply_logits_controls,
                             history_mask=history_mask, **control_kw)


def _filtered_logits(logits, temperature, top_k, top_p):
    """THE sampling filter pipeline (``:134``): fp32, temperature, then
    combined top-k/top-p. Shared by :func:`_select_token` and
    :func:`_spec_dist`, so the rejection scheme compares exactly the
    distribution proposals are drawn from."""
    logits = logits.float() / max(temperature, 1e-6)
    return top_k_logits(logits, k=top_k, p=top_p)


def _select_token(logits, rng: Optional[Draws] = None,
                  do_sample: bool = False, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Greedy argmax of the fp32 logits, or one draw per row from the
    filtered distribution under ``rng`` (``:144``)."""
    if not do_sample:
        return logits.float().argmax(-1)
    return categorical(rng, _filtered_logits(logits, temperature, top_k,
                                             top_p))


# -- caches ---------------------------------------------------------------

def _rollback_cache(cache: KVCache, delta) -> KVCache:
    """Lower the cache's cursor by ``delta`` (an int, or a ``[B]``
    tensor for a vector cursor), in place (``:241``). Sound because
    entries are written AT the cursor and attention reads only
    ``key_pos <= idx + t``: stale tail entries are masked and later
    overwritten."""
    cache.index = cache.index - delta
    return cache


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


def _prepare(model, input_ids, attention_mask, device):
    dev = check_module_device(model, device)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    attention_mask = torch.as_tensor(attention_mask, device=dev).long()
    return dev, input_ids, attention_mask


# -- plain decoding -------------------------------------------------------

@torch.no_grad()
def generate(model, input_ids, attention_mask=None,
             max_new_tokens: int = 32, do_sample: bool = False,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             repetition_penalty: float = 1.0, no_repeat_ngram_size: int = 0,
             min_length: int = 0, seed: int = 0,
             device=None) -> torch.Tensor:
    """Batched decode with a preallocated KV cache (``:152``).

    ``input_ids`` is LEFT-padded ``[B, S]``; ``attention_mask`` marks
    real tokens. Returns ``[B, S + max_new_tokens]`` with pad after eos.
    ``min_length`` counts the FULL sequence (prompt + generated). Row
    ``i`` samples under ``seed`` as request ``i``; step ``t`` (0 for the
    first token) is its draw counter. ``device=None`` means ``cuda``;
    the model must live on the device."""
    dev, input_ids, attention_mask = _prepare(model, input_ids,
                                              attention_mask, device)
    batch, prompt_len = input_ids.shape
    if max_new_tokens <= 0:
        return input_ids
    total_len = prompt_len + max_new_tokens
    hist_mask = F.pad(attention_mask, (0, max_new_tokens), value=1)
    control = _make_control(
        dict(repetition_penalty=repetition_penalty,
             no_repeat_ngram_size=no_repeat_ngram_size,
             min_length=min_length, eos_token_id=eos_token_id),
        history_mask=hist_mask)
    draws = Draws.for_rows(seed, batch, device=dev).sub(STREAM_TOKEN)
    select = functools.partial(_select_token, do_sample=do_sample,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p)

    position_ids = position_ids_from_mask(attention_mask)
    logits, cache = _prefill_cache(model, input_ids, attention_mask,
                                   position_ids)
    buf = torch.full((batch, total_len), pad_token_id, dtype=torch.long,
                     device=dev)
    buf[:, :prompt_len] = input_ids
    token = select(control(logits[:, -1], buf, prompt_len), draws.at(0))
    buf[:, prompt_len] = token
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    if eos_token_id is not None:
        finished |= token == eos_token_id
    pos = position_ids[:, -1] + 1
    for t in range(prompt_len + 1, total_len):
        logits = model(token[:, None], attention_mask=attention_mask,
                       position_ids=pos[:, None], cache=cache)
        nxt = select(control(logits[:, -1], buf, t),
                     draws.at(t - prompt_len))
        nxt = torch.where(finished, pad_token_id, nxt)
        if eos_token_id is not None:
            finished |= nxt == eos_token_id
        buf[:, t] = nxt
        token, pos = nxt, pos + 1
    return buf


# -- speculative decoding -------------------------------------------------

def _spec_dist(logits, temperature, top_k, top_p) -> torch.Tensor:
    """The filtered distribution :func:`_select_token` draws from, as
    fp32 probabilities (``:278``)."""
    return torch.softmax(_filtered_logits(logits, temperature, top_k,
                                          top_p), dim=-1)


def _spec_round_tokens(t_logits, d_logits, d, rng: Optional[Draws], *,
                       do_sample: bool, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 0.0):
    """One speculative round's accept/commit math (``:285``).

    ``t_logits [B, g+1, V]``: target logits over ``[last, d_1..d_g]``;
    ``d_logits [B, g, V]`` or None (greedy): draft logits for the
    proposals ``d [B, g]``. Returns ``(n_r, w)``: per-row accepted-prefix
    length and the ``[B, g+1]`` window (accepted proposals, then the
    correction or resample at the first rejection, then the bonus token,
    meaningful only on full acceptance).

    Greedy: accept while the draft equals the target argmax; ``w`` is
    the argmax. Sampling (the standard rejection scheme): accept d_i
    with probability min(1, p_i(d_i) / q_i(d_i)); at the first rejection
    resample from norm(max(0, p_i - q_i)); on full acceptance draw the
    bonus from p_{g+1}. Each row draws under its own key in ``rng``, so
    the same function serves a batch under one call seed and the serving
    pool's per-lane keys."""
    gamma = d.shape[1]
    if not do_sample:
        y = t_logits.float().argmax(-1)
        m = d == y[:, :gamma]
        n_r = torch.cumprod(m.long(), dim=1).sum(1)
        return n_r, y
    p = _spec_dist(t_logits, temperature, top_k, top_p)     # [B, g+1, V]
    q = _spec_dist(d_logits, temperature, top_k, top_p)     # [B, g, V]
    p_d = p[:, :gamma].gather(-1, d[..., None])[..., 0]
    q_d = q.gather(-1, d[..., None])[..., 0]
    # u < p/q without the division (q_d > 0: d was drawn from q)
    u = rng.sub(STREAM_ACCEPT).uniform(gamma)
    accept = u * q_d < p_d
    n_r = torch.cumprod(accept.long(), dim=1).sum(1)
    resid = torch.clamp(p[:, :gamma] - q, min=0.0)
    norm = resid.sum(-1, keepdim=True)
    # p == q empties the residual; rejection then has probability 0, but
    # keep the draw away from log(0) rows as the reference does
    resid = torch.where(norm > 0, resid / torch.clamp(norm, min=1e-20),
                        p[:, :gamma])
    resid_draws = rng.sub(STREAM_RESIDUAL)
    resample = torch.stack(
        [categorical(resid_draws.sub(i), torch.log(resid[:, i] + 1e-20))
         for i in range(gamma)], dim=1)
    bonus = categorical(rng.sub(STREAM_BONUS),
                        torch.log(p[:, gamma] + 1e-20))
    keep = torch.arange(gamma, device=d.device)[None] < n_r[:, None]
    w = torch.cat([torch.where(keep, d, resample), bonus[:, None]], dim=1)
    return n_r, w


def _spec_round_tokens_lanes(t_logits, d_logits, d, keys: Optional[Draws],
                             *, do_sample: bool, temperature: float = 1.0,
                             top_k: int = 0, top_p: float = 0.0):
    """The serving pool's per-lane form (``:340``): ``keys`` holds one
    key per lane, so a lane's accept and resample draws depend only on
    its request seed and tick. :func:`_spec_round_tokens` already draws
    row by row, so this is the same implementation of the rule."""
    if not do_sample:
        return _spec_round_tokens(t_logits, None, d, None, do_sample=False)
    if keys.keys.shape[0] != d.shape[0]:
        raise ValueError(f"{keys.keys.shape[0]} lane keys for "
                         f"{d.shape[0]} lanes")
    return _spec_round_tokens(t_logits, d_logits, d, keys, do_sample=True,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p)


def _spec_early_return(input_ids, max_new_tokens, return_stats):
    """Shared no-op path for max_new_tokens <= 0 (None = proceed)."""
    if max_new_tokens > 0:
        return None
    return (input_ids, {"rounds": 0, "drafted": 0, "accepted": 0,
                        "acceptance_rate": 0.0}) \
        if return_stats else input_ids


def _check_spec_cache_headroom(models, total_len, gamma, fn_name):
    """The verify forward near the end writes cache entries up to index
    ``total_len + gamma - 1``; a smaller cache would clamp the window's
    start and corrupt committed entries, so refuse (``:373``)."""
    for name, m in models:
        max_len = getattr(getattr(m, "config", None),
                          "max_position_embeddings", None)
        if max_len is not None and max_len < total_len + gamma:
            raise ValueError(
                f"{fn_name}: {name}.config.max_position_embeddings="
                f"{max_len} < prompt+max_new_tokens+gamma="
                f"{total_len + gamma}; the speculation window needs "
                "gamma extra cache slots")


def _speculative_loop(model, input_ids, attention_mask, max_new_tokens,
                      gamma, *, do_sample, temperature, top_k, top_p,
                      eos_token_id, pad_token_id, seed, return_stats,
                      propose, post_commit, extra_init):
    """THE propose -> verify -> commit loop (``:390``), shared by
    :func:`speculative_generate` and :func:`prompt_lookup_generate`.

    ``propose(extra, buf, t, pos, last, r_draft) -> (extra, d,
    d_logits)`` gives each round's ``[B, gamma]`` proposals (d_logits
    None when greedy); ``post_commit(extra, n) -> extra`` runs after the
    commit. Rows advance together by the minimum accepted length over
    unfinished rows; draws of round ``r`` use draw counter ``r + 1``
    (0 is the first token's)."""
    dev = input_ids.device
    batch, prompt_len = input_ids.shape
    total_len = prompt_len + max_new_tokens
    position_ids = position_ids_from_mask(attention_mask)
    draws = Draws.for_rows(seed, batch, device=dev)

    t_logits, t_cache = _prefill_cache(model, input_ids, attention_mask,
                                       position_ids)
    # slack columns keep the fixed-width window write in bounds near the
    # end, as the reference's buffer does
    buf = torch.full((batch, total_len + gamma + 1), pad_token_id,
                     dtype=torch.long, device=dev)
    buf[:, :prompt_len] = input_ids
    first = _select_token(t_logits[:, -1], draws.sub(STREAM_TOKEN),
                          do_sample, temperature, top_k, top_p)
    buf[:, prompt_len] = first
    finished = (first == eos_token_id) if eos_token_id is not None \
        else torch.zeros(batch, dtype=torch.bool, device=dev)
    last = torch.where(finished, pad_token_id, first)
    pos = position_ids[:, -1] + 1
    steps = torch.arange(gamma + 1, device=dev)[None]
    extra = extra_init
    t, rounds, accepted = prompt_len + 1, 0, 0
    while t < total_len and not bool(finished.all()):
        prev_finished = finished
        tick = draws.at(rounds + 1)
        extra, d, d_logits = propose(extra, buf, t, pos, last,
                                     tick.sub(STREAM_DRAFT))
        verify = torch.cat([last[:, None], d], dim=1)
        logits = model(verify, attention_mask=attention_mask,
                       position_ids=pos[:, None] + steps, cache=t_cache)
        n_r, w = _spec_round_tokens(
            logits, d_logits, d, tick.sub(STREAM_ROUND),
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p)
        n_r = torch.where(finished, gamma, n_r)
        n = int(n_r.min())
        c = n + 1                   # committed this round (1..gamma+1)
        if eos_token_id is not None:
            is_eos = w == eos_token_id
            after = F.pad(is_eos.long().cumsum(1)[:, :-1], (1, 0)) > 0
            w = torch.where(after, pad_token_id, w)
            finished = finished | (is_eos & (steps < c)).any(1)
        w = torch.where(prev_finished[:, None], pad_token_id, w)
        w = torch.where(steps < c, w, pad_token_id)
        buf[:, t:t + gamma + 1] = w
        last = w[:, c - 1]
        # the target cache advanced gamma+1: keep it valid through the
        # second-newest committed token
        _rollback_cache(t_cache, gamma - n)
        extra = post_commit(extra, n)
        t, pos = t + c, pos + c
        rounds, accepted = rounds + 1, accepted + n
    out = buf[:, :total_len]
    if return_stats:
        drafted = rounds * gamma
        return out, {"rounds": rounds, "drafted": drafted,
                     "accepted": accepted,
                     "acceptance_rate": accepted / max(drafted, 1)}
    return out


@torch.no_grad()
def speculative_generate(model, draft_model, input_ids,
                         attention_mask=None, max_new_tokens: int = 32,
                         gamma: int = 4, do_sample: bool = False,
                         temperature: float = 1.0, top_k: int = 0,
                         top_p: float = 0.0,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0, seed: int = 0,
                         return_stats: bool = False, device=None):
    """Speculative decoding (``:494``): each round ``draft_model``
    proposes ``gamma`` tokens, the target scores ``[last, d_1..d_g]`` in
    one forward, and the longest acceptable prefix commits plus one
    correction. Greedy output is token-identical to greedy
    :func:`generate`; sampled output follows the law of sampled
    :func:`generate` (see :func:`_spec_round_tokens`). Both models must
    live on the device."""
    if gamma < 1:
        raise ValueError("speculative decoding needs gamma >= 1")
    dev, input_ids, attention_mask = _prepare(model, input_ids,
                                              attention_mask, device)
    check_module_device(draft_model, dev)
    early = _spec_early_return(input_ids, max_new_tokens, return_stats)
    if early is not None:
        return early
    prompt_len = input_ids.shape[1]
    _check_spec_cache_headroom(
        (("model", model), ("draft_model", draft_model)),
        prompt_len + max_new_tokens, gamma, "speculative_generate")
    _, d_cache = _prefill_cache(draft_model, input_ids, attention_mask,
                                position_ids_from_mask(attention_mask))

    def propose(d_cache, buf, t, pos, last, r_draft):
        # gamma proposals, plus one more feed that keeps the draft cache
        # aligned with the target on full acceptance
        tok, props, steps = last, [], []
        for i in range(gamma + 1):
            logits = draft_model(tok[:, None], attention_mask=attention_mask,
                                 position_ids=(pos + i)[:, None],
                                 cache=d_cache)[:, -1]
            tok = _select_token(logits, r_draft.sub(i), do_sample,
                                temperature, top_k, top_p)
            props.append(tok)
            steps.append(logits)
        d = torch.stack(props[:gamma], dim=1)
        d_logits = torch.stack(steps[:gamma], dim=1) if do_sample else None
        return d_cache, d, d_logits

    return _speculative_loop(
        model, input_ids, attention_mask, max_new_tokens, gamma,
        do_sample=do_sample, temperature=temperature, top_k=top_k,
        top_p=top_p, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
        seed=seed, return_stats=return_stats, propose=propose,
        post_commit=lambda d_cache, n: _rollback_cache(d_cache, gamma - n),
        extra_init=d_cache)


def _ngram_propose_lanes(buf, t, ngram, gamma, fallback):
    """Prompt-lookup proposals with a cursor per row (``:622``): find an
    earlier occurrence of the ``ngram``-token suffix ending at ``t[b]``
    (exclusive) in row ``b`` of ``buf`` and propose the ``gamma`` tokens
    that followed it. The latest match whose whole continuation lies
    inside the committed region wins, else the latest partial match; a
    row with no match proposes ``fallback[b]`` repeated. ``t`` and
    ``fallback`` are ``[B]`` tensors."""
    batch, width = buf.shape
    dev = buf.device
    t = torch.as_tensor(t, device=dev).long().reshape(batch)
    # the suffix slice clamps its start as dynamic_slice does
    start = (t - ngram).clamp(0, width - ngram)
    suffix = buf.gather(1, start[:, None] +
                        torch.arange(ngram, device=dev)[None])
    windows = buf.unfold(1, ngram, 1)               # [B, W-ngram+1, ngram]
    match = (windows == suffix[:, None, :]).all(-1)
    pos = torch.arange(width - ngram + 1, device=dev)[None]
    # the continuation must start strictly inside the committed region
    match = match & (pos + ngram < t[:, None])
    fits = match & (pos + ngram + gamma <= t[:, None])
    none = torch.tensor(-1, device=dev)
    j_fit = torch.where(fits, pos, none).max(1).values
    j_any = torch.where(match, pos, none).max(1).values
    j = torch.where(j_fit >= 0, j_fit, j_any)       # [B], -1 = none
    idx = (j[:, None] + ngram + torch.arange(gamma, device=dev)[None]
           ).clamp(0, width - 1)
    d = buf.gather(1, idx)
    fallback = torch.as_tensor(fallback, device=dev).long().reshape(-1, 1)
    return torch.where((j >= 0)[:, None], d, fallback.expand(batch, 1))


def _ngram_propose(buf, t, ngram, gamma, pad_token_id):
    """Prompt-lookup proposals at one cursor ``t`` for every row
    (``:592``); rows with no match propose pads."""
    batch = buf.shape[0]
    return _ngram_propose_lanes(
        buf, torch.full((batch,), int(t), dtype=torch.long,
                        device=buf.device), ngram, gamma,
        torch.full((batch,), pad_token_id, dtype=torch.long,
                   device=buf.device))


@torch.no_grad()
def prompt_lookup_generate(model, input_ids, attention_mask=None,
                           max_new_tokens: int = 32, gamma: int = 4,
                           ngram: int = 2,
                           eos_token_id: Optional[int] = None,
                           pad_token_id: int = 0,
                           return_stats: bool = False, device=None):
    """Draft-free speculative decoding (``:637``): propose the
    continuation of the latest earlier occurrence of the current
    ``ngram``-token suffix and verify it with one target forward.
    Token-identical to greedy :func:`generate`."""
    if gamma < 1 or ngram < 1:
        raise ValueError("prompt lookup needs gamma >= 1 and ngram >= 1")
    dev, input_ids, attention_mask = _prepare(model, input_ids,
                                              attention_mask, device)
    early = _spec_early_return(input_ids, max_new_tokens, return_stats)
    if early is not None:
        return early
    _check_spec_cache_headroom(
        (("model", model),), input_ids.shape[1] + max_new_tokens, gamma,
        "prompt_lookup_generate")

    def propose(extra, buf, t, pos, last, r_draft):
        return extra, _ngram_propose(buf, t, ngram, gamma,
                                     pad_token_id), None

    return _speculative_loop(
        model, input_ids, attention_mask, max_new_tokens, gamma,
        do_sample=False, temperature=1.0, top_k=0, top_p=0.0,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=0,
        return_stats=return_stats, propose=propose,
        post_commit=lambda extra, n: extra, extra_init=())


# -- encoder-decoder decoding ----------------------------------------------

def _prepare_seq2seq(model, input_ids, attention_mask, device):
    """The source ids (and mask, None staying None) on the model's
    device, which must be ``device`` (None: ``cuda``)."""
    dev = check_module_device(model, device)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if attention_mask is not None:
        attention_mask = torch.as_tensor(attention_mask, device=dev).long()
    return dev, input_ids, attention_mask


def _repeat_rows(x: Optional[torch.Tensor], n: int):
    return None if x is None else x.repeat_interleave(n, dim=0)


def _make_seq2seq_logits_fn(model, input_ids, attention_mask, expand: int):
    """``logits_fn(dec_buf [N, L]) -> [N, L, V]`` for an encoder-decoder
    model, the batch repeated ``expand`` times (the beam width), as
    ``:679``: with ``encode`` and ``decode_logits`` (every family of the
    zoo) the encoder runs once and only the decoder re-runs per step;
    a model with only a full forward re-runs whole."""
    mask = _repeat_rows(attention_mask, expand)
    if hasattr(model, "encode") and hasattr(model, "decode_logits"):
        enc = _repeat_rows(model.encode(input_ids, attention_mask), expand)
        return lambda dec_buf: model.decode_logits(dec_buf, enc, mask)
    ids = _repeat_rows(input_ids, expand)
    return lambda dec_buf: model(ids, dec_buf, attention_mask=mask)


def _seq2seq_supports_cache(model) -> bool:
    """True when the model decodes over a ``Seq2SeqCache`` (``:713``):
    it makes one (``new_cache``), and its ``decode_logits`` writes the
    cache and reads the cross-attention K/V back from it
    (``cross_from_cache``, ``:827``)."""
    return hasattr(model, "encode") and hasattr(model, "new_cache")


def _takes_position_offset(model) -> bool:
    """Absolute-position decoders (the BART family) take the decode
    step's position; T5's relative bias derives it from the cache."""
    return "position_offset" in \
        inspect.signature(model.decode_logits).parameters


def _cache_capacity(model) -> int:
    """The longest decode the cache takes (``:731``): the config's
    ``decode_cache_length``, capped by ``max_position_embeddings`` for
    absolute-position decoders, whose longer decodes take the buffer
    path (which refuses them instead of clamping the position)."""
    cfg = getattr(model, "config", None)
    cap = getattr(cfg, "decode_cache_length", 512)
    if _takes_position_offset(model):
        cap = min(cap, getattr(cfg, "max_position_embeddings", cap))
    return cap


def _cached_decoder(model, enc, mask, rows: int, max_new_tokens: int):
    """``(decode, cache)``: ``decode(tok [N], offset, prime) -> [N, V]``
    gives the logits of one decoder step over ``cache``, which holds the
    ``max_new_tokens`` positions a decode feeds; the priming call
    (``prime``) projects the cross K/V into it, later calls read them
    back."""
    cache = model.new_cache(rows, max_new_tokens)
    has_pos = _takes_position_offset(model)

    def decode(tok, offset: int, prime: bool):
        kw = {"cross_from_cache": not prime}
        if has_pos:
            kw["position_offset"] = offset
        return model.decode_logits(tok[:, None], enc, mask, cache=cache,
                                   **kw)[:, -1]
    return decode, cache


@torch.no_grad()
def seq2seq_generate(model, input_ids, attention_mask=None, *,
                     max_new_tokens: int = 32,
                     decoder_start_token_id: int = 0,
                     eos_token_id: Optional[int] = None,
                     pad_token_id: int = 0, do_sample: bool = False,
                     temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 0.0, num_beams: int = 1,
                     length_penalty: float = 1.0,
                     repetition_penalty: float = 1.0,
                     no_repeat_ngram_size: int = 0, min_length: int = 0,
                     seed: int = 0, device=None) -> torch.Tensor:
    """Encoder-decoder decode (``:742``, the HF ``generate`` surface of
    the seq2seq examples): greedy or sampled with ``num_beams == 1``,
    else :func:`seq2seq_beam_search`. Returns ``[B, 1 + max_new_tokens]``
    decoder ids starting with ``decoder_start_token_id``, padded after
    eos. ``min_length`` counts decoder tokens, the start token included;
    the controls act over the decoder sequence. A decode shorter than
    :func:`_cache_capacity` runs over the model's cache, else over the
    whole buffer each step; both draw row ``i``'s token ``t`` at
    counter ``t - 1`` under ``seed``, so they sample alike. The model
    must live on ``device`` (None: ``cuda``)."""
    if num_beams > 1:
        if do_sample:
            raise ValueError(
                "beam-multinomial sampling is not supported; use either "
                "num_beams>1 (deterministic beam search) or do_sample=True")
        return seq2seq_beam_search(
            model, input_ids, attention_mask, max_new_tokens=max_new_tokens,
            decoder_start_token_id=decoder_start_token_id,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            num_beams=num_beams, length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            min_length=min_length, device=device)
    dev, input_ids, attention_mask = _prepare_seq2seq(
        model, input_ids, attention_mask, device)
    batch = input_ids.shape[0]
    length = max_new_tokens + 1
    buf = torch.full((batch, length), pad_token_id, dtype=torch.long,
                     device=dev)
    buf[:, 0] = decoder_start_token_id
    if max_new_tokens == 0:
        return buf
    control = _make_control(dict(
        repetition_penalty=repetition_penalty,
        no_repeat_ngram_size=no_repeat_ngram_size, min_length=min_length,
        eos_token_id=eos_token_id))
    draws = Draws.for_rows(seed, batch, device=dev).sub(STREAM_TOKEN)
    select = functools.partial(_select_token, do_sample=do_sample,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    cached = _seq2seq_supports_cache(model) and \
        max_new_tokens < _cache_capacity(model)
    if cached:
        # the encoder once, the cross K/V once (the priming call), then
        # one decoder token per step (:846)
        decode, _ = _cached_decoder(
            model, model.encode(input_ids, attention_mask), attention_mask,
            batch, max_new_tokens)
        tok = buf[:, 0]
    else:
        logits_fn = _make_seq2seq_logits_fn(model, input_ids,
                                            attention_mask, expand=1)
    for t in range(1, length):
        if cached:
            logits = decode(tok, t - 1, prime=t == 1)
        else:
            logits = logits_fn(buf)[:, t - 1]
        nxt = select(control(logits, buf, t), draws.at(t - 1))
        nxt = torch.where(finished, pad_token_id, nxt)
        if eos_token_id is not None:
            finished = finished | (nxt == eos_token_id)
        buf[:, t] = nxt
        tok = nxt
    return buf


_BEAM_NEG = -1e9


def _top_k(x: torch.Tensor, k: int) -> tuple:
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, ties going to the lower index (``torch.topk``
    promises no order among ties, and an unfilled beam pool holds many
    at exactly -1e9). Returns ``(values, indices)``."""
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above, tied = x > kth, x == kth
    room = k - above.sum(-1, keepdim=True)
    take = above | (tied & (tied.long().cumsum(-1) <= room))
    pos = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    # the taken positions in ascending order, then a stable sort by value
    idx = torch.topk(torch.where(take, -pos, torch.iinfo(torch.long).min),
                     k, dim=-1).indices
    vals = x.gather(-1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(-1, order), idx.gather(-1, order)


def _f32_pow(base: float, exponent: float, device) -> torch.Tensor:
    return torch.tensor(float(base), dtype=torch.float32,
                        device=device) ** exponent


def _beam_init(batch: int, K: int, length: int, pad_token_id: int,
               decoder_start_token_id: int, device) -> tuple:
    """``(alive_buf, alive_scores, fin_buf, fin_scores)``, only beam 0
    live (``:911``)."""
    alive_buf = torch.full((batch, K, length), pad_token_id,
                           dtype=torch.long, device=device)
    alive_buf[:, :, 0] = decoder_start_token_id
    alive_scores = torch.full((batch, K), _BEAM_NEG, dtype=torch.float32,
                              device=device)
    alive_scores[:, 0] = 0.0
    fin_buf = torch.full_like(alive_buf, pad_token_id)
    fin_scores = torch.full((batch, K), _BEAM_NEG, dtype=torch.float32,
                            device=device)
    return alive_buf, alive_scores, fin_buf, fin_scores


def _take_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(buf [B, M, L], idx [B, k, None], axis=1)``."""
    return buf.gather(1, idx[:, :, None].expand(-1, -1, buf.shape[2]))


def _beam_select(alive_buf, alive_scores, fin_buf, fin_scores, log_probs,
                 t: int, K: int, eos_token_id, length_penalty) -> tuple:
    """One beam step (``:922``), shared by the cached and buffer paths:
    expand the alive beams by the vocabulary, keep the top 2K
    candidates, move the eos hypotheses into the finished pool
    (length-penalised, merged top-K), re-select K alive beams. Returns
    the new pools plus ``(src_beam, tok)``: which beam each new alive
    beam extends, with what token."""
    batch, vocab = alive_buf.shape[0], log_probs.shape[-1]
    cand = (alive_scores[:, :, None] + log_probs).reshape(batch, -1)
    scores2k, idx = _top_k(cand, 2 * K)
    beam_idx, tok = idx // vocab, idx % vocab
    buf2k = _take_rows(alive_buf, beam_idx).clone()
    buf2k[:, :, t] = tok
    if eos_token_id is not None:
        is_eos = tok == eos_token_id
        pen = scores2k / _f32_pow(t, length_penalty, cand.device)
        pen = torch.where(is_eos, pen, _BEAM_NEG)
        fin_scores, fin_idx = _top_k(torch.cat([fin_scores, pen], 1), K)
        fin_buf = _take_rows(torch.cat([fin_buf, buf2k], 1), fin_idx)
        scores2k = torch.where(is_eos, _BEAM_NEG, scores2k)
    alive_scores, alive_idx = _top_k(scores2k, K)
    alive_buf = _take_rows(buf2k, alive_idx)
    return (alive_buf, alive_scores, fin_buf, fin_scores,
            beam_idx.gather(1, alive_idx), tok.gather(1, alive_idx))


def _beam_finish(alive_buf, alive_scores, fin_buf, fin_scores,
                 max_new_tokens: int, length_penalty: float):
    """The alive beams compete with the finished pool at the horizon
    length; the best sequence of each row (``:954``)."""
    horizon = _f32_pow(max_new_tokens, length_penalty, alive_buf.device)
    all_scores = torch.cat([fin_scores, alive_scores / horizon], 1)
    all_buf = torch.cat([fin_buf, alive_buf], 1)
    best = all_scores.argmax(1)
    return all_buf[torch.arange(all_buf.shape[0], device=best.device), best]


@torch.no_grad()
def seq2seq_beam_search(model, input_ids, attention_mask=None, *,
                        max_new_tokens: int = 32,
                        decoder_start_token_id: int = 0,
                        eos_token_id: Optional[int] = None,
                        pad_token_id: int = 0, num_beams: int = 4,
                        length_penalty: float = 1.0,
                        repetition_penalty: float = 1.0,
                        no_repeat_ngram_size: int = 0,
                        min_length: int = 0, device=None) -> torch.Tensor:
    """Beam search over an encoder-decoder model (``:1072``). A
    hypothesis ending with eos at generated length ``t`` (the start token
    excluded, eos included) scores ``sum_logprobs / t ** length_penalty``;
    alive beams at the horizon score so at ``t = max_new_tokens``. The
    logits controls act on the log-probabilities, as HF's beam search
    runs its processors. A decode shorter than :func:`_cache_capacity`
    runs over the cache (``:966``; a reorder gathers only the
    self-attention rows), else over the whole buffer. Returns the best
    sequence of each row, ``[B, 1 + max_new_tokens]``."""
    dev, input_ids, attention_mask = _prepare_seq2seq(
        model, input_ids, attention_mask, device)
    batch = input_ids.shape[0]
    if max_new_tokens == 0:
        return torch.full((batch, 1), decoder_start_token_id,
                          dtype=torch.long, device=dev)
    K, length = num_beams, max_new_tokens + 1
    N = batch * K
    row_control = _make_control(dict(
        repetition_penalty=repetition_penalty,
        no_repeat_ngram_size=no_repeat_ngram_size, min_length=min_length,
        eos_token_id=eos_token_id))

    def control(log_probs, alive_buf, cur):
        return row_control(log_probs.reshape(N, -1),
                           alive_buf.reshape(N, length),
                           cur).reshape(batch, K, -1)

    pools = _beam_init(batch, K, length, pad_token_id,
                       decoder_start_token_id, dev)
    cached = _seq2seq_supports_cache(model) and \
        max_new_tokens < _cache_capacity(model)
    if cached:
        enc = _repeat_rows(model.encode(input_ids, attention_mask), K)
        decode, cache = _cached_decoder(model, enc,
                                        _repeat_rows(attention_mask, K), N,
                                        max_new_tokens)
        last_tok = torch.full((batch, K), decoder_start_token_id,
                              dtype=torch.long, device=dev)
        rows = torch.arange(batch, device=dev)[:, None] * K
    else:
        logits_fn = _make_seq2seq_logits_fn(model, input_ids,
                                            attention_mask, expand=K)
    for t in range(1, length):
        alive_buf = pools[0]
        if cached:
            # last_tok was selected at step t-1 and sits at position t-1
            logits = decode(last_tok.reshape(N), t - 1, prime=t == 1)
        else:
            logits = logits_fn(alive_buf.reshape(N, length))[:, t - 1]
        log_probs = control(torch.log_softmax(logits.float(), dim=-1)
                            .reshape(batch, K, -1), alive_buf, t)
        *pools, src_beam, last_tok = _beam_select(
            *pools, log_probs, t, K, eos_token_id, length_penalty)
        if cached:
            cache.reorder((rows + src_beam).reshape(-1))
    return _beam_finish(*pools, max_new_tokens, length_penalty)


def seq2seq_predict_step(model, config, args, batch: dict, *,
                         max_new_tokens: int) -> torch.Tensor:
    """The ``predict_step`` body of the seq2seq example modules
    (``:1054``): beam or greedy decode driven by the parsed flags
    (``--num_beams``, ``--length_penalty`` and the controls), on the
    batch's device."""
    return seq2seq_generate(
        model, batch["input_ids"], batch.get("attention_mask"),
        max_new_tokens=max_new_tokens,
        decoder_start_token_id=getattr(config, "decoder_start_token_id", 0),
        eos_token_id=getattr(config, "eos_token_id", None),
        pad_token_id=getattr(config, "pad_token_id", 0) or 0,
        num_beams=getattr(args, "num_beams", 1),
        length_penalty=getattr(args, "length_penalty", 1.0),
        repetition_penalty=getattr(args, "repetition_penalty", 1.0),
        no_repeat_ngram_size=getattr(args, "no_repeat_ngram_size", 0),
        min_length=getattr(args, "min_length", 0),
        device=batch["input_ids"].device)
