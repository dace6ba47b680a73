"""Sampling, logits controls and speculative decoding in the port, on the
CPU, held to the JAX package (``fengshen_tpu/utils/generate.py``).

- Filters and controls (``top_k_logits``, ``top_p_logits``,
  ``_filtered_logits``, ``apply_logits_controls``) against the JAX
  functions on the same seeded numpy inputs, left-padded histories
  included: within ``FILTER_ATOL`` (fp32; the outputs are the inputs or
  the filter value, so only rounding of the division and penalty moves
  them).
- Greedy speculative math (``_spec_round_tokens``, ``_ngram_propose``,
  ``_ngram_propose_lanes``) exactly against JAX.
- Sampled laws: the port's draws cannot match threefry's bits, so the
  sampled accept rule and the sampler are held to JAX's ``_spec_dist``
  exact probabilities over ``N_DRAWS`` independent rows: total variation
  at most ``TV_TOL`` = 0.02 (mirroring
  ``tests/test_speculative_decode.py:136``; the sampling noise of a
  histogram over 8 tokens at these counts is ~0.01).
- RNG purity: a row's draws depend only on its key, counter and stream.
- Offline loops: ``speculative_generate`` and ``prompt_lookup_generate``
  greedy give the port's greedy ``generate`` tokens and JAX's.
- ``make_self_draft`` aliases the target's tensors (``data_ptr``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fengshen_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from fengshen_tpu.models.llama import LlamaForCausalLM as JaxLlama
from fengshen_tpu_torch.models.llama import (KVCache, LlamaConfig,
                                             LlamaForCausalLM,
                                             make_self_draft,
                                             params_from_jax)
from fengshen_tpu_torch.serving import rollback_slots
from fengshen_tpu_torch.utils import generate as pg
from fengshen_tpu_torch.utils.rng import (Draws, _mix32, categorical,
                                          fold_in, key_from_seed, lane_key,
                                          unit_interval)

#: the module (the package re-exports its ``generate`` function under the
#: module's name)
jg = importlib.import_module("fengshen_tpu.utils.generate")

FILTER_ATOL = 1e-6
TV_TOL = 0.02
N_DRAWS = 40_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tv(hist: np.ndarray, probs: np.ndarray) -> float:
    return 0.5 * float(np.abs(hist - probs).sum())


def _law(tokens, vocab: int) -> np.ndarray:
    tokens = np.asarray(tokens)
    return np.bincount(tokens, minlength=vocab) / max(len(tokens), 1)


# -- filters and controls -------------------------------------------------

FILTERS = [(1.0, 0, 0.5), (1.0, 3, 0.0), (0.7, 8, 0.9), (2.0, 1, 0.0),
           (1.0, 5, 0.3), (0.5, 0, 0.95)]


@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS)
def test_filters_match_jax(temperature, top_k, top_p):
    logits = (np.random.RandomState(top_k).randn(6, 40) * 3).astype(
        np.float32)
    want = np.asarray(jg._filtered_logits(jnp.asarray(logits), temperature,
                                          top_k, top_p))
    got = pg._filtered_logits(torch.from_numpy(logits), temperature, top_k,
                              top_p).numpy()
    np.testing.assert_allclose(got, want, atol=FILTER_ATOL,
                               rtol=FILTER_ATOL)
    if top_p:
        np.testing.assert_array_equal(
            pg.top_p_logits(torch.from_numpy(logits), top_p).numpy(),
            np.asarray(jg.top_p_logits(jnp.asarray(logits), top_p)))
    if top_k:
        np.testing.assert_array_equal(
            pg.top_k_logits(torch.from_numpy(logits), top_k).numpy(),
            np.asarray(jg.top_k_logits(jnp.asarray(logits), top_k)))


CONTROLS = [dict(repetition_penalty=1.3), dict(no_repeat_ngram_size=1),
            dict(no_repeat_ngram_size=2), dict(no_repeat_ngram_size=3),
            dict(min_length=20),
            dict(repetition_penalty=1.2, no_repeat_ngram_size=2,
                 min_length=20)]


def _history(seed=0, rows=5, length=24, vocab=12, pad=(0, 3, 5, 1, 8)):
    """Histories over a small vocabulary (so n-grams repeat), the first
    ``pad[i]`` positions of row i left padding (token 0, mask 0)."""
    rng = np.random.RandomState(seed)
    hist = rng.randint(1, vocab, (rows, length)).astype(np.int32)
    mask = np.ones((rows, length), np.int32)
    for i, n in enumerate(pad[:rows]):
        hist[i, :n] = 0
        mask[i, :n] = 0
    return hist, mask


@pytest.mark.parametrize("kw", CONTROLS)
def test_logits_controls_match_jax(kw):
    """The reference's processors at a scalar cursor (``generate``'s
    form), over left-padded histories, with eos for min_length."""
    hist, mask = _history()
    logits = (np.random.RandomState(1).randn(5, 12) * 2).astype(np.float32)
    for cur in (18, 24):
        want = jg.apply_logits_controls(
            jnp.asarray(logits), jnp.asarray(hist), jnp.int32(cur),
            eos_token_id=7, history_mask=jnp.asarray(mask), **kw)
        got = pg.apply_logits_controls(
            torch.from_numpy(logits), torch.from_numpy(hist), cur,
            eos_token_id=7, history_mask=torch.from_numpy(mask), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FILTER_ATOL, rtol=FILTER_ATOL)


@pytest.mark.parametrize("kw", CONTROLS[:2] + CONTROLS[4:5])
def test_logits_controls_per_lane_cursor_match_jax(kw):
    """The serving pool's form: one cursor per row (``[N, 1]``)."""
    hist, mask = _history(seed=2)
    logits = (np.random.RandomState(3).randn(5, 12) * 2).astype(np.float32)
    cur = np.array([[4], [9], [17], [24], [12]], np.int32)
    want = jg.apply_logits_controls(
        jnp.asarray(logits), jnp.asarray(hist), jnp.asarray(cur),
        eos_token_id=7, history_mask=jnp.asarray(mask), **kw)
    got = pg.apply_logits_controls(
        torch.from_numpy(logits), torch.from_numpy(hist),
        torch.from_numpy(cur).long(), eos_token_id=7,
        history_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FILTER_ATOL, rtol=FILTER_ATOL)


def test_make_control_is_identity_when_inactive():
    kw = dict(repetition_penalty=1.0, no_repeat_ngram_size=0, min_length=0,
              eos_token_id=None)
    assert not pg._controls_active(1.0, 0, 0)
    assert pg._controls_active(1.0, 1, 0) and pg._controls_active(1.1, 0, 0)
    logits = torch.randn(2, 5)
    assert pg._make_control(kw)(logits, None, 3) is logits
    hist, mask = _history(rows=2, length=6, vocab=5, pad=(0, 2))
    active = pg._make_control(dict(kw, repetition_penalty=1.5),
                              history_mask=torch.from_numpy(mask))
    want = jg._make_control(dict(kw, repetition_penalty=1.5),
                            history_mask=jnp.asarray(mask))(
        jnp.asarray(logits.numpy()), jnp.asarray(hist), jnp.int32(6))
    np.testing.assert_allclose(active(logits, torch.from_numpy(hist), 6),
                               np.asarray(want), atol=FILTER_ATOL)


# -- greedy speculative math ---------------------------------------------

def test_spec_round_tokens_greedy_matches_jax():
    rng = np.random.RandomState(4)
    t_logits = rng.randn(6, 5, 30).astype(np.float32)
    d = t_logits[:, :4].argmax(-1).astype(np.int32)
    for row, at in enumerate((0, 1, 2, 3, 4, 2)):
        if at < 4:                         # row mismatches from ``at`` on
            d[row, at] = (d[row, at] + 1) % 30
    want = jg._spec_round_tokens(jnp.asarray(t_logits), None,
                                 jnp.asarray(d), None, do_sample=False)
    got = pg._spec_round_tokens(torch.from_numpy(t_logits), None,
                                torch.from_numpy(d).long(), None,
                                do_sample=False)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), [0, 1, 2, 3, 4, 2])
    lanes = pg._spec_round_tokens_lanes(
        torch.from_numpy(t_logits), None, torch.from_numpy(d).long(), None,
        do_sample=False)
    for a, b in zip(lanes, got):
        assert torch.equal(a, b)


def test_spec_round_tokens_hand_computed():
    """The reference's hand-computed cases (``:91``), sampled ones
    included: degenerate one-hot p and q decide every draw."""
    targets = np.array([[7, 9, 8, 1], [5, 4, 3, 2], [6, 6, 6, 6]])
    t_logits = torch.from_numpy(np.eye(12, dtype=np.float32)[targets])
    d = torch.tensor([[7, 9, 9], [9, 4, 3], [6, 6, 6]])
    n_r, w = pg._spec_round_tokens(t_logits, None, d, None, do_sample=False)
    assert n_r.tolist() == [2, 0, 3] and w.tolist() == targets.tolist()
    big = 50.0
    draws = Draws.for_rows(1, 1)
    q_log = torch.from_numpy(np.eye(4, dtype=np.float32)[[0, 0]])[None] * big
    p_log = torch.from_numpy(np.eye(4, dtype=np.float32)[[1, 1]])[None] * big
    t3 = torch.cat([p_log, p_log[:, :1]], dim=1)
    n_r, w = pg._spec_round_tokens(t3, q_log, torch.zeros(1, 2).long(),
                                   draws, do_sample=True)
    assert int(n_r[0]) == 0 and int(w[0, 0]) == 1
    pq = torch.from_numpy(np.eye(4, dtype=np.float32)[[2, 2, 2]])[None] * big
    n_r, w = pg._spec_round_tokens(pq, pq[:, :2], torch.full((1, 2), 2),
                                   draws, do_sample=True)
    assert int(n_r[0]) == 2 and w.tolist() == [[2, 2, 2]]


def _ngram_bufs(seed, rows=4, width=24, vocab=4):
    rng = np.random.RandomState(seed)
    return rng.randint(1, vocab, (rows, width)).astype(np.int32)


@pytest.mark.parametrize("ngram,gamma", [(1, 3), (2, 4), (3, 2)])
def test_ngram_propose_matches_jax(ngram, gamma):
    buf = _ngram_bufs(ngram)
    for t in (ngram + 1, 9, 17, 24):
        want = jg._ngram_propose(jnp.asarray(buf), jnp.int32(t), ngram,
                                 gamma, 0)
        got = pg._ngram_propose(torch.from_numpy(buf).long(), t, ngram,
                                gamma, 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = np.array([3, 11, 20, 24], np.int32)
    fallback = np.array([5, 6, 7, 8], np.int32)
    want = jg._ngram_propose_lanes(jnp.asarray(buf), jnp.asarray(t), ngram,
                                   gamma, jnp.asarray(fallback))
    got = pg._ngram_propose_lanes(torch.from_numpy(buf).long(),
                                  torch.from_numpy(t).long(), ngram, gamma,
                                  torch.from_numpy(fallback).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ngram_propose_mechanics():
    """The reference's cases (``:267``): latest earlier match, pads on no
    match, and the fit preference on a period-1 loop."""
    buf = torch.tensor([[5, 6, 9, 5, 6, 7, 5, 6, 0, 0, 0, 0],
                        [1, 2, 3, 4, 5, 6, 7, 8, 0, 0, 0, 0]])
    d = pg._ngram_propose(buf, 8, ngram=2, gamma=3, pad_token_id=0)
    assert d.tolist() == [[7, 5, 6], [0, 0, 0]]
    loop = torch.tensor([[9, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0]])
    assert pg._ngram_propose(loop, 7, 2, 3, 0).tolist() == [[4, 4, 4]]


# -- sampled laws ----------------------------------------------------------

SAMPLED = [(1.0, 0, 0.0), (0.8, 5, 0.9)]


@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLED)
def test_sampled_spec_round_law_matches_spec_dist(temperature, top_k,
                                                  top_p):
    """The port's rejection rule on ``N_DRAWS`` independent rows sharing
    one mismatched (p, q) pair over V = 8, gamma = 2 (rejections happen
    at both positions): position 0 follows
    JAX's p_0, position 1 given an accepted position 0 follows p_1, and
    the bonus given full acceptance follows p_2, each within TV_TOL."""
    vocab, gamma = 8, 2
    rng = np.random.RandomState(7)
    t_log = rng.randn(1, gamma + 1, vocab).astype(np.float32)
    # a draft near the target (as a real one is), so that thousands of
    # rows reach full acceptance and power the bonus histogram
    d_log = (t_log[:, :gamma] +
             0.6 * rng.randn(1, gamma, vocab)).astype(np.float32)
    p = np.asarray(jg._spec_dist(jnp.asarray(t_log), temperature, top_k,
                                 top_p))[0]
    q = np.asarray(jg._spec_dist(jnp.asarray(d_log), temperature, top_k,
                                 top_p))[0]
    t_logits = torch.from_numpy(t_log).expand(N_DRAWS, -1, -1)
    d_logits = torch.from_numpy(d_log).expand(N_DRAWS, -1, -1)
    np.testing.assert_allclose(
        pg._spec_dist(d_logits[:1], temperature, top_k, top_p)[0].numpy(),
        q, atol=1e-6)
    rows = Draws.for_rows(11, N_DRAWS)
    d = torch.stack([categorical(rows.sub(100 + i),
                                 torch.log(torch.tensor(q[i]))
                                 .expand(N_DRAWS, -1))
                     for i in range(gamma)], dim=1)
    n_r, w = pg._spec_round_tokens(
        t_logits, d_logits, d, Draws.for_rows(12, N_DRAWS),
        do_sample=True, temperature=temperature, top_k=top_k, top_p=top_p)
    n_r, w = n_r.numpy(), w.numpy()
    assert _tv(_law(w[:, 0], vocab), p[0]) <= TV_TOL
    sel = n_r >= 1
    assert sel.sum() > 5000
    assert _tv(_law(w[sel, 1], vocab), p[1]) <= TV_TOL
    full = n_r == gamma
    assert full.sum() > 2000
    assert _tv(_law(w[full, 2], vocab), p[2]) <= TV_TOL
    # nothing outside the filtered support is ever committed
    for i in range(gamma + 1):
        committed = w[n_r >= i, i]
        assert p[i][committed].min() > 0


@pytest.mark.parametrize("temperature,top_k,top_p",
                         SAMPLED + [(1.3, 0, 0.6), (0.5, 3, 0.0)])
def test_select_token_law_matches_spec_dist(temperature, top_k, top_p):
    vocab = 8
    logits = np.random.RandomState(8).randn(1, vocab).astype(np.float32)
    p = np.asarray(jg._spec_dist(jnp.asarray(logits), temperature, top_k,
                                 top_p))[0]
    got = pg._select_token(torch.from_numpy(logits).expand(N_DRAWS, -1),
                           Draws.for_rows(13, N_DRAWS), True, temperature,
                           top_k, top_p).numpy()
    law = _law(got, vocab)
    assert _tv(law, p) <= TV_TOL
    assert law[p == 0].sum() == 0


def test_draws_are_pure_functions_of_key_counter_and_stream():
    """A row's numbers do not depend on the other rows, the batch size or
    the row's position; counters and streams give independent numbers;
    the host (Python int) and tensor hashes agree bit for bit."""
    keys = torch.tensor([lane_key(0, s) for s in (11, 22, 33)])
    counter = torch.tensor([4, 9, 1])
    batch = Draws(keys, counter).sub(5).bits(64)
    alone = Draws(keys[1:2], counter[1:2]).sub(5).bits(64)
    assert torch.equal(batch[1:2], alone)
    moved = Draws(keys.flip(0), counter.flip(0)).sub(5).bits(64)
    assert torch.equal(moved.flip(0), batch)
    assert not torch.equal(Draws(keys, counter + 1).sub(5).bits(64), batch)
    assert not torch.equal(Draws(keys, counter).sub(6).bits(64), batch)
    assert len({lane_key(0, s) for s in range(1000)}) == 1000
    assert lane_key(0, 7) != lane_key(1, 7)
    x = [3, 2**31 + 5, 2**32 - 1]
    assert [_mix32(v) for v in x] == _mix32(torch.tensor(x)).tolist()
    assert fold_in(key_from_seed(3), 9) == lane_key(3, 9)
    u = Draws.for_rows(0, 4).uniform(50_000)
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_uniforms_never_reach_the_ends():
    """The extreme words map strictly inside (0, 1), so Gumbel noise
    stays finite and a filtered token (-1e9) can never be drawn; the top
    word once mapped to exactly 1.0 (infinite noise), which let about one
    draw in 400 over a 39424-token vocabulary escape top-k and top-p."""
    ends = unit_interval(torch.tensor([0, 1, 2**31, 2**32 - 2, 2**32 - 1]))
    assert float(ends.min()) > 0 and float(ends.max()) < 1
    noise = -torch.log(-torch.log(ends))
    assert bool(torch.isfinite(noise).all())
    logits = torch.zeros(1, 4)
    logits[0, 1:] = -1e9
    bits = torch.full((1, 4), 2**32 - 1)
    assert int((logits - torch.log(-torch.log(unit_interval(bits))))
               .argmax()) == 0


# -- offline loops -----------------------------------------------------------

SPEC_TARGET = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=4, num_attention_heads=4,
                   max_position_embeddings=128, dtype="float32",
                   param_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """The reference test's models (``test_speculative_decode.py:_models``):
    a 4-layer target and an unrelated 2-layer draft, JAX and port, and a
    left-padded batch of three prompts."""
    jax_tgt = JaxLlama(JaxLlamaConfig(**SPEC_TARGET))
    jax_drf = JaxLlama(JaxLlamaConfig(**dict(SPEC_TARGET,
                                             num_hidden_layers=2)))
    ids = np.random.RandomState(0).randint(3, 96, (3, 12)).astype(np.int32)
    mask = np.array([[1] * 12, [0] * 4 + [1] * 8, [0] * 7 + [1] * 5],
                    np.int32)
    ids = ids * mask
    tp = jax_tgt.init(jax.random.PRNGKey(0), jnp.asarray(ids[:, :4]))[
        "params"]
    dp = jax_drf.init(jax.random.PRNGKey(1), jnp.asarray(ids[:, :4]))[
        "params"]
    ports = []
    for params, layers in ((tp, 4), (dp, 2)):
        cfg = LlamaConfig(**dict(SPEC_TARGET, num_hidden_layers=layers))
        m = LlamaForCausalLM(cfg, device="cpu")
        m.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), cfg))
        ports.append(m)
    return dict(jax=(jax_tgt, tp, jax_drf, dp), tgt=ports[0],
                drf=ports[1], ids=ids, mask=mask)


def _greedy(models, max_new, **kw):
    out = pg.generate(models["tgt"], models["ids"],
                      attention_mask=models["mask"], max_new_tokens=max_new,
                      device="cpu", **kw).numpy()
    jax_tgt, tp = models["jax"][:2]
    want = np.asarray(jg.generate(jax_tgt, tp, jnp.asarray(models["ids"]),
                                  attention_mask=jnp.asarray(models["mask"]),
                                  max_new_tokens=max_new, **kw))
    np.testing.assert_array_equal(out, want)
    return out


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_speculative_generate_exact_vs_greedy(models, gamma):
    """An unrelated draft changes no token: the port's speculative
    output is its greedy output, which is JAX's."""
    ref = _greedy(models, 24)
    out = pg.speculative_generate(
        models["tgt"], models["drf"], models["ids"],
        attention_mask=models["mask"], max_new_tokens=24, gamma=gamma,
        device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_speculative_generate_draft_equal_to_target_accepts_all(models):
    """draft == target: every proposal accepted, 23 tokens after the
    first in ceil(23 / 5) = 5 rounds, as the reference's (``:55``)."""
    ref = _greedy(models, 24)
    out, stats = pg.speculative_generate(
        models["tgt"], models["tgt"], models["ids"],
        attention_mask=models["mask"], max_new_tokens=24, gamma=4,
        return_stats=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    assert stats["rounds"] == 5 and stats["accepted"] == 20
    assert stats["acceptance_rate"] == 1.0


def test_speculative_generate_eos_exact(models):
    free = _greedy(models, 24)[:, 12:]
    eos = int(free[0, free.shape[1] // 2])
    ref = _greedy(models, 24, eos_token_id=eos)
    for draft in (models["drf"], models["tgt"]):
        out = pg.speculative_generate(
            models["tgt"], draft, models["ids"],
            attention_mask=models["mask"], max_new_tokens=24, gamma=4,
            eos_token_id=eos, device="cpu")
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("ngram", [1, 2])
def test_prompt_lookup_generate_exact_vs_greedy(models, ngram):
    """Token-exact vs greedy, with the reference's own accept counts
    (they depend only on the greedy tokens)."""
    ref = _greedy(models, 24)
    out, stats = pg.prompt_lookup_generate(
        models["tgt"], models["ids"], attention_mask=models["mask"],
        max_new_tokens=24, gamma=4, ngram=ngram, return_stats=True,
        device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    jax_tgt, tp = models["jax"][:2]
    _, want = jg.prompt_lookup_generate(
        jax_tgt, tp, jnp.asarray(models["ids"]),
        attention_mask=jnp.asarray(models["mask"]), max_new_tokens=24,
        gamma=4, ngram=ngram, return_stats=True)
    assert stats["accepted"] > 0
    assert (stats["rounds"], stats["accepted"]) == (int(want["rounds"]),
                                                    int(want["accepted"]))


def test_speculative_with_self_draft_exact(models):
    draft = make_self_draft(models["tgt"], 2)
    ref = _greedy(models, 16)
    out = pg.speculative_generate(
        models["tgt"], draft, models["ids"], attention_mask=models["mask"],
        max_new_tokens=16, gamma=4, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_speculative_refuses_undersized_cache(models):
    with pytest.raises(ValueError, match="gamma extra cache slots"):
        pg.speculative_generate(models["tgt"], models["drf"], models["ids"],
                                max_new_tokens=120, gamma=4, device="cpu")
    with pytest.raises(ValueError, match="gamma extra cache slots"):
        pg.prompt_lookup_generate(models["tgt"], models["ids"],
                                  max_new_tokens=120, device="cpu")


@pytest.mark.parametrize("kw", [dict(repetition_penalty=1.5),
                                dict(no_repeat_ngram_size=2),
                                dict(min_length=30, eos_token_id=
                                     None),
                                dict(repetition_penalty=1.3,
                                     no_repeat_ngram_size=3)])
def test_generate_with_controls_matches_jax(models, kw):
    """Greedy decoding under the controls: the JAX tokens."""
    out = _greedy(models, 16, **kw)
    if kw.get("no_repeat_ngram_size") == 2:
        for row, m in zip(out, models["mask"]):
            seq = row[int((m == 0).sum()):].tolist()
            grams = list(zip(seq, seq[1:]))
            assert len(grams) == len(set(grams))


def test_generate_min_length_bans_eos(models):
    free = _greedy(models, 16)[:, 12:]
    eos = int(free[0, 2])
    out = _greedy(models, 16, eos_token_id=eos, min_length=12 + 10)
    assert eos not in out[0, 12:12 + 10].tolist()


def test_sampled_generate_is_seeded_and_filtered(models):
    """Sampling is a pure function of the seed; top_k=1 is greedy; every
    token lies in the top-k of its step's logits."""
    kw = dict(attention_mask=models["mask"], max_new_tokens=12,
              do_sample=True, temperature=0.9, device="cpu")
    a = pg.generate(models["tgt"], models["ids"], seed=5, top_k=4, **kw)
    b = pg.generate(models["tgt"], models["ids"], seed=5, top_k=4, **kw)
    c = pg.generate(models["tgt"], models["ids"], seed=6, top_k=4, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_array_equal(
        pg.generate(models["tgt"], models["ids"], seed=5, top_k=1,
                    **kw).numpy(), _greedy(models, 12))
    mask = torch.cat([torch.from_numpy(models["mask"]).long(),
                      torch.ones(3, 12, dtype=torch.long)], dim=1)
    with torch.no_grad():
        logits = models["tgt"](a, attention_mask=mask,
                               position_ids=pg.position_ids_from_mask(mask))
    kth = logits[:, 11:-1].topk(4, dim=-1).values[..., -1]
    chosen = logits[:, 11:-1].gather(-1, a[:, 12:, None])[..., 0]
    assert bool((chosen >= kth - 1e-5).all())


def test_sampled_speculative_generate(models):
    """Sampled speculation is seeded; draft == target accepts every
    proposal (p == q makes min(1, p/q) = 1)."""
    kw = dict(attention_mask=models["mask"], max_new_tokens=16, gamma=4,
              do_sample=True, temperature=0.9, top_p=0.9, device="cpu")
    a = pg.speculative_generate(models["tgt"], models["drf"], models["ids"],
                                seed=3, **kw)
    b = pg.speculative_generate(models["tgt"], models["drf"], models["ids"],
                                seed=3, **kw)
    assert torch.equal(a, b)
    _, stats = pg.speculative_generate(
        models["tgt"], models["tgt"], models["ids"], seed=3,
        return_stats=True, **kw)
    assert stats["acceptance_rate"] == 1.0


# -- self draft and rollback ------------------------------------------------

def test_make_self_draft_aliases_the_target(models):
    """No tensor is copied: each draft parameter IS the target's (same
    data_ptr); the draft's logits are the JAX self-draft's."""
    tgt = models["tgt"]
    draft = make_self_draft(tgt, 2)
    assert draft.config.num_hidden_layers == 2
    assert tgt.config.num_hidden_layers == 4
    target_ptrs = {n: p.data_ptr() for n, p in tgt.named_parameters()}
    draft_params = dict(draft.named_parameters())
    assert len(draft_params) == len(target_ptrs) - 2 * 9
    for name, p in draft_params.items():
        assert p.data_ptr() == target_ptrs[name], name
    assert draft.model.layers[1] is tgt.model.layers[1]
    jax_tgt, tp = models["jax"][:2]
    d_cfg, d_params = jg_make_self_draft(jax_tgt.config, tp, 2)
    ids = models["ids"]
    want = JaxLlama(d_cfg).apply({"params": d_params}, jnp.asarray(ids))
    with torch.no_grad():
        got = draft(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for bad in (0, 4):
        with pytest.raises(ValueError, match="must be in"):
            make_self_draft(tgt, bad)


def jg_make_self_draft(config, params, n):
    from fengshen_tpu.models.llama import make_self_draft as jax_self_draft
    return jax_self_draft(config, params, n)


def test_rollback_lowers_the_cursor():
    cfg = LlamaConfig(**SPEC_TARGET)
    lock = KVCache.zeros(cfg, 2, 16, device="cpu", dtype=torch.float32)
    lock.index = 9
    assert pg._rollback_cache(lock, 3).index == 6
    pool = KVCache.zeros(cfg, 3, 16, device="cpu", dtype=torch.float32)
    pool.index = torch.tensor([7, 9, 12])
    rollback_slots(pool, torch.tensor([0, 2, 4]))
    assert pool.index.tolist() == [7, 7, 8]
