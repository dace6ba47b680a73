"""The port's encoder-decoder slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port, the weights carried by ``params_from_jax``, at a tiny size
(``small_test_config``: d_model 32, 2 + 2 layers, 4 heads) in fp32 with
dropout off:

- ``models/t5`` (relu and tied, gated-gelu and untied, the encoder
  model), ``models/bart`` (and ``BartForTextInfill`` with
  ``text_infill_loss``) and ``models/pegasus``: ``encode``,
  ``decode_logits`` and the full logits; T5's relative-position buckets
  bitwise for every relative position in -600..600 both ways; the
  decoder stepped token by token over its cache against the uncached
  decoder.
- ``utils/generate``: greedy and beam decode (K 1, 2 and 4; length
  penalties 0.6 and 1.0; ``min_length`` and ``no_repeat_ngram_size``)
  token-identical to JAX ``seq2seq_generate``, over the cache and over
  the buffer path; K 1 equal to greedy; sampled decode inside the
  filtered support and repeatable for a seed.
- ``examples/summary``: the collator bitwise, ``Seq2SeqModule``'s loss
  and gradients against ``jax.grad``, ROUGE equal, a tiny ``main`` fit
  whose losses and ``predict.json`` equal the JAX ``main``'s on the same
  weights, ``--do_eval_only`` with beams, and ``mt5_summary.main``.
- The HF export of each family read back by ``load_hf_pretrained`` with
  bitwise logits, and read by the JAX package's ``torch_to_params`` to
  the JAX tree; T5's export loaded by ``transformers`` to its logits.

Tolerances: the forward within 1e-4 absolute (~1e-6 measured:
reduction order); gradients within 1e-4 relative L2 per tensor (plus
1e-9 absolute, for BART's key biases, whose gradient is zero up to
rounding: a softmax ignores a shift of every score); decoded tokens
equal.

Hygiene: torch runs on one intra-op thread (restored after); the port's
Trainer installs a process-wide SIGTERM handler, put back after each
test.
"""

import json
import signal
from unittest import mock

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.examples.summary import seq2seq_summary as ss
from fengshen_tpu_torch.models import bart as port_bart
from fengshen_tpu_torch.models import pegasus as port_pegasus
from fengshen_tpu_torch.models import t5 as port_t5
from fengshen_tpu_torch.models.bart import convert as bart_convert
from fengshen_tpu_torch.models.pegasus import convert as pegasus_convert
from fengshen_tpu_torch.models.t5 import convert as t5_convert
from fengshen_tpu_torch.trainer import trainer as port_trainer
from fengshen_tpu_torch.utils import generate as G
from fengshen_tpu_torch.utils.convert_common import write_safetensors

ATOL = 1e-4
GRAD_REL = 1e-4
VOCAB = 40
START, EOS, PAD = 0, 1, 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _sigterm_restored():
    handler = signal.getsignal(signal.SIGTERM)
    state = dict(port_trainer._SIGTERM_STATE)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_trainer._SIGTERM_STATE.clear()
    port_trainer._SIGTERM_STATE.update(state)


# -- families -----------------------------------------------------------------

#: name -> (JAX module path, config class, model class, port package,
#: port converter, config overrides)
FAMILIES = {
    "t5_relu_tied": ("fengshen_tpu.models.t5", "T5Config",
                     "T5ForConditionalGeneration", port_t5, t5_convert,
                     dict(dropout_rate=0.0)),
    "t5_gated_untied": ("fengshen_tpu.models.t5", "T5Config",
                        "T5ForConditionalGeneration", port_t5, t5_convert,
                        dict(dropout_rate=0.0, feed_forward_proj="gated-gelu",
                             tie_word_embeddings=False)),
    "bart": ("fengshen_tpu.models.bart", "BartConfig",
             "BartForConditionalGeneration", port_bart, bart_convert,
             dict(dropout=0.0)),
    "pegasus": ("fengshen_tpu.models.pegasus", "PegasusConfig",
                "PegasusForConditionalGeneration", port_pegasus,
                pegasus_convert, dict(dropout=0.0)),
}


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(family, seed=0, noise=0.0, vocab=VOCAB, **over):
    """``(JAX model, params, port config, port model)`` with the JAX
    initial weights (plus ``noise`` x N(0, 1), so biases and norms are
    not at their initial values) in the port model."""
    import importlib

    import jax
    import jax.numpy as jnp
    mod, cfg_name, cls_name, port_pkg, conv, base = FAMILIES[family]
    kw = dict(base, vocab_size=vocab, dtype="float32", **over)
    jmod = importlib.import_module(mod)
    jcfg = getattr(jmod, cfg_name).small_test_config(**kw)
    jm = getattr(jmod, cls_name)(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), ids,
                              ids[:, :2])["params"])
    if noise:
        rng = np.random.RandomState(seed + 100)
        params = jax.tree_util.tree_map(
            lambda x: (x + noise * rng.randn(*x.shape)).astype(x.dtype),
            params)
    pcfg = getattr(port_pkg, cfg_name).small_test_config(**kw)
    model = getattr(port_pkg, cls_name)(pcfg, device="cpu", init=False)
    model.load_state_dict(conv.params_from_jax(params, pcfg))
    return jm, params, pcfg, model


def _inputs(seed=0, batch=3, src=9, tgt=6, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, vocab, (batch, src)).astype(np.int32)
    mask = np.ones((batch, src), np.int32)
    mask[1, 6:] = 0
    dec = rng.randint(2, vocab, (batch, tgt)).astype(np.int32)
    return ids, mask, dec


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- T5 buckets ------------------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["encoder", "decoder"])
def test_relative_position_buckets_are_bitwise(bidirectional):
    """Every relative position in -600..600 lands in JAX's bucket (the
    fp32 ``log`` truncated), for the default and Randeng's geometry."""
    import jax.numpy as jnp

    from fengshen_tpu.models.t5.modeling_t5 import \
        relative_position_bucket as jax_bucket
    rel = np.arange(-600, 601, dtype=np.int32)
    for buckets, distance in ((32, 128), (16, 64), (64, 256)):
        want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional,
                                     buckets, distance))
        got = port_t5.modeling_t5.relative_position_bucket(
            torch.from_numpy(rel).long(), bidirectional, buckets,
            distance).numpy()
        np.testing.assert_array_equal(got, want)


# -- the models --------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_encode_decode_and_logits_match_jax(family):
    """``encode``, ``decode_logits`` over the encoder output and the full
    forward with a padding mask, within 1e-4."""
    jm, params, _, model = _pair(family, noise=0.05)
    ids, mask, dec = _inputs()
    v = {"params": params}
    enc = jm.apply(v, ids, mask, method=jm.encode)
    want = {"encode": enc,
            "decode_logits": jm.apply(v, dec, enc, mask,
                                      method=jm.decode_logits),
            "logits": jm.apply(v, ids, dec, attention_mask=mask)}
    with torch.no_grad():
        p_enc = model.encode(_t(ids), _t(mask))
        got = {"encode": p_enc,
               "decode_logits": model.decode_logits(_t(dec), p_enc,
                                                    _t(mask)),
               "logits": model(_t(ids), _t(dec), attention_mask=_t(mask))}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)


def test_t5_encoder_model_and_text_infill_match_jax():
    """``T5EncoderModel`` (the classification backbone) and
    ``BartForTextInfill`` with both ``text_infill_loss`` modes."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.models.bart import BartConfig as JB
    from fengshen_tpu.models.bart import BartForTextInfill as JInfill
    from fengshen_tpu.models.bart import text_infill_loss as jloss
    from fengshen_tpu.models.t5 import T5Config as JT
    from fengshen_tpu.models.t5 import T5EncoderModel as JEnc
    ids, mask, dec = _inputs(seed=3)
    jcfg = JT.small_test_config(vocab_size=VOCAB, dtype="float32",
                                dropout_rate=0.0)
    jenc = JEnc(jcfg)
    params = _np_tree(jenc.init(jax.random.PRNGKey(1),
                                jnp.asarray(ids))["params"])
    pcfg = port_t5.T5Config.small_test_config(
        vocab_size=VOCAB, dtype="float32", dropout_rate=0.0)
    penc = port_t5.T5EncoderModel(pcfg, device="cpu", init=False)
    penc.load_state_dict(t5_convert.params_from_jax(params, pcfg))
    want = jenc.apply({"params": params}, ids, mask)
    with torch.no_grad():
        got = penc(_t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)

    for loss_type, labels in ((0, 3), (1, 1)):
        bcfg = dict(vocab_size=VOCAB, dtype="float32", dropout=0.0)
        jm = JInfill(JB.small_test_config(**bcfg), num_labels=labels,
                     encoder_loss_type=loss_type)
        params = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(ids),
                                  jnp.asarray(dec))["params"])
        pm = port_bart.BartForTextInfill(
            port_bart.BartConfig.small_test_config(**bcfg),
            num_labels=labels, encoder_loss_type=loss_type, device="cpu",
            init=False)
        pm.load_state_dict(bart_convert.params_from_jax(params, None))
        lm, enc_logits = jm.apply({"params": params}, ids, dec,
                                  attention_mask=mask)
        rng = np.random.RandomState(5)
        labels_dec = np.where(rng.rand(*dec.shape) < 0.2, -100, dec)
        enc_labels = rng.randint(-1 if loss_type else 0, labels,
                                 ids.shape)
        enc_labels[0, :2] = -100
        weights = [1.0, 2.0, 0.5] if loss_type == 0 else None
        want, want_parts = jloss(lm, jnp.asarray(labels_dec), enc_logits,
                                 jnp.asarray(enc_labels), 0.7, weights,
                                 loss_type)
        with torch.no_grad():
            p_lm, p_enc = pm(_t(ids), _t(dec), attention_mask=_t(mask))
            got, parts = port_bart.text_infill_loss(
                p_lm, _t(labels_dec), p_enc, _t(enc_labels), 0.7, weights,
                loss_type)
        np.testing.assert_allclose(p_enc.numpy(), np.asarray(enc_logits),
                                   rtol=0, atol=ATOL)
        assert abs(float(got) - float(want)) < ATOL
        for k in ("decoder_loss", "encoder_loss"):
            assert abs(float(parts[k]) - float(want_parts[k])) < ATOL


@pytest.mark.parametrize("family", ["t5_relu_tied", "bart", "pegasus"])
def test_cached_decoder_steps_equal_the_uncached_decoder(family):
    """The decoder run one token at a time over its cache (cross K/V
    projected on the first step, read back after) gives the uncached
    decoder's logits at every position, and the cache's cursor and
    reorder move only the self-attention rows."""
    _, _, _, model = _pair(family, noise=0.05)
    ids, mask, dec = _inputs(seed=1)
    kw = {} if family.startswith("t5") else {"position_offset": 0}
    with torch.no_grad():
        enc = model.encode(_t(ids), _t(mask))
        want = model.decode_logits(_t(dec), enc, _t(mask))
        cache = model.new_cache(ids.shape[0], dec.shape[1])
        steps = []
        for t in range(dec.shape[1]):
            if kw:
                kw["position_offset"] = t
            steps.append(model.decode_logits(
                _t(dec[:, t:t + 1]), enc, _t(mask), cache=cache,
                cross_from_cache=t > 0, **kw)[:, -1])
    got = torch.stack(steps, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    assert cache.index == dec.shape[1]
    cross = [c.clone() for c in cache.cross_keys]
    first = cache.keys[0].clone()
    cache.reorder(torch.tensor([2, 0, 0]))
    assert torch.equal(cache.keys[0][1], first[0])
    assert all(torch.equal(a, b) for a, b in zip(cross, cache.cross_keys))
    with pytest.raises(ValueError, match="overflows"):
        model.decode_logits(_t(dec[:, :1]), enc, _t(mask), cache=cache,
                            cross_from_cache=True, **kw)


# -- decoding ----------------------------------------------------------------------

DECODE_CASES = {
    "greedy": dict(num_beams=1),
    "greedy_controls": dict(num_beams=1, min_length=5,
                            no_repeat_ngram_size=2),
    "beam2_lp0.6": dict(num_beams=2, length_penalty=0.6),
    "beam4": dict(num_beams=4, length_penalty=1.0),
    "beam4_lp0.6_controls": dict(num_beams=4, length_penalty=0.6,
                                 min_length=4, no_repeat_ngram_size=2),
}


#: the cases each family runs (T5 all of them; every case runs at least
#: once)
FAMILY_CASES = {"t5_relu_tied": tuple(DECODE_CASES),
                "bart": ("greedy_controls", "beam2_lp0.6",
                         "beam4_lp0.6_controls"),
                "pegasus": ("greedy", "beam4", "beam4_lp0.6_controls")}

#: one encoder and one decoder layer for the decode tests (the JAX
#: decode loops compile per case)
ONE_LAYER = {"t5_relu_tied": dict(num_layers=1),
             "bart": dict(encoder_layers=1, decoder_layers=1),
             "pegasus": dict(encoder_layers=1, decoder_layers=1)}


@pytest.fixture(scope="module")
def decode_pairs():
    """Each family at one layer a side with weights scaled up (noise
    0.4), so the random decoders do not sit on one token."""
    return {f: _pair(f, seed=2, noise=0.4, vocab=16, **ONE_LAYER[f])
            for f in ONE_LAYER}


@pytest.mark.parametrize("family", ["t5_relu_tied", "bart", "pegasus"])
def test_greedy_and_beam_decode_match_jax(decode_pairs, family):
    """The family's cases of DECODE_CASES token-identical to JAX
    ``seq2seq_generate`` over the cache, on a padded batch, and beam
    search at K 1 to JAX's; greedy (``num_beams`` 1) is the step-by-step
    argmax of the uncached forward, padded after eos."""
    import jax.numpy as jnp

    from fengshen_tpu.utils.generate import seq2seq_beam_search as jbeam
    from fengshen_tpu.utils.generate import seq2seq_generate as jgen
    jm, params, _, model = decode_pairs[family]
    ids, mask, _ = _inputs(seed=4, vocab=16)
    common = dict(max_new_tokens=8, decoder_start_token_id=START,
                  eos_token_id=EOS, pad_token_id=PAD)
    for name in FAMILY_CASES[family]:
        case = DECODE_CASES[name]
        want = np.asarray(jgen(jm, params, jnp.asarray(ids),
                               jnp.asarray(mask), **common, **case))
        got = G.seq2seq_generate(model, ids, mask, device="cpu", **common,
                                 **case)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    want = np.asarray(jbeam(jm, params, jnp.asarray(ids),
                            jnp.asarray(mask), num_beams=1, **common))
    beam1 = G.seq2seq_beam_search(model, ids, mask, num_beams=1,
                                  device="cpu", **common)
    np.testing.assert_array_equal(beam1.numpy(), want)
    # greedy is the step-by-step argmax of the uncached forward
    greedy = G.seq2seq_generate(model, ids, mask, device="cpu", **common)
    with torch.no_grad():
        logits = model(_t(ids), greedy[:, :-1], attention_mask=_t(mask))
    for b in range(greedy.shape[0]):
        row = greedy[b].tolist()
        end = row.index(EOS, 1) + 1 if EOS in row[1:] else len(row)
        assert row[1:end] == logits[b, :end - 1].argmax(-1).tolist()
        assert all(t == PAD for t in row[end:])


@pytest.mark.parametrize("family", ["t5_relu_tied", "bart", "pegasus"])
def test_buffer_path_matches_jax_and_the_cached_path(family, monkeypatch):
    """A decode as long as the cache's capacity takes the buffer path
    (the whole decoder per step) on both sides, token-identical to JAX;
    the port's buffer and cached paths agree for greedy, beam and
    sampled decode (the two draw alike)."""
    import jax.numpy as jnp

    from fengshen_tpu.utils.generate import seq2seq_generate as jgen
    jm, params, cfg, model = _pair(family, seed=2, noise=0.4, vocab=16,
                                   decode_cache_length=6,
                                   **ONE_LAYER[family])
    ids, mask, _ = _inputs(seed=4, vocab=16)
    common = dict(max_new_tokens=6, decoder_start_token_id=START,
                  eos_token_id=EOS, pad_token_id=PAD)
    assert G._cache_capacity(model) == 6
    for case in (dict(num_beams=1), dict(num_beams=3, min_length=3)):
        want = np.asarray(jgen(jm, params, jnp.asarray(ids),
                               jnp.asarray(mask), **common, **case))
        got = G.seq2seq_generate(model, ids, mask, device="cpu", **common,
                                 **case)
        np.testing.assert_array_equal(got.numpy(), want)
    cfg.decode_cache_length = 512
    runs = {}
    for path in ("cached", "buffer"):
        if path == "buffer":
            monkeypatch.setattr(G, "_seq2seq_supports_cache",
                                lambda m: False)
        runs[path] = [G.seq2seq_generate(model, ids, mask, device="cpu",
                                         **common, **case)
                      for case in (dict(), dict(num_beams=3),
                                   dict(do_sample=True, top_k=4, seed=3))]
    for a, b in zip(runs["cached"], runs["buffer"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["t5_relu_tied", "bart"])
def test_sampled_decode_stays_in_support_and_repeats(decode_pairs, family):
    """Sampled decode (top_k 3, temperature 0.8) draws every token from
    the top 3 of one uncached forward over the sequence (a row after its
    eos is padding), and the same seed gives the same tokens, another
    seed others."""
    _, _, _, model = decode_pairs[family]
    ids, mask, _ = _inputs(seed=6, vocab=16)
    kw = dict(max_new_tokens=8, decoder_start_token_id=START,
              eos_token_id=EOS, pad_token_id=PAD, do_sample=True, top_k=3,
              temperature=0.8, device="cpu")
    a = G.seq2seq_generate(model, ids, mask, seed=7, **kw)
    assert torch.equal(a, G.seq2seq_generate(model, ids, mask, seed=7, **kw))
    assert not torch.equal(a, G.seq2seq_generate(model, ids, mask, seed=8,
                                                 **kw))
    with torch.no_grad():
        logits = model(_t(ids), a[:, :-1], attention_mask=_t(mask))
    top3 = logits.topk(3, dim=-1).indices
    for b in range(a.shape[0]):
        for t in range(1, a.shape[1]):
            if EOS in a[b, 1:t].tolist():
                assert int(a[b, t]) == PAD
            else:
                assert int(a[b, t]) in top3[b, t - 1].tolist()


# -- the summary example -------------------------------------------------------------

class _CharTok:
    """Lowercase letters as ids 3..28 (pad 0, eos 1, unk 2)."""

    pad_token_id, eos_token_id = 0, 1

    def encode(self, text, add_special_tokens=True):
        del add_special_tokens
        return [ord(c) - 94 if "a" <= c <= "z" else 2 for c in text]

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(int(i) + 94) if 3 <= int(i) <= 28 else
                       ("" if skip_special_tokens else f"<{int(i)}>")
                       for i in ids)

    def batch_decode(self, rows, skip_special_tokens=False):
        return [self.decode(r, skip_special_tokens) for r in rows]


def _records(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        text = "".join(chr(97 + c) for c in rng.randint(0, 26,
                                                        rng.randint(8, 14)))
        start = rng.randint(0, 4)
        out.append({"text": text, "summary": text[start:start + 4]})
    return out


def test_collator_and_rouge_equal_jax():
    """``Seq2SeqCollator`` arrays bitwise (a prompt, truncation of both
    sides, a tokenizer without eos) and ``rouge_scores`` equal."""
    from fengshen_tpu.examples.summary.seq2seq_summary import \
        Seq2SeqCollator as JaxCollator
    from fengshen_tpu.metrics.rouge import rouge_scores as jrouge
    from fengshen_tpu_torch.metrics import rouge_scores
    rows = _records(5, 0) + [{"text": "a" * 40, "summary": "b" * 20}]

    class _NoEos(_CharTok):
        eos_token_id = None

    for tok in (_CharTok(), _NoEos()):
        for kw in (dict(max_src_length=16, max_tgt_length=6),
                   dict(max_src_length=24, max_tgt_length=8,
                        prompt="summarize:", decoder_start_token_id=3)):
            want = JaxCollator(tok, **kw)(rows)
            got = ss.Seq2SeqCollator(tok, **kw)(rows)
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    preds = ["今天天气很好", "好天", "", "a b c d", "摘要生成"]
    refs = ["今天天气好", "天好", "空", "a b d", "生成摘要"]
    for keys in (("rouge1", "rouge2", "rougeL"), ("rougeL",)):
        for char_level in (True, False):
            assert rouge_scores(preds, refs, keys, char_level) == \
                jrouge(preds, refs, keys, char_level)


@pytest.mark.parametrize("family", ["t5_gated_untied", "bart"])
def test_module_loss_and_grads_match_jax(family):
    """``Seq2SeqModule.training_loss`` (dropout off) against JAX
    ``training_loss`` and every parameter's gradient against
    ``jax.grad``, within 1e-4 relative L2; ``flops_per_token`` counts the
    matrices of each side over S + T tokens."""
    import argparse

    import jax
    import jax.numpy as jnp

    from fengshen_tpu.examples.summary.seq2seq_summary import \
        Seq2SeqModule as JaxModule
    from fengshen_tpu_torch.utils.convert_common import flax_to_state
    jm, params, cfg, model = _pair(family, seed=3, noise=0.05)
    batch = ss.Seq2SeqCollator(_CharTok(), max_src_length=12,
                               max_tgt_length=6)(_records(3, 1))
    args = argparse.Namespace(max_src_length=12, max_tgt_length=6)
    jmod = JaxModule(args, jm, cfg)
    (want, wm), grads = jax.value_and_grad(
        lambda p: jmod.training_loss(p, {k: jnp.asarray(v) for k, v in
                                         batch.items()},
                                     jax.random.PRNGKey(0)),
        has_aux=True)(params)
    pmod = ss.Seq2SeqModule(args, model, cfg)
    loss, metrics = pmod.training_loss({k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss) - float(want)) < ATOL
    assert int(metrics["n_tokens"]) == int(wm["n_tokens"])
    want_g = flax_to_state(_np_tree(grads))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert want_g.keys() == got_g.keys()
    for name, g in got_g.items():
        w = want_g[name].numpy()
        err = np.linalg.norm(g.numpy() - w)
        assert err <= GRAD_REL * np.linalg.norm(w) + 1e-9, name
    n_params = sum(p.numel() for n, p in model.named_parameters()
                   if p.dim() == 2 and ("layer" in n or "block" in n))
    assert pmod.flops_per_token() > 6.0 * n_params * 6 / 18
    assert pmod.tokens_in_batch(batch) == 3 * (12 + 6)


def _summary_argv(tmp_path, model_dir, extra=()):
    files = {}
    for split, n, seed in (("train", 8, 1), ("val", 4, 2), ("test", 5, 3)):
        path = tmp_path / f"{split}.json"
        path.write_text("".join(json.dumps(r) + "\n"
                                for r in _records(n, seed)))
        files[split] = str(path)
    return [str(x) for x in (
        "--model_type", "t5", "--pretrained_model_path", model_dir,
        "--train_file", files["train"], "--val_file", files["val"],
        "--test_file", files["test"], "--max_enc_length", 16,
        "--max_dec_length", 6, "--train_batchsize", 4, "--val_batchsize",
        4, "--test_batchsize", 5, "--learning_rate", 1e-3,
        "--weight_decay", 1e-2, "--prompt", "", "--max_steps", 3,
        "--warmup_steps", 1, "--log_every_n_steps", 1, "--seed", 0,
        "--default_root_dir", tmp_path / "runs", "--save_ckpt_path",
        tmp_path / "ckpt", "--load_ckpt_path", tmp_path / "ckpt",
        "--output_save_path", tmp_path / "predict.json", *extra)]


def test_main_fit_and_predict_match_the_jax_main(tmp_path):
    """A tiny ``main`` (3 steps, then greedy ``predict.json`` and ROUGE)
    from an HF-named checkpoint in ``--pretrained_model_path``: the
    losses and ``predict.json`` equal the JAX ``main``'s on the same
    weights (its module given them, its tokenizer the test's);
    ``--do_eval_only --num_beams 2`` restores the saved step and writes
    one row per test record again."""
    import jax

    from fengshen_tpu.examples.summary import seq2seq_summary as jss
    jm, params, cfg, model = _pair("t5_gated_untied", seed=5, noise=0.05)
    model_dir = tmp_path / "model"
    cfg.save_pretrained(str(model_dir))
    write_safetensors(str(model_dir / "model.safetensors"),
                      t5_convert.params_to_torch_state(model.state_dict(),
                                                       cfg))
    argv = _summary_argv(tmp_path, model_dir)
    trainer = ss.main(argv + ["--device", "cpu"], tokenizer=_CharTok())
    got_losses = [e["loss"] for e in trainer.history if "loss" in e]
    got_pred = (tmp_path / "predict.json").read_text()
    rouge = trainer.history[-1]
    assert rouge["event"] == "rouge" and rouge["rows"] == 5

    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jargv = _summary_argv(jax_dir, model_dir)
    with mock.patch("transformers.AutoTokenizer.from_pretrained",
                    lambda *a, **k: _CharTok()), \
            mock.patch.object(jss.Seq2SeqModule, "init_params",
                              lambda self, rng: jax.tree_util.tree_map(
                                  np.array, params)):
        jss.main(jargv)
    jax_losses = [json.loads(line)["loss"] for line in
                  (jax_dir / "runs" / "metrics.jsonl").read_text()
                  .splitlines() if '"loss"' in line]
    np.testing.assert_allclose(got_losses, jax_losses, rtol=0, atol=ATOL)
    assert got_pred == (jax_dir / "predict.json").read_text()
    assert len(got_pred.splitlines()) == 5

    ss.main(argv + ["--device", "cpu", "--do_eval_only", "--num_beams",
                    "2", "--output_save_path",
                    str(tmp_path / "beam.json")], tokenizer=_CharTok())
    assert len((tmp_path / "beam.json").read_text().splitlines()) == 5


def test_mt5_main_and_shell_flags(tmp_path):
    """``mt5_summary.main`` fits from a config-only directory; the
    784M shell's flags parse, its ``--datasets_name`` refused by the
    datamodule (queue 1 item 8); ``main`` needs the card unless asked
    for the CPU."""
    from fengshen_tpu_torch.examples.mt5_summary import mt5_summary
    model_dir = tmp_path / "model"
    port_t5.T5Config.small_test_config(vocab_size=VOCAB, dtype="float32"
                                       ).save_pretrained(str(model_dir))
    argv = _summary_argv(tmp_path, model_dir)
    train = argv[argv.index("--train_file") + 1]
    trainer = mt5_summary.main(
        ["--model_path", str(model_dir), "--train_file", train,
         "--max_src_length", "16", "--max_tgt_length", "6",
         "--train_batchsize", "4", "--max_steps", "2",
         "--log_every_n_steps", "1",
         "--default_root_dir", str(tmp_path / "mt5"), "--save_ckpt_path",
         str(tmp_path / "mt5_ckpt"), "--load_ckpt_path",
         str(tmp_path / "mt5_ckpt"), "--device", "cpu"],
        tokenizer=_CharTok())
    losses = [e["loss"] for e in trainer.history if "loss" in e]
    assert len(losses) == 2 and np.isfinite(losses).all()
    shell = ["--model_type", "t5", "--pretrained_model_path",
             str(model_dir), "--datasets_name", "lcsts",
             "--val_datasets_field", "val", "--monitor", "val_loss",
             "--mode", "min", "--save_top_k", "3", "--save_last",
             "--train_batchsize", "64", "--max_enc_length", "128",
             "--max_dec_length", "64", "--prompt", "", "--learning_rate",
             "1e-4", "--weight_decay", "1e-2", "--max_epochs", "1",
             "--precision", "bf16", "--default_root_dir",
             str(tmp_path / "shell")]
    args = ss.parse_args(shell)
    assert (args.max_src_length, args.max_tgt_length, args.model_path) == \
        (128, 64, str(model_dir))
    with pytest.raises(NotImplementedError, match="datasets_name"):
        ss.main(shell + ["--device", "cpu"], tokenizer=_CharTok())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ss.main(argv, tokenizer=_CharTok())


# -- HF export and import --------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_export_reimports_bitwise(tmp_path, family):
    """The port's HF-named export, written as safetensors and read back
    by ``load_hf_pretrained``, gives bitwise logits; the JAX package's
    ``torch_to_params`` reads the same export to the JAX tree; T5's is
    loaded by ``transformers`` itself to its logits (2e-4)."""
    import importlib

    import jax
    mod = FAMILIES[family][0]
    conv = FAMILIES[family][4]
    jconv = importlib.import_module(mod + ".convert")
    jm, params, cfg, model = _pair(family, seed=6, noise=0.05)
    state = conv.params_to_torch_state(model.state_dict(), cfg)
    d = tmp_path / family
    cfg.save_pretrained(str(d))
    write_safetensors(str(d / "model.safetensors"),
                      {k: v.contiguous() for k, v in state.items()})
    _, loaded = conv.load_hf_pretrained(str(d), device="cpu")
    ids, mask, dec = _inputs(seed=7)
    with torch.no_grad():
        want = model(_t(ids), _t(dec), attention_mask=_t(mask))
        got = loaded(_t(ids), _t(dec), attention_mask=_t(mask))
    assert torch.equal(got, want)
    np_state = {k: v.numpy() for k, v in state.items()}
    back = jconv.torch_to_params(np_state, jm.config)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           _np_tree(back), params)
    if family.startswith("t5"):
        transformers = pytest.importorskip("transformers")
        hf_cfg = transformers.T5Config(
            vocab_size=VOCAB, d_model=cfg.d_model, d_kv=cfg.d_kv,
            d_ff=cfg.d_ff, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            feed_forward_proj=cfg.feed_forward_proj,
            tie_word_embeddings=cfg.tie_word_embeddings, dropout_rate=0.0)
        with torch.random.fork_rng():
            hf = transformers.T5ForConditionalGeneration(hf_cfg).eval()
        hf.load_state_dict(state)
        with torch.no_grad():
            hf_logits = hf(input_ids=_t(ids), attention_mask=_t(mask),
                           decoder_input_ids=_t(dec)).logits
        np.testing.assert_allclose(hf_logits.numpy(), want.numpy(),
                                   rtol=0, atol=2e-4)
