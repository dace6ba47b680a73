"""The port's GPT-2 / Wenzhong slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port, the weights carried by ``params_from_jax`` (or by an HF
checkpoint both packages load), at a tiny size (vocab 128, ``n_embd``
32, 2 layers, 4 heads, ``n_positions`` 64) with dropout off:

- ``models/gpt2``: the forward with a padding mask and explicit
  ``position_ids`` for the ``h_{i}`` and the scanned trees, in fp32 and
  bf16 compute; an HF ``transformers`` checkpoint (``.bin``,
  ``.safetensors``, a bare ``GPT2Model``'s) loaded by both packages, the
  port's export giving HF's tensors back and re-importing bitwise.
- ``utils/generate``: greedy decode over GPT-2's cache token-identical to
  JAX ``generate`` on a left-padded batch with ``eos`` and the logits
  controls; sampled, prompt-lookup and speculative decode on GPT-2.
- ``trainer/modules.CausalLMModule``: loss modes "off" and "replicated"
  (the tied head through K2's seam, its plain version here) against JAX
  ``training_loss`` and ``jax.grad`` (``wte``: embedding plus head, and
  one ``c_attn``), with per-block checkpointing; dropout repeating under
  the step's generator; ``flops_per_token``.
- ``examples/wenzhong_qa``: the collator bitwise, a ``--model_path``
  holding weights, ``main``'s first-step loss against JAX
  ``training_loss``, the reference shells' flags and the
  ``--offload_optimizer`` refusal; ``examples/fastdemo/yuyuan_qa``:
  ``answer`` against JAX ``answer`` and ``main`` over stdin.
- ``models/auto``: the ported families and their heads, the refusal of
  the rest.

Tolerances: fp32 within 1e-5 (reduction order, ~1e-7 relative here);
bf16 compute within 2e-2 relative L2 (both round every product and
activation to bf16, 2^-8 relative, in another order); HF's own logits
within 2e-3 (its attention and GELU differ in form).

Hygiene: torch runs on one intra-op thread (restored after); the port's
Trainer installs a process-wide SIGTERM handler, put back after each
test; the HF models are drawn inside ``torch.random.fork_rng``.
"""

import argparse
import dataclasses
import io
import json
import os
import re
import shlex
import signal
import sys

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.examples.fastdemo import yuyuan_qa
from fengshen_tpu_torch.examples.wenzhong_qa import finetune_wenzhong as fw
from fengshen_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHeadModel,
                                            convert)
from fengshen_tpu_torch.ops.dropout import step_generator
from fengshen_tpu_torch.trainer import trainer as port_trainer
from fengshen_tpu_torch.trainer.modules import CausalLMModule
from fengshen_tpu_torch.utils.convert_common import write_safetensors
from fengshen_tpu_torch.utils.generate import (generate,
                                               prompt_lookup_generate,
                                               speculative_generate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_ATOL = 1e-5
BF16_REL = 2e-2
HF_ATOL = 2e-3
TINY = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
            n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)


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


class _Tok:
    """Characters as ids (``ord % 100 + 3``), digits runs as numbers
    mod 100 + 3; ``eos`` 2 and no pad id (the collator pads with 0)."""

    eos_token_id, pad_token_id = 2, None

    def encode(self, text, add_special_tokens=True):
        del add_special_tokens
        return [int(t) % 100 + 3 if t.isdecimal() else ord(t) % 100 + 3
                for t in re.findall(r"\d+|\S", text)]

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids
                        if not (skip_special_tokens and int(i) in (0, 2)))


def _configs(**over):
    from fengshen_tpu.models.gpt2 import GPT2Config as JaxConfig
    kw = {**TINY, "dtype": "float32", **over}
    return JaxConfig(**kw), GPT2Config(**kw)


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=0, **over):
    """``(jax config, params, port config, port model)`` with the JAX
    initial weights in the port model."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    jcfg, pcfg = _configs(**over)
    params = JaxGPT2(jcfg).init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    model = GPT2LMHeadModel(pcfg, device="cpu", init=False)
    model.load_state_dict(convert.params_from_jax(_np_tree(params), pcfg))
    return jcfg, params, pcfg, model


def _inputs(seed=0, batch=2, seq=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 128, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[1, 8:] = 0
    pos = np.tile(np.arange(seq, dtype=np.int32) + 2, (batch, 1))
    return ids, mask, pos


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True], ids=["h_i", "scan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(scan, dtype):
    """Logits and ``return_hidden`` with a padding mask and explicit
    ``position_ids``, the per-block and the scanned trees."""
    import jax.numpy as jnp

    from fengshen_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    jcfg, params, pcfg, model = _pair(scan_layers=scan, dtype=dtype)
    ids, mask, pos = _inputs()
    jm = JaxGPT2(jcfg)
    want = jm.apply({"params": params}, jnp.asarray(ids),
                    jnp.asarray(mask), jnp.asarray(pos))
    want_h = jm.apply({"params": params}, jnp.asarray(ids),
                      jnp.asarray(mask), jnp.asarray(pos),
                      return_hidden=True)
    with torch.no_grad():
        got = model(_t(ids), _t(mask), _t(pos))
        got_h = model(_t(ids), _t(mask), _t(pos), return_hidden=True)
    assert got.dtype == getattr(torch, dtype)
    for g, w in ((got, want), (got_h, want_h)):
        w = np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=FP32_ATOL)
        else:
            assert _rel(g, w) < BF16_REL


def _hf_models():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        attn_implementation="eager")
    with torch.random.fork_rng():
        torch.manual_seed(0)
        lm = transformers.GPT2LMHeadModel(hf_cfg).eval()
        bare = transformers.GPT2Model(hf_cfg).eval()
    return lm, bare


@pytest.mark.parametrize("fmt", ["bin", "safetensors", "bare"])
def test_hf_checkpoint_loads_into_both_packages(tmp_path, fmt):
    """An HF checkpoint directory loads through both packages'
    ``load_hf_pretrained`` to equal logits (1e-5) and to HF's own (2e-3;
    a bare ``GPT2Model``'s, without the ``transformer.`` prefix, to its
    hidden states). The port's export is HF's tensors, bitwise, and
    re-imports bitwise."""
    import jax.numpy as jnp

    from fengshen_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    from fengshen_tpu.models.gpt2.convert import load_hf_pretrained as jload
    lm, bare = _hf_models()
    hf = bare if fmt == "bare" else lm
    state = hf.state_dict()
    if fmt == "safetensors":
        write_safetensors(str(tmp_path / "model.safetensors"),
                          {k: v.contiguous() for k, v in state.items()})
    else:
        torch.save(state, tmp_path / "pytorch_model.bin")
    _, pcfg = _configs()
    pcfg.save_pretrained(str(tmp_path))
    jcfg, params = jload(str(tmp_path))
    cfg, model = convert.load_hf_pretrained(str(tmp_path), device="cpu")
    assert cfg == pcfg
    ids, mask, _ = _inputs(seed=3)
    want = JaxGPT2(jcfg).apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask))
    with torch.no_grad():
        got = model(_t(ids), _t(mask))
        if fmt == "bare":
            hf_out = hf(_t(ids), attention_mask=_t(mask)).last_hidden_state
            got_hf = model(_t(ids), _t(mask), return_hidden=True)
        else:
            hf_out = hf(_t(ids), attention_mask=_t(mask)).logits
            got_hf = got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FP32_ATOL)
    valid = _t(mask).bool()
    np.testing.assert_allclose(got_hf[valid].numpy(),
                               hf_out[valid].numpy(), rtol=0, atol=HF_ATOL)
    exported = convert.params_to_torch_state(model.state_dict(), cfg)
    named = state if fmt != "bare" else \
        {f"transformer.{k}": v for k, v in state.items()}
    for name, t in exported.items():
        assert torch.equal(t, named[name]), name
    assert {re.sub(r"\.\d+\.", ".N.", k) for k in set(named) -
            set(exported)} <= {"lm_head.weight", "transformer.h.N.attn.bias",
                               "transformer.h.N.attn.masked_bias"}
    again = convert.torch_to_params(exported, cfg)
    assert again.keys() == model.state_dict().keys()
    for name, t in model.state_dict().items():
        assert torch.equal(again[name], t), name


# -- decoding -----------------------------------------------------------------

CONTROLS = [{}, {"repetition_penalty": 1.5}, {"no_repeat_ngram_size": 2},
            {"min_length": 14}]


@pytest.fixture(scope="module")
def decode_pair():
    jcfg, params, pcfg, model = _pair(seed=5)
    ids = np.array([[0, 0, 5, 11, 42, 7], [9, 3, 17, 9, 42, 33]], np.int32)
    mask = np.array([[0, 0, 1, 1, 1, 1], [1] * 6], np.int32)
    # eos: the token row 0 emits third without controls, so row 0 stops
    free = generate(model, _t(ids), _t(mask), max_new_tokens=10,
                    device="cpu")
    return jcfg, params, model, ids, mask, int(free[0, 8])


@pytest.mark.parametrize("controls", CONTROLS,
                         ids=["plain", "repetition", "ngram", "min_length"])
def test_greedy_generate_matches_jax(decode_pair, controls):
    """Greedy decode over the port's GPT-2 cache is token-identical to
    JAX ``generate`` on a left-padded batch of 2 with ``eos``, with each
    logits control."""
    import jax.numpy as jnp

    from fengshen_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    from fengshen_tpu.utils.generate import generate as jax_generate
    jcfg, params, model, ids, mask, eos = decode_pair
    want = jax_generate(JaxGPT2(jcfg), params, jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask), max_new_tokens=10,
                        eos_token_id=eos, pad_token_id=0, **controls)
    got = generate(model, _t(ids), _t(mask), max_new_tokens=10,
                   eos_token_id=eos, pad_token_id=0, device="cpu",
                   **controls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not controls:
        stop = 6 + got[0, 6:].tolist().index(eos)
        assert stop < 15 and (got[0, stop + 1:] == 0).all()


def test_sampled_and_prompt_lookup_decode_run_on_gpt2(decode_pair):
    """Sampled decode with controls repeats under its seed, and with
    ``top_k`` 1 is greedy; prompt lookup and speculative decoding (the
    model as its own draft) are token-identical to greedy: GPT-2's cache
    rolls back as LLaMA's does."""
    _, _, model, ids, mask, eos = decode_pair
    kw = dict(max_new_tokens=10, eos_token_id=eos, device="cpu")
    greedy = generate(model, _t(ids), _t(mask), **kw)
    sampled = [generate(model, _t(ids), _t(mask), do_sample=True, top_k=20,
                        temperature=1.5, repetition_penalty=1.2, seed=s,
                        **kw) for s in (7, 7, 8)]
    assert torch.equal(sampled[0], sampled[1])
    assert not torch.equal(sampled[0], sampled[2])
    top1 = generate(model, _t(ids), _t(mask), do_sample=True, top_k=1,
                    seed=3, **kw)
    assert torch.equal(top1, greedy)
    looked = prompt_lookup_generate(model, _t(ids), _t(mask), gamma=3,
                                    **kw)
    assert torch.equal(looked, greedy)
    drafted = speculative_generate(model, model, _t(ids), _t(mask),
                                   gamma=3, **kw)
    assert torch.equal(drafted, greedy)


# -- training -----------------------------------------------------------------

def _batch(seed=1):
    ids, mask, _ = _inputs(seed=seed, seq=16)
    labels = ids.copy()
    labels[:, :5] = -100
    labels[mask == 0] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


@pytest.mark.parametrize("chunks", [0, 4], ids=["off", "replicated"])
def test_training_loss_and_grads_match_jax(chunks):
    """``CausalLMModule.training_loss`` in mode "off" and "replicated"
    (the tied head through K2's seam) with per-block checkpointing:
    loss, ``acc`` and ``n_tokens`` against JAX ``training_loss``; the
    gradients of ``wte`` (embedding plus head) and of one ``c_attn``
    against ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    from fengshen_tpu.trainer.modules import CausalLMModule as JaxModule
    jcfg, params, pcfg, model = _pair(seed=2, fused_ce_chunks=chunks,
                                      gradient_checkpointing=True)
    args = argparse.Namespace(max_seq_length=16)
    jmod = JaxModule(args, JaxGPT2(jcfg), jcfg)
    pmod = CausalLMModule(args, model, pcfg)
    assert pmod._fused_ce_mode() == jmod._fused_ce_mode() == \
        ("off" if chunks == 0 else "replicated")
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    (want, wm), grads = jax.value_and_grad(
        lambda p: jmod.training_loss(p, jbatch, rng), has_aux=True)(params)
    pmod.set_dropout_generator(step_generator(0, 0))
    loss, metrics = pmod.training_loss({k: _t(v) for k, v in
                                        batch.items()})
    loss.backward()
    assert abs(float(loss) - float(want)) < FP32_ATOL
    assert abs(float(metrics["acc"]) - float(wm["acc"])) < FP32_ATOL
    assert int(metrics["n_tokens"]) == int(wm["n_tokens"])
    tr = grads["transformer"]
    for got, want_g in (
            (model.transformer.wte.weight.grad, tr["wte"]["embedding"]),
            (model.transformer.h_0.attn.c_attn.weight.grad.T,
             tr["h_0"]["attn"]["c_attn"]["kernel"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_g), rtol=0,
                                   atol=FP32_ATOL)


def test_dropout_repeats_per_step_and_under_checkpointing():
    """With dropout 0.1 at every site the step's generator decides the
    masks: one step gives one loss twice, another step another; the
    recompute of a checkpointed block draws the masks of its forward,
    so the gradients equal those without checkpointing; validation runs
    without dropout."""
    pcfg = GPT2Config(**dict(TINY, resid_pdrop=0.1, embd_pdrop=0.1,
                             attn_pdrop=0.1), dtype="float32")
    batch = {k: _t(v) for k, v in _batch().items()}
    grads, losses = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, gradient_checkpointing=remat)
        model = GPT2LMHeadModel(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        mod = CausalLMModule(argparse.Namespace(), model, cfg)
        for step in (3, 3, 4):
            mod.set_dropout_generator(step_generator(9, step))
            model.zero_grad(set_to_none=True)
            loss = mod.training_loss(batch)[0]
            loss.backward()
            losses.setdefault(remat, []).append(float(loss))
        grads[remat] = [p.grad.clone() for p in model.parameters()]
        mod.set_dropout_generator(None)
        plain = float(mod.validation_loss(batch)[0])
    assert losses[False] == losses[True]
    assert losses[False][0] == losses[False][1] != losses[False][2]
    assert plain not in losses[False]
    for a, b in zip(grads[False], grads[True]):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_flops_per_token_counts_gpt2_matrices():
    """6 x (the blocks' 12 h^2 + the tied head h V) + 12 L h S: ``wpe``
    is left out as LLaMA's ``embed_tokens`` is (Wenzhong-GPT2-3.5B's
    geometry, built on ``meta``)."""
    cfg = GPT2Config.from_pretrained(os.path.join(
        ROOT, "configs", "wenzhong_gpt2_3.5b.json"))
    model = GPT2LMHeadModel(cfg, device="meta")
    mod = CausalLMModule(argparse.Namespace(max_seq_length=512), model, cfg)
    h, layers, v = 3072, 30, 50304
    assert mod.flops_per_token() == \
        6 * (layers * 12 * h * h + h * v) + 12 * layers * h * 512
    assert sum(p.numel() for p in model.parameters()) == 3556270080


# -- the Wenzhong example -----------------------------------------------------

QA = [{"question": "咳嗽 3 天", "answer": "多喝水 12 次"},
      {"question": "头痛", "answer": "休息" * 9},
      {"question": "发烧 39 度 怎么办", "answer": "就医"}]


def test_collator_equals_jax():
    """``WenzhongQACollator`` is bitwise the JAX one: the prompt format,
    ``eos`` appended, -100 over the question and the padding, pad id 0
    when the tokenizer has none, truncation at ``max_seq_length``."""
    from fengshen_tpu.examples.wenzhong_qa.finetune_wenzhong import \
        WenzhongQACollator as JaxCollator
    for length in (12, 48):
        got = fw.WenzhongQACollator(_Tok(), max_seq_length=length)(QA)
        want = JaxCollator(_Tok(), max_seq_length=length)(QA)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert (got["labels"][0, :7] == -100).all()
    assert 2 in got["input_ids"][0]


def _weights_dir(tmp_path, model, cfg):
    d = tmp_path / "wenzhong"
    cfg.save_pretrained(str(d))
    write_safetensors(str(d / "model.safetensors"),
                      convert.params_to_torch_state(model.state_dict(),
                                                    cfg))
    return d


def _write_jsonl(path, rows):
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                            for r in rows))
    return path


def test_main_loads_weights_and_its_first_loss_matches_jax(tmp_path):
    """``main`` with the medicalQA shell's flags on a ``--model_path``
    holding weights: the module loads them, and the first step's logged
    loss equals JAX ``training_loss`` on the same parameters and the
    datamodule's first batch; a config-only directory trains from the
    seeded weights instead."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    from fengshen_tpu.trainer.modules import CausalLMModule as JaxModule
    from fengshen_tpu_torch.data import UniversalDataModule
    jcfg, params, pcfg, model = _pair(seed=4)
    d = _weights_dir(tmp_path, model, pcfg)
    train = _write_jsonl(tmp_path / "train.json", QA * 2)
    argv = ["--model_path", str(d), "--train_file", str(train),
            "--val_file", str(train), "--val_batchsize", "2",
            "--default_root_dir", str(tmp_path / "runs"),
            "--save_ckpt_path", str(tmp_path / "ckpt"), "--load_ckpt_path",
            str(tmp_path / "ckpt"), "--train_batchsize", "2",
            "--max_seq_length", "24", "--learning_rate", "1e-5",
            "--weight_decay", "1e-2", "--adam_beta2", "0.95",
            "--gradient_clip_val", "1.0", "--precision", "bf16",
            "--max_steps", "2", "--log_every_n_steps", "1",
            "--device", "cpu"]
    args = fw.parse_args(argv)
    module = fw.Wenzhong(args, device="cpu")
    module.init_params(torch.Generator().manual_seed(0))
    for name, t in model.state_dict().items():
        assert torch.equal(module.model.state_dict()[name], t), name
    first = next(iter(UniversalDataModule(
        collate_fn=fw.WenzhongQACollator(_Tok(), 24),
        args=args).train_dataloader()))
    trainer = fw.main(argv, tokenizer=_Tok())
    losses = [e["loss"] for e in trainer.history if "loss" in e]
    assert len(losses) == 2 and any("val_loss" in e
                                    for e in trainer.history)
    jmod = JaxModule(args, JaxGPT2(jcfg), jcfg)
    want, _ = jmod.training_loss(
        params, {k: jnp.asarray(v) for k, v in first.items()},
        jax.random.PRNGKey(0))
    assert abs(losses[0] - float(want)) < FP32_ATOL
    os.remove(d / "model.safetensors")
    seeded = fw.Wenzhong(args, device="cpu")
    seeded.init_params(torch.Generator().manual_seed(0))
    assert not torch.equal(seeded.model.transformer.wte.weight,
                           model.transformer.wte.weight)


def _shell_argv(name):
    text = open(os.path.join(ROOT, "fengshen_tpu", "examples",
                             "wenzhong_qa", name)).read()
    cmd = text[text.index("python -m"):].replace("\\\n", " ")
    cmd = re.sub(r"\$\{?(\w+)(:-[^}]*)?\}?", r"\1", cmd)
    return shlex.split(cmd)[3:]


def test_reference_shells_parse_and_the_offload_one_is_refused(tmp_path):
    """The medicalQA shell's flags parse with their values; the other
    shell's ``--offload_optimizer`` stops at the Trainer's refusal
    naming ROADMAP.md queue 1 item 10, before anything is built."""
    args = fw.parse_args(_shell_argv("finetune_GPT2_medicalQA.sh"))
    assert (args.train_batchsize, args.max_seq_length, args.learning_rate,
            args.weight_decay, args.adam_beta2, args.gradient_clip_val,
            args.precision) == (1, 512, 1e-5, 1e-2, 0.95, 1.0, "bf16")
    assert args.val_file == "DATA_DIR/dev.json"
    argv = _shell_argv("finetune_wenzhong.sh")
    assert "--offload_optimizer" in argv
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        fw.main(argv + ["--device", "cpu", "--default_root_dir",
                        str(tmp_path / "runs")], tokenizer=_Tok())
    assert not (tmp_path / "runs").exists()


def test_yuyuan_answer_matches_jax_and_main_reads_stdin(tmp_path, capsys,
                                                        monkeypatch):
    """``answer`` is JAX ``answer``'s string (greedy over the cache,
    stopping at ``eos``); ``main`` loads an HF-named directory and
    answers each stdin line until an empty one."""
    from fengshen_tpu.examples.fastdemo.yuyuan_qa import answer as jax_answer
    from fengshen_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
    jcfg, params, pcfg, model = _pair(seed=6)
    questions = ["咳嗽 3 天", "头痛怎么办"]
    got = [yuyuan_qa.answer(model, _Tok(), q, max_new_tokens=8)
           for q in questions]
    want = [jax_answer(JaxGPT2(jcfg), params, _Tok(), q, max_new_tokens=8)
            for q in questions]
    assert got == want and all(got)
    d = _weights_dir(tmp_path, model, pcfg)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "\n".join(questions) + "\n\nnot read\n"))
    yuyuan_qa.main(["--model_path", str(d), "--max_new_tokens", "8",
                    "--device", "cpu"], tokenizer=_Tok())
    lines = capsys.readouterr().out.splitlines()
    assert lines[1:] == got


# -- models/auto --------------------------------------------------------------

FAMILIES = {
    "llama": {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
              "num_hidden_layers": 1, "num_attention_heads": 4,
              "dtype": "float32"},
    "gpt2": {"vocab_size": 64, "n_embd": 32, "n_layer": 1, "n_head": 4,
             "n_positions": 16, "dtype": "float32"},
    "megatron-bert": {"vocab_size": 64, "hidden_size": 32,
                      "num_hidden_layers": 1, "num_attention_heads": 4,
                      "intermediate_size": 64, "dtype": "float32"},
    "bert": {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 1,
             "num_attention_heads": 4, "intermediate_size": 64,
             "dtype": "float32"},
    "t5": {"vocab_size": 64, "d_model": 32, "d_kv": 8, "d_ff": 64,
           "num_layers": 1, "num_heads": 4, "dtype": "float32"},
    "bart": {"vocab_size": 64, "d_model": 32, "encoder_layers": 1,
             "decoder_layers": 1, "encoder_attention_heads": 4,
             "decoder_attention_heads": 4, "encoder_ffn_dim": 64,
             "decoder_ffn_dim": 64, "max_position_embeddings": 16,
             "dtype": "float32"},
    "pegasus": {"vocab_size": 64, "d_model": 32, "encoder_layers": 1,
                "decoder_layers": 1, "encoder_attention_heads": 4,
                "decoder_attention_heads": 4, "encoder_ffn_dim": 64,
                "decoder_ffn_dim": 64, "max_position_embeddings": 16,
                "dtype": "float32"},
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_auto_resolves_the_ported_families_as_jax(tmp_path, family):
    """``AutoConfig.from_pretrained`` (``model_type`` from
    ``config.json``) and ``for_model`` give the JAX package's config
    class names and values; ``AutoModel.from_config`` builds each head
    the JAX registry names, on the CPU."""
    from fengshen_tpu.models.auto import AutoConfig as JaxConfig
    from fengshen_tpu.models.auto.auto_factory import MODEL_REGISTRY as JREG
    from fengshen_tpu_torch.models.auto import AutoConfig, AutoModel
    from fengshen_tpu_torch.models.auto.auto_factory import MODEL_REGISTRY
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": family, **FAMILIES[family]}))
    cfg = AutoConfig.from_pretrained(str(tmp_path))
    jcfg = JaxConfig.from_pretrained(str(tmp_path))
    assert type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert AutoConfig.for_model(family, **FAMILIES[family]) == cfg
    assert MODEL_REGISTRY[family][1:] == JREG[family][1:]
    for head, cls in MODEL_REGISTRY[family][2].items():
        kw = {} if cls == "LlamaModel" else {"device": "cpu"}
        assert type(AutoModel.from_config(cfg, head=head, **kw)).__name__ \
            == cls


def test_auto_refuses_unported_and_unknown_families(tmp_path):
    """A family the JAX package registers and the port lacks names
    queue 1 item 11; an unknown ``model_type`` raises ``KeyError`` as
    the JAX registry does; the reference's char-level T5 tokenizer
    (``t5_char``) resolves to the port's ``T5Tokenizer``, as the JAX
    ``AutoTokenizer`` resolves it; ``register_model`` extends the
    registry."""
    from fengshen_tpu.models.auto import AutoTokenizer as JaxTokenizer
    from fengshen_tpu.models.auto.auto_factory import MODEL_REGISTRY as JREG
    from fengshen_tpu_torch.models.auto import (AutoConfig, AutoModel,
                                                AutoTokenizer,
                                                register_model)
    from fengshen_tpu_torch.models.auto import auto_factory
    assert set(JREG) == set(auto_factory.MODEL_REGISTRY) | \
        set(auto_factory.NOT_YET_PORTED)
    for family in ("roformer", "longformer", "zen"):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            AutoConfig.for_model(family)
    with pytest.raises(KeyError, match="unknown model_type"):
        AutoConfig.for_model("nope")
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "t5", "tokenizer_class": "t5_char"}))
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[EOS]"] +
        list("今天天气很好摘要")))
    tok = AutoTokenizer.from_pretrained(str(tmp_path))
    jtok = JaxTokenizer.from_pretrained(str(tmp_path))
    assert type(tok).__name__ == type(jtok).__name__ == "BertTokenizer"
    assert tok.eos_token == jtok.eos_token == "[EOS]"
    assert tok.sentinel_token_ids == jtok.sentinel_token_ids
    assert len(tok.sentinel_token_ids) == 118
    assert tok.encode("今天<extra_id_3>很好") == \
        jtok.encode("今天<extra_id_3>很好")
    cfg = AutoConfig.for_model("gpt2", **FAMILIES["gpt2"])
    with pytest.raises(KeyError, match="no registered model"):
        AutoModel.from_config(cfg, head="masked_lm")
    register_model("gpt2-fake", "fengshen_tpu_torch.models.gpt2",
                   "GPT2Config", {"base": "GPT2Model"})
    try:
        assert AutoConfig.for_model("gpt2-fake", n_embd=16).n_embd == 16
    finally:
        auto_factory.MODEL_REGISTRY.pop("gpt2-fake")
