"""The port's classification slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port, the weights carried by ``params_from_jax``:

- ``ops``: the activations and ``LayerNorm``; ``dot_product_attention``
  with ``impl="flash"`` (no mask, a padding mask, segment ids) and its
  ``ValueError``s.
- ``models/megatron_bert``: the encoder (hidden and pooled) and every
  head (pre-training, masked LM, sequence and token classification,
  question answering, multiple choice), with the 2-D and 3-D masks,
  token types, the per-layer and the scanned trees, and gradient
  checkpointing (gradients against ``jax.grad``); ``models/bert``:
  ``BertModel``, ``BertForMaskedLM`` and two factory heads.
- The HF import: a ``pytorch_model.bin`` and a ``.safetensors`` of a
  ``transformers`` model, written here, loaded by both packages, give
  equal encoders (and HF's own hidden states); the port's export gives
  the HF tensors back.
- ``examples/classification``: the collator's batches and the
  datamodule's loaders bitwise; ``ClassificationModule``'s step-1 loss,
  ``train_acc`` and gradients against ``jax.grad``, ``val_acc`` and
  ``predict_step`` (dropout off); ``save_test``'s file byte for byte;
  LoRA adapting the same projections; a CPU ``main()`` that fits,
  checkpoints on ``val_acc`` and predicts, and whose ``--do_predict_only``
  rerun writes the same file; the train loader reshuffling per epoch as
  the JAX sampler given the epoch; the reference shells' flags; the
  refusals; and the dropout generator repeating across a resume.

Tolerances: fp32 within 1e-5 (the two differ by reduction order, ~1e-7
relative here). bf16 (compute) within BF16_ATOL + BF16_RTOL x |want|:
both round every product and activation to bf16 (2^-8 relative), but
in another order (a fused bias add, XLA's elementwise chains), so a
value of order one moves by a few ulps, ~1e-2, through two layers.

Hygiene: torch runs on one intra-op thread (restored after); the port's
Trainer installs a process-wide SIGTERM handler, put back after each
test; the HF model is drawn inside ``torch.random.fork_rng``.
"""

import glob
import json
import os
import re
import shlex
import signal
import types

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.examples.classification import (
    finetune_classification as fc)
from fengshen_tpu_torch.models import bert as port_bert
from fengshen_tpu_torch.models import megatron_bert as port_mb
from fengshen_tpu_torch.models.bert import convert as bert_convert
from fengshen_tpu_torch.models.megatron_bert import convert as mb_convert
from fengshen_tpu_torch.models.megatron_bert.convert import params_from_jax
from fengshen_tpu_torch.ops.dropout import step_generator
from fengshen_tpu_torch.trainer import trainer as port_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_ATOL = 1e-5
BF16_ATOL, BF16_RTOL = 3e-2, 2e-2
SMALL = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
#: the encoder-decoder families' tiny configs (dropout off)
SEQ2SEQ = {"t5": dict(d_model=32, d_kv=8, d_ff=64, num_layers=2,
                      num_heads=4, feed_forward_proj="gated-gelu",
                      dropout_rate=0.0),
           "bart": dict(d_model=32, encoder_layers=2, decoder_layers=2,
                        encoder_attention_heads=4,
                        decoder_attention_heads=4, encoder_ffn_dim=64,
                        decoder_ffn_dim=64, dropout=0.0)}
CHARS = list("蚂蚁花呗借呗如何开通还款利息手续费用查询额度提升冻结解冻转账"
             "收款验证失败异常原因网络天气很好糟糕")
#: the classification flags of a tiny CPU run
RUN_FLAGS = ["--texta_name", "sentence1", "--textb_name", "sentence2",
             "--train_batchsize", "4", "--valid_batchsize", "4",
             "--max_length", "24", "--learning_rate", "1e-3",
             "--log_every_n_steps", "1", "--device", "cpu"]


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


def _inputs(seed=0, batch=2, seq=9, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[1, 6:] = 0
    types_ = np.zeros((batch, seq), np.int32)
    types_[:, 5:] = 1
    # a per-sample [B, S, S] mask: causal in row 0, two blocks in row 1
    mask3 = np.zeros((batch, seq, seq), np.int32)
    mask3[0] = np.tril(np.ones((seq, seq)))
    mask3[1, :4, :4] = 1
    mask3[1, 4:, 4:] = 1
    return ids, mask, types_, mask3


def _close(got, want, dtype):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


# -- ops ----------------------------------------------------------------------

def test_activations_and_layer_norm_match_jax():
    """Every activation name in fp32 (and gelu in bf16), ``is_gated``,
    and ``LayerNorm`` with fp32 statistics over fp32 and bf16 inputs
    with a trained-looking scale and bias."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.ops import activations as jact
    from fengshen_tpu.ops.norms import LayerNorm as JaxLayerNorm
    from fengshen_tpu_torch.ops import activations
    from fengshen_tpu_torch.ops.norms import LayerNorm

    x = np.random.RandomState(1).randn(4, 16).astype(np.float32) * 3
    for name in sorted(jact._ACTIVATIONS):
        want = jact.get_activation(name)(jnp.asarray(x))
        got = activations.get_activation(name.upper())(torch.from_numpy(x))
        _close(got, want, "float32")
        assert activations.is_gated(name) == jact.is_gated(name)
    xb = jnp.asarray(x, jnp.bfloat16)
    _close(activations.get_activation("gelu")(
        torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()),
        jact.get_activation("gelu")(xb), "bfloat16")
    with pytest.raises(ValueError, match="unknown activation"):
        activations.get_activation("nope")
    scale = np.random.RandomState(2).randn(16).astype(np.float32)
    bias = np.random.RandomState(3).randn(16).astype(np.float32)
    params = {"params": {"scale": scale, "bias": bias}}
    norm = LayerNorm(16, epsilon=1e-12)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    for dtype in ("float32", "bfloat16"):
        xin = jnp.asarray(x, dtype)
        want = JaxLayerNorm(epsilon=1e-12).apply(params, xin)
        got = norm(torch.from_numpy(np.asarray(xin, np.float32)).to(
            getattr(torch, dtype)))
        assert str(got.dtype) == f"torch.{dtype}"
        _close(got, want, dtype)
    assert jax.numpy.dtype(want.dtype).name == "bfloat16"


@pytest.mark.parametrize("case", ["none", "mask", "segments"])
def test_flash_impl_matches_jax(case):
    """``impl="flash"`` goes to flash attention (the plain blockwise
    path on the CPU) with the mask folded into the bias and the segment
    ids passed through, as the reference does; attention dropout there
    and an unknown impl raise ``ValueError``."""
    import jax.numpy as jnp

    from fengshen_tpu.ops.attention import dot_product_attention as jax_dpa
    from fengshen_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 24, 2, 16).astype(np.float32) for _ in range(3))
    kw_np = {}
    if case == "mask":
        mask = np.ones((2, 24), bool)
        mask[1, 15:] = False
        kw_np["mask"] = mask[:, None, None, :]
    elif case == "segments":
        kw_np["segment_ids"] = np.repeat(
            np.array([[1, 2, 3], [1, 1, 2]], np.int32), 8, axis=1)
    want = jax_dpa(*(jnp.asarray(a) for a in (q, k, v)), impl="flash",
                   **{k_: jnp.asarray(a) for k_, a in kw_np.items()})
    got = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                impl="flash", **{k_: torch.from_numpy(a)
                                                 for k_, a in kw_np.items()})
    _close(got, want, "float32")
    if case == "none":
        qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
        with pytest.raises(ValueError, match="dropout"):
            dot_product_attention(qt, kt, vt, impl="flash",
                                  dropout_rate=0.1, deterministic=False,
                                  dropout_rng=torch.Generator())
        with pytest.raises(ValueError, match="unknown attention impl"):
            dot_product_attention(qt, kt, vt, impl="no_such_impl")


# -- models -------------------------------------------------------------------

#: (dtype, scan_layers, mask kind, gradient checkpointing)
MB_CASES = {
    "fp32-2d": ("float32", False, "2d", False),
    "fp32-scan-3d": ("float32", True, "3d", False),
    "fp32-remat-grads": ("float32", False, "2d", True),
    "bf16-2d": ("bfloat16", False, "2d", False),
}


@pytest.mark.parametrize("case", sorted(MB_CASES))
def test_megatron_bert_and_heads_match_jax(case):
    """The encoder's hidden and pooled outputs and every head's outputs
    against the JAX package's on the same weights and inputs (token
    types set); multiple choice over the rows as two choices. With
    gradient checkpointing the gradients of the classifier's summed
    logits are held to ``jax.grad`` of the remat model too."""
    import jax
    import jax.numpy as jnp

    import fengshen_tpu.models.megatron_bert as jmb

    dtype, scan, mask_kind, remat = MB_CASES[case]
    over = dict(SMALL, dtype=dtype, scan_layers=scan,
                gradient_checkpointing=remat)
    jcfg = jmb.MegatronBertConfig.small_test_config(**over)
    cfg = port_mb.MegatronBertConfig.small_test_config(**over)
    ids, mask2, tt, mask3 = _inputs()
    mask = mask2 if mask_kind == "2d" else mask3
    pairs = [(jmb.MegatronBertModel, port_mb.MegatronBertModel),
             (jmb.MegatronBertForPreTraining,
              port_mb.MegatronBertForPreTraining),
             (jmb.MegatronBertForMaskedLM, port_mb.MegatronBertForMaskedLM),
             (jmb.MegatronBertForSequenceClassification,
              port_mb.MegatronBertForSequenceClassification),
             (jmb.MegatronBertForTokenClassification,
              port_mb.MegatronBertForTokenClassification),
             (jmb.MegatronBertForQuestionAnswering,
              port_mb.MegatronBertForQuestionAnswering),
             (jmb.MegatronBertForMultipleChoice,
              port_mb.MegatronBertForMultipleChoice)]
    for i, (jcls, pcls) in enumerate(pairs):
        args = (ids, mask, tt)
        if jcls is jmb.MegatronBertForMultipleChoice:
            args = tuple(a[None] for a in args)
        jm = jcls(jcfg)
        if jcls is jmb.MegatronBertForQuestionAnswering or \
                jcls is jmb.MegatronBertForMultipleChoice:
            call = lambda m, p, a: m.apply(  # noqa: E731
                p, a[0], attention_mask=a[1], token_type_ids=a[2])
        else:
            call = lambda m, p, a: m.apply(p, *a)  # noqa: E731
        jargs = tuple(jnp.asarray(a) for a in args)
        params = jm.init(jax.random.PRNGKey(i), jargs[0])
        want = call(jm, params, jargs)
        model = pcls(cfg, device="cpu")
        model.load_state_dict(params_from_jax(_np_tree(params["params"]),
                                              cfg))
        targs = tuple(_t(a) for a in args)
        kw = {"attention_mask": targs[1], "token_type_ids": targs[2]}
        with torch.no_grad():
            got = model(targs[0], **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
            _close(g, w, dtype)
        if remat and jcls is jmb.MegatronBertForSequenceClassification:
            jgrads = jax.grad(lambda p: call(jm, p, jargs).sum())(params)
            model(targs[0], **kw).sum().backward()
            want_grads = params_from_jax(_np_tree(jgrads["params"]), cfg)
            for name, p in model.named_parameters():
                _close(p.grad, want_grads[name].numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_matches_jax(dtype):
    """``BertModel`` (hidden, pooled), ``BertForMaskedLM`` and the
    factory's sequence-classification and question-answering heads
    against the JAX package's, with a padding mask and token types."""
    import jax
    import jax.numpy as jnp

    import fengshen_tpu.models.bert as jbert

    over = dict(SMALL, dtype=dtype)
    jcfg = jbert.BertConfig.small_test_config(**over)
    cfg = port_bert.BertConfig.small_test_config(**over)
    ids, mask, tt, _ = _inputs(seed=5)
    for i, (jcls, pcls) in enumerate([
            (jbert.BertModel, port_bert.BertModel),
            (jbert.BertForMaskedLM, port_bert.BertForMaskedLM),
            (jbert.BertForSequenceClassification,
             port_bert.BertForSequenceClassification),
            (jbert.BertForQuestionAnswering,
             port_bert.BertForQuestionAnswering)]):
        jm = jcls(jcfg)
        params = jm.init(jax.random.PRNGKey(i), jnp.asarray(ids))
        want = jm.apply(params, jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask),
                        token_type_ids=jnp.asarray(tt))
        model = pcls(cfg, device="cpu")
        model.load_state_dict(bert_convert.params_from_jax(
            _np_tree(params["params"]), cfg))
        with torch.no_grad():
            got = model(_t(ids), attention_mask=_t(mask),
                        token_type_ids=_t(tt))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            _close(g, w, dtype)


HF_CASES = [("megatron_bert", "bin"), ("megatron_bert", "safetensors"),
            ("bert", "bin"), ("bert", "safetensors")]


@pytest.mark.parametrize("family,fmt", HF_CASES)
def test_hf_checkpoint_loads_into_both_packages(tmp_path, family, fmt):
    """A ``transformers`` pre-training model's weights written as
    ``pytorch_model.bin`` or ``model.safetensors`` and read by each
    package's ``load_torch_checkpoint`` and ``torch_to_params``: the two
    encoders (and the MLM head) agree, the port's encoder gives HF's own
    hidden states, and the port's ``params_to_torch_state`` gives HF's
    tensors back bitwise. The port also reads the same weights from a
    Lightning ``model.ckpt``, and ``ClassificationModule.init_params``
    imports the checkpoint's encoder bitwise."""
    import jax.numpy as jnp
    import safetensors.torch
    import transformers

    from fengshen_tpu.utils import convert_common as jcc
    from fengshen_tpu_torch.utils.convert_common import load_torch_checkpoint

    geometry = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64)
    if family == "megatron_bert":
        import fengshen_tpu.models.megatron_bert as jfam
        from fengshen_tpu.models.megatron_bert import convert as jconv
        hf_cls = transformers.MegatronBertForPreTraining
        hf_cfg = transformers.MegatronBertConfig(**geometry)
        pfam, pconv = port_mb, mb_convert
        jcfg = jfam.MegatronBertConfig.small_test_config(dtype="float32")
        cfg = pfam.MegatronBertConfig.small_test_config(dtype="float32")
        jhead, phead = jfam.MegatronBertForPreTraining, \
            pfam.MegatronBertForPreTraining
        jparams = lambda s: jconv.torch_to_params(s, jcfg)  # noqa: E731
    else:
        import fengshen_tpu.models.bert as jfam
        from fengshen_tpu.models.bert import convert as jconv
        hf_cls = transformers.BertForPreTraining
        hf_cfg = transformers.BertConfig(**geometry)
        pfam, pconv = port_bert, bert_convert
        jcfg = jfam.BertConfig.small_test_config(dtype="float32")
        cfg = pfam.BertConfig.small_test_config(dtype="float32")
        jhead, phead = jfam.BertForMaskedLM, pfam.BertForMaskedLM
        jparams = lambda s: jconv.torch_to_params(s, jcfg)  # noqa: E731
    with torch.random.fork_rng():
        torch.manual_seed(11)
        hf = hf_cls(hf_cfg).eval()
        hf.bert.pooler.dense.bias.data.normal_()    # zero after init
    state = {k: v.clone().contiguous() for k, v in hf.state_dict().items()}
    if fmt == "bin":
        torch.save(state, tmp_path / "pytorch_model.bin")
        # a Lightning checkpoint of the same weights: unwrapped, its
        # module's ``model.`` prefix stripped
        (tmp_path / "lightning").mkdir()
        torch.save({"epoch": 3, "state_dict": {
            f"model.{k}": v for k, v in state.items()}},
            tmp_path / "lightning" / "model.ckpt")
        unwrapped = load_torch_checkpoint(str(tmp_path / "lightning"))
        assert unwrapped.keys() == state.keys()
        assert all(torch.equal(unwrapped[k], v) for k, v in state.items())
    else:
        safetensors.torch.save_file(state,
                                    str(tmp_path / "model.safetensors"))
    ids, mask, tt, _ = _inputs(seed=6)
    want = jhead(jcfg).apply(
        {"params": jparams(jcc.load_torch_checkpoint(str(tmp_path)))},
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt))
    loaded = load_torch_checkpoint(str(tmp_path))
    port_state = pconv.torch_to_params(loaded, cfg)
    model = phead(cfg, device="cpu")
    # BertForMaskedLM has no pooler; the pre-training checkpoint has one
    missing, unexpected = model.load_state_dict(port_state, strict=False)
    assert not missing and set(unexpected) <= {"bert.pooler.weight",
                                               "bert.pooler.bias"}
    with torch.no_grad():
        got = model(_t(ids), _t(mask), _t(tt))
        hidden, _ = model.bert(_t(ids), _t(mask), _t(tt))
        hf_hidden = hf.bert(_t(ids), attention_mask=_t(mask),
                            token_type_ids=_t(tt)).last_hidden_state
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, w, "float32")
    _close(hidden, hf_hidden.numpy(), "float32")
    exported = pconv.params_to_torch_state(model.state_dict(), cfg)
    assert set(exported) <= set(state)
    for name, t in exported.items():
        assert torch.equal(t, state[name]), name
    left = {k for k in state if k not in exported}
    assert left <= {"cls.seq_relationship.weight", "cls.seq_relationship.bias",
                    "bert.pooler.dense.weight", "bert.pooler.dense.bias"}
    # the classification module imports the checkpoint's encoder
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": {"megatron_bert": "megatron-bert"}.get(family, family),
         "dtype": "float32", **geometry}))
    module = fc.ClassificationModule(fc.build_parser().parse_args([
        "--pretrained_model_path", str(tmp_path), "--model_type",
        "huggingface-auto"]), device="cpu")
    module.init_params(torch.Generator().manual_seed(0))
    encoder = module.model.bert_encoder.state_dict()
    assert encoder.keys() == {k[len("bert."):] for k in port_state
                              if k.startswith("bert.")}
    for name, t in encoder.items():
        assert torch.equal(t, port_state[f"bert.{name}"].float()), name


# -- the classification example -------------------------------------------------

def _task_dir(tmp_path, n_train=12, n_dev=6, n_test=7, empty_b=()):
    rng = np.random.RandomState(0)
    data_dir = tmp_path / "afqmc"
    data_dir.mkdir(exist_ok=True)
    for name, n in (("train.json", n_train), ("dev.json", n_dev),
                    ("test.json", n_test)):
        with open(data_dir / name, "w") as f:
            for i in range(n):
                row = {"id": i, "sentence1": "".join(rng.choice(CHARS, 6)),
                       "sentence2": "" if i in empty_b else
                       "".join(rng.choice(CHARS, 5)),
                       "label": ["1", "0"][i % 2]}
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
    return data_dir


def _tokenizer(tmp_path):
    from transformers import BertTokenizer
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        sorted(set(CHARS))
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizer(str(tmp_path / "vocab.txt")), len(vocab)


def _model_dir(tmp_path, vocab, model_type="megatron-bert", **over):
    model_dir = tmp_path / "model"
    model_dir.mkdir(exist_ok=True)
    cfg = {"model_type": model_type, "vocab_size": vocab, "hidden_size": 32,
           "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 64, "max_position_embeddings": 64,
           "type_vocab_size": 2, "dtype": "float32", **over}
    (model_dir / "config.json").write_text(json.dumps(cfg))
    return model_dir


def test_collator_and_loaders_equal_jax(tmp_path):
    """``TaskCollator`` decides pair or single per sample (rows 2 and 5
    have no second text) and its batches are bitwise the JAX package's;
    so are the train (shuffled, epoch 1), validation and prediction
    loaders' batches, and the label schema (first-seen order)."""
    from fengshen_tpu.examples.classification import (
        finetune_classification as jfc)
    tok, vocab = _tokenizer(tmp_path)
    data_dir = _task_dir(tmp_path, empty_b=(2, 5))
    argv = ["--data_dir", str(data_dir), "--pretrained_model_path",
            str(_model_dir(tmp_path, vocab)), *RUN_FLAGS[:8]]
    args = fc.build_parser().parse_args(argv)
    jargs = jfc.build_parser().parse_args(argv)
    port_dm, jax_dm = fc.TaskDataModel(args, tok), \
        jfc.TaskDataModel(jargs, tok)
    assert port_dm.label2id == jax_dm.label2id == {"1": 0, "0": 1}
    for name in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        got, want = getattr(port_dm, name)(), getattr(jax_dm, name)()
        got.sampler.set_epoch(1)
        want.sampler.set_epoch(1)
        got, want = list(got), list(want)
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
    batch = port_dm.collator([port_dm.train_data[i] for i in range(6)])
    assert (batch["token_type_ids"][[2, 5]] == 0).all()
    assert (batch["token_type_ids"][[0, 1, 3, 4]].max(-1) == 1).all()


def _module_pair(tmp_path, model_type, lora_rank=0):
    """The JAX and the port ``ClassificationModule`` on one tiny config,
    the port holding the JAX initial parameters (after LoRA's, when
    ``lora_rank``)."""
    import jax

    from fengshen_tpu.examples.classification import (
        finetune_classification as jfc)
    from fengshen_tpu.trainer.modules import maybe_wrap_lora as jax_wrap
    from fengshen_tpu_torch.trainer.modules import maybe_wrap_lora

    family, over = {"huggingface-megatron_bert": ("megatron-bert", SMALL),
                    "huggingface-bert": ("bert", SMALL),
                    "fengshen-megatron_t5": ("t5", SEQ2SEQ["t5"]),
                    "fengshen-bart": ("bart", SEQ2SEQ["bart"])}[model_type]
    model_dir = _model_dir(tmp_path, 128, family, **over)
    argv = ["--pretrained_model_path", str(model_dir), "--model_type",
            model_type, "--num_labels", "3", "--max_length", "9",
            "--lora_rank", str(lora_rank)]
    jmod = jax_wrap(jfc.ClassificationModule(
        jfc.build_parser().parse_args(argv)),
        jfc.build_parser().parse_args(argv))
    params = jmod.init_params(jax.random.PRNGKey(3))
    pmod = maybe_wrap_lora(fc.ClassificationModule(
        fc.build_parser().parse_args(argv), device="cpu"),
        fc.build_parser().parse_args(argv))
    pmod.init_params(torch.Generator().manual_seed(0))
    if lora_rank == 0:
        pmod.model.load_state_dict(params_from_jax(_np_tree(params), None))
    return jmod, params, pmod


@pytest.mark.parametrize("model_type", ["huggingface-megatron_bert",
                                        "huggingface-bert"])
def test_classification_module_matches_jax(tmp_path, model_type):
    """Step 1 with dropout off: the loss, ``train_acc`` and every
    gradient against ``jax.grad`` of the JAX module's
    ``training_loss``; ``val_acc`` and ``predict_step``'s ids and fp32
    logits."""
    import jax
    import jax.numpy as jnp

    jmod, params, pmod = _module_pair(tmp_path, model_type)
    ids, mask, tt, _ = _inputs(seed=8)
    batch = {"input_ids": ids, "attention_mask": mask, "token_type_ids": tt,
             "labels": np.array([2, 1], np.int32),
             "id": np.array([10, 11], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jmod.training_loss, has_aux=True)(params, jbatch, rng)
    pmod.set_dropout_generator(step_generator(42, 0))
    loss, met = pmod.training_loss(tbatch)
    loss.backward()
    _close(loss, jloss, "float32")
    assert float(met["train_acc"]) == float(jmet["train_acc"])
    want = params_from_jax(_np_tree(jgrads), None)
    for name, p in pmod.model.named_parameters():
        _close(p.grad, want[name].numpy(), "float32")
    vloss, vmet = pmod.validation_loss(tbatch)
    jvloss, jvmet = jmod.validation_loss(params, jbatch, rng)
    _close(vloss, jvloss, "float32")
    assert float(vmet["val_acc"]) == float(jvmet["val_acc"])
    with torch.no_grad():
        out = pmod.predict_step(tbatch)
    jout = jmod.predict_step(params, jbatch)
    assert out["logits"].dtype == torch.float32
    np.testing.assert_array_equal(out["id"].numpy(), np.asarray(jout["id"]))
    _close(out["logits"], jout["logits"], "float32")


@pytest.mark.parametrize("model_type", ["huggingface-megatron_bert",
                                        "huggingface-bert"])
def test_lora_adapts_the_same_projections_as_jax(tmp_path, model_type):
    """``--lora_rank`` with the reference's defaults adapts the same
    projections, by name and count, as the JAX package
    (``self/(query|key|value)`` and ``attention_output_dense``: four a
    layer for MegatronBert, one for BERT, whose q/k/v are not under
    ``self``) and trains ``cls_layer`` fully; the adapted biased
    projections keep their biases, so the initial logits equal the
    base's, and a step's gradients reach the adapters and the head
    only."""
    from fengshen_tpu.ops.lora import target_kernel_paths
    from fengshen_tpu_torch.ops.lora import LoraLinear, param_path

    jmod, params, pmod = _module_pair(tmp_path, model_type, lora_rank=4)
    want = {"/".join(path) for path, _, _ in target_kernel_paths(
        params["base"], jmod.target_regex)}
    got = {param_path(n) for n, m in pmod.model.named_modules()
           if isinstance(m, LoraLinear)}
    per_layer = 4 if model_type == "huggingface-megatron_bert" else 1
    assert got == want and len(got) == 2 * per_layer
    trainable = {n for n, p in pmod.model.named_parameters()
                 if p.requires_grad}
    adapters = {f"{n.replace('/', '.')}.{leaf}" for n in got
                for leaf in ("lora_a", "lora_b")}
    assert trainable == adapters | {"cls_layer.weight", "cls_layer.bias"}
    ids, mask, tt, _ = _inputs(seed=9)
    batch = {"input_ids": _t(ids), "attention_mask": _t(mask),
             "token_type_ids": _t(tt), "labels": _t([0, 2])}
    base = {n: m.bias for n, m in pmod.model.named_modules()
            if isinstance(m, LoraLinear)}
    assert all(b is not None for b in base.values())
    with torch.no_grad():
        adapted = pmod.model(batch["input_ids"], batch["attention_mask"],
                             batch["token_type_ids"])
        for m in pmod.model.modules():
            if isinstance(m, LoraLinear):
                assert not m.lora_b.any()
    pmod.set_dropout_generator(step_generator(42, 0))
    pmod.training_loss(batch)[0].backward()
    moved = {n for n, p in pmod.model.named_parameters()
             if p.grad is not None}
    assert moved == trainable
    assert torch.isfinite(adapted).all()


def test_save_test_writes_the_jax_file(tmp_path):
    """The same ids and logits (a cycled duplicate in the tail) give the
    JAX package's file byte for byte, each id once; the port also takes
    tensors."""
    from fengshen_tpu.examples.classification import (
        finetune_classification as jfc)
    rng = np.random.RandomState(10)
    data = [{"id": np.array([0, 1, 2]), "logits": rng.randn(3, 3)},
            {"id": np.array([3, 0, 1]), "logits": rng.randn(3, 3)}]
    dm = types.SimpleNamespace(id2label={0: "甲", 1: "1", 2: "2"})
    jargs = types.SimpleNamespace(output_save_path=str(tmp_path / "j.json"))
    pargs = types.SimpleNamespace(output_save_path=str(tmp_path / "p.json"))
    jfc.save_test(data, jargs, dm)
    fc.save_test([{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                  for d in data], pargs, dm)
    want = (tmp_path / "j.json.0").read_bytes()
    assert (tmp_path / "p.json.0").read_bytes() == want
    assert [json.loads(x)["id"] for x in want.decode().splitlines()] == \
        [0, 1, 2, 3]


@pytest.mark.parametrize("model_type", ["fengshen-megatron_t5",
                                        "fengshen-bart"])
def test_encoder_decoder_task_models_match_jax(tmp_path, model_type):
    """``fengshen-megatron_t5`` (``T5EncoderModel``, the first token
    pooled) and ``fengshen-bart`` (``BartModel.encode``, the last real
    token pooled, a padded row included): the ``TaskModel`` forward's
    fp32 logits, the step-1 loss and every gradient against the JAX
    module's, dropout off."""
    import jax
    import jax.numpy as jnp

    jmod, params, pmod = _module_pair(tmp_path, model_type)
    ids, mask, _, _ = _inputs(seed=9)
    batch = {"input_ids": ids, "attention_mask": mask,
             "labels": np.array([2, 0], np.int32),
             "id": np.array([3, 4], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        out = pmod.predict_step(tbatch)
    jout = jmod.predict_step(params, jbatch)
    assert out["logits"].dtype == torch.float32
    _close(out["logits"], jout["logits"], "float32")
    (jloss, _), jgrads = jax.value_and_grad(
        jmod.training_loss, has_aux=True)(params, jbatch,
                                          jax.random.PRNGKey(0))
    pmod.set_dropout_generator(step_generator(42, 0))
    loss, _ = pmod.training_loss(tbatch)
    loss.backward()
    _close(loss, jloss, "float32")
    want = params_from_jax(_np_tree(jgrads), None)
    assert want.keys() == dict(pmod.model.named_parameters()).keys()
    for name, p in pmod.model.named_parameters():
        _close(p.grad, want[name].numpy(), "float32")


def _shell_argv(path, tmp_path):
    """The flags of a reference shell's python command, its variables
    replaced by paths under ``tmp_path``."""
    text = open(path).read()
    cmd = text[text.index("python -m"):]
    cmd = re.sub(r"\\\n", " ", cmd).split("\n")[0]
    cmd = re.sub(r"\$(\w+)|\$\{(\w+)[^}]*\}",
                 lambda m: str(tmp_path / (m.group(1) or m.group(2))), cmd)
    return shlex.split(cmd)[3:]


def test_reference_shells_parse_and_their_values_act(tmp_path, caplog):
    """Every ``finetune_classification_*.sh`` / ``demo_classification_*``
    shell of the reference parses; ``--save_weights_only True`` is a
    value, ``--save_top_k`` a float made an int, and the checkpoint
    callback built from the AFQMC shell's flags monitors ``val_acc``
    under ``max``, saving after validation (``--every_n_train_steps
    0``). ``huggingface-auto`` (the demos' type) resolves through
    ``config.json``, and warns when it has to guess."""
    shells = sorted(glob.glob(os.path.join(
        ROOT, "fengshen_tpu", "examples", "classification", "*.sh")))
    assert len(shells) == 14
    for path in shells:
        args = fc.build_parser().parse_args(_shell_argv(path, tmp_path))
        assert isinstance(args.save_weights_only, bool)
    args = fc.build_parser().parse_args(_shell_argv(next(
        p for p in shells if p.endswith("bert-3.9B_afqmc.sh")), tmp_path))
    assert args.save_weights_only is True and args.save_top_k == 3.0
    assert args.filename == "model-{epoch:02d}-{val_acc:.4f}"
    cb = fc.TaskModelCheckpoint(args).callbacks
    assert (cb.monitor, cb.mode, cb.every_n_train_steps) == \
        ("val_acc", "max", 0)
    assert args.save_top_k == 3 and args.save_ckpt_path == args.dirpath
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        format_checkpoint_name)
    assert format_checkpoint_name(args.filename, {
        "epoch": 3, "val_acc": 0.53125}) == "model-epoch=03-val_acc=0.5312"
    for model_type, want in (("roberta", "huggingface-bert"),
                             ("megatron-bert", "huggingface-megatron_bert")):
        (tmp_path / "config.json").write_text(json.dumps(
            {"model_type": model_type}))
        assert fc.resolve_model_type("huggingface-auto",
                                     str(tmp_path)) == want
    assert fc.resolve_model_type("huggingface-bert", "nowhere") == \
        "huggingface-bert"
    with caplog.at_level("WARNING"):
        assert fc.resolve_model_type(
            "huggingface-auto", str(tmp_path / "missing")) == \
            "huggingface-megatron_bert"
    assert "assuming a MegatronBert-family checkpoint" in caplog.text


def test_main_fits_checkpoints_on_val_acc_and_predicts(tmp_path):
    """A CPU ``main()`` at tiny size with the AFQMC shell's checkpoint
    flags: it validates every 2 steps, keeps the 2 best steps by
    ``val_acc`` (each ``meta.json`` naming its value and its formatted
    file name), predicts from the best one every test id once with a
    label of the schema, and a ``--do_predict_only`` rerun writes the
    same file."""
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        committed_steps, read_meta)
    tok, vocab = _tokenizer(tmp_path)
    data_dir = _task_dir(tmp_path)
    ckpt = tmp_path / "ckpt"
    argv = ["--pretrained_model_path", str(_model_dir(tmp_path, vocab)),
            "--model_type", "huggingface-auto", "--data_dir", str(data_dir),
            *RUN_FLAGS, "--max_epochs", "3", "--val_check_interval", "2",
            "--monitor", "val_acc", "--mode", "max", "--save_top_k", "2",
            "--every_n_train_steps", "0", "--save_weights_only", "True",
            "--dirpath", str(ckpt), "--filename",
            "model-{epoch:02d}-{val_acc:.4f}", "--output_save_path",
            str(tmp_path / "predict.json"), "--default_root_dir",
            str(tmp_path / "runs")]
    trainer = fc.main(argv, tokenizer=tok)
    losses = [e["loss"] for e in trainer.history if "loss" in e]
    vals = {e["step"]: e["val_acc"] for e in trainer.history
            if "val_acc" in e}
    assert len(losses) == 9 and np.isfinite(losses).all()
    assert sorted(vals) == [2, 4, 6, 8]
    kept = committed_steps(str(ckpt))
    ranked = sorted(vals, key=lambda s: (-vals[s], s))
    assert kept == sorted(ranked[:2])
    for step in kept:
        meta = read_meta(str(ckpt), step)
        assert meta["monitor"] == {"name": "val_acc", "value": vals[step]}
        assert re.fullmatch(r"model-epoch=\d\d-val_acc=\d\.\d{4}",
                            meta["filename"])
        assert "optimizer" not in meta
    assert trainer.global_step == ranked[0]
    first = (tmp_path / "predict.json.0").read_text()
    rows = [json.loads(x) for x in first.splitlines()]
    assert [r["id"] for r in rows] == list(range(7))
    assert {r["label"] for r in rows} <= {"0", "1"}
    again = fc.main(argv + ["--do_predict_only"], tokenizer=tok)
    assert again.global_step == ranked[0]
    assert (tmp_path / "predict.json.0").read_text() == first


def _jax_epoch_order(total, batch, epoch, seed=42):
    from fengshen_tpu.data.universal_datamodule import _SimpleBatchSampler
    sampler = _SimpleBatchSampler(total, batch, 0, 1, True, seed=seed,
                                  drop_last=True)
    sampler.set_epoch(epoch)
    return [[int(i) for i in b] for b in sampler]


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_train_loader_reshuffles_as_the_jax_sampler_given_the_epoch(
        tmp_path, epoch):
    """``set_epoch`` on the train loader (what the Trainer calls) reaches
    its sampler: the loader's batches are the rows of the JAX
    ``_SimpleBatchSampler`` given that epoch, in its order."""
    tok, vocab = _tokenizer(tmp_path)
    args = fc.build_parser().parse_args(
        ["--data_dir", str(_task_dir(tmp_path)), "--pretrained_model_path",
         str(_model_dir(tmp_path, vocab)), *RUN_FLAGS[:8]])
    dm = fc.TaskDataModel(args, tok)
    loader = dm.train_dataloader()
    loader.set_epoch(epoch)
    want = _jax_epoch_order(len(dm.train_data), 4, epoch)
    got = [b["id"].tolist() for b in loader]
    assert got == want
    assert got != _jax_epoch_order(len(dm.train_data), 4, epoch + 1)


def test_two_epoch_fit_sees_two_orders(tmp_path, monkeypatch):
    """A two-epoch CPU ``main()`` walks epoch 0's order, then epoch 1's
    (each the JAX sampler's given the epoch), not the same one twice."""
    tok, vocab = _tokenizer(tmp_path)
    seen = []
    real = fc.ClassificationModule.training_loss

    def recording(self, batch):
        seen.append(batch["id"].tolist())
        return real(self, batch)

    monkeypatch.setattr(fc.ClassificationModule, "training_loss",
                        recording)
    fc.main(["--pretrained_model_path", str(_model_dir(tmp_path, vocab)),
             "--model_type", "huggingface-auto", "--data_dir",
             str(_task_dir(tmp_path)), *RUN_FLAGS, "--max_epochs", "2",
             "--dirpath", str(tmp_path / "ckpt"),
             "--every_n_train_steps", str(10 ** 9), "--output_save_path",
             str(tmp_path / "predict.json"), "--default_root_dir",
             str(tmp_path / "runs")], tokenizer=tok)
    assert seen == _jax_epoch_order(12, 4, 0) + _jax_epoch_order(12, 4, 1)
    assert seen[:3] != seen[3:]


def test_refusals_name_their_queue_item(tmp_path):
    """The families the port lacks, the offload flags and
    ``--dataset_name`` raise ``NotImplementedError`` naming their
    ROADMAP.md queue item, before anything is built; an unknown family
    raises ``KeyError``."""
    tok, vocab = _tokenizer(tmp_path)
    base = ["--pretrained_model_path", str(_model_dir(tmp_path, vocab)),
            "--data_dir", str(_task_dir(tmp_path)), *RUN_FLAGS,
            "--default_root_dir", str(tmp_path / "runs")]
    for family in ("fengshen-roformer", "fengshen-longformer",
                   "fengshen-zen1"):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            fc.main(base + ["--model_type", family], tokenizer=tok)
    for flag in ("--offload_params", "--offload_optimizer"):
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            fc.main(base + [flag], tokenizer=tok)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        fc.main(base + ["--dataset_name", "afqmc"], tokenizer=tok)
    with pytest.raises(KeyError, match="no_such"):
        fc.main(base + ["--model_type", "no_such"], tokenizer=tok)
    assert not (tmp_path / "runs").exists()


class _OneBatch:
    """A datamodule whose train loader yields one fixed batch per step."""

    def __init__(self, batch, steps):
        self.batch, self.steps, self.trainer = batch, steps, None

    def train_dataloader(self):
        return _Repeat(self.batch, self.steps)

    def val_dataloader(self):
        return None


class _Repeat:
    def __init__(self, batch, steps):
        self.batch, self.steps = batch, steps
        self.num_samples = self.global_batch_size = len(batch["labels"])

    def __len__(self):
        return self.steps

    def __iter__(self):
        return iter([self.batch] * self.steps)


def test_dropout_masks_repeat_and_replay_across_a_resume(tmp_path):
    """With dropout 0.1 on, the step's generator decides the masks: the
    same step gives the same loss twice, another step another loss; and
    a fit checkpointed at step 2 and resumed gives steps 3-4 bitwise
    equal to the uninterrupted fit's (the Trainer seeds each step's
    generator from ``--seed`` and the restored step)."""
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)
    model_dir = _model_dir(tmp_path, 128, hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.1)
    ids, mask, tt, _ = _inputs(seed=12)
    batch = {"input_ids": ids, "attention_mask": mask, "token_type_ids": tt,
             "labels": np.array([1, 0], np.int32)}

    def parsed(name, steps):
        return fc.build_parser().parse_args([
            "--pretrained_model_path", str(model_dir), "--model_type",
            "huggingface-megatron_bert", "--max_steps", str(steps),
            "--learning_rate", "1e-2", "--scheduler_type", "constant",
            "--warmup_ratio", "0", "--log_every_n_steps", "1",
            "--device", "cpu", "--seed", "5", "--default_root_dir",
            str(tmp_path / name)])

    module = fc.ClassificationModule(parsed("probe", 1), device="cpu")
    module.init_params(torch.Generator().manual_seed(0))
    tb = {k: _t(v) for k, v in batch.items()}

    def loss_at(step):
        module.set_dropout_generator(step_generator(5, step))
        with torch.no_grad():
            return float(module.training_loss(tb)[0])
    assert loss_at(3) == loss_at(3) != loss_at(4)
    with torch.no_grad():
        plain = float(module.validation_loss(tb)[0])
    assert plain not in (loss_at(3), loss_at(4))

    def fit(name, steps, ckpt=None):
        args = parsed(name, steps)
        args.save_ckpt_path = args.load_ckpt_path = ckpt
        args.every_n_train_steps, args.save_top_k = 2, -1
        args.save_weights_only = False
        trainer = Trainer(args)
        if ckpt is not None:
            trainer.callbacks.append(UniversalCheckpoint(args))
        trainer.fit(fc.ClassificationModule(args, device="cpu"),
                    _OneBatch(batch, steps))
        return {e["step"]: e["loss"] for e in trainer.history
                if "loss" in e}

    whole = fit("whole", 4)
    ckpt = str(tmp_path / "ckpt")
    first = fit("first", 2, ckpt)
    resumed = fit("resumed", 4, ckpt)
    assert first == {s: whole[s] for s in (1, 2)}
    assert resumed == {s: whole[s] for s in (3, 4)}
    assert len(set(whole.values())) == 4
