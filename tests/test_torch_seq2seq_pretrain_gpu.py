"""The seq2seq pretraining and task examples on the card (``gpu``-marked;
skipped without one). This file imports no JAX, so the card's machine
runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_seq2seq_pretrain_gpu.py

- Each example's ``main`` (``pretrain_t5``, ``finetune_t5`` (UniMC),
  ``qa_t5``, ``pretrain_bart`` over an indexed corpus, ``pegasus``,
  ``finetune_bart_qg``, ``translate`` over DeltaLM) fits 2 steps at 2
  layers in fp32 on the card and on the CPU from one HF-named
  checkpoint: the logged losses finite and within 1e-4 of each other,
  and no kernel of the port launches (the families' attention is dense
  or carries T5's position bias, as in the reference).
- T5, BART, Pegasus and DeltaLM at 2 layers: the bf16 forward within
  5e-2 relative L2 of fp32 compute on the same weights and a padded
  batch.

Limits: fp32 reduction order on the two devices (~1e-6 measured on
the CPU side); bf16 rounding against fp32 (the smoke's bar).
"""

import json
import re

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.data.megatron_dataloader import \
    MMapIndexedDatasetBuilder
from fengshen_tpu_torch.examples.finetune_bart_qg import finetune_bart
from fengshen_tpu_torch.examples.pegasus import pretrain_pegasus
from fengshen_tpu_torch.examples.pretrain_randeng_bart import pretrain_bart
from fengshen_tpu_torch.examples.pretrain_t5 import finetune_t5, pretrain_t5
from fengshen_tpu_torch.examples.qa_t5 import finetune_t5_cmrc
from fengshen_tpu_torch.examples.translate import finetune_deltalm
from fengshen_tpu_torch.models import bart, deltalm, pegasus, t5
from fengshen_tpu_torch.ops.kernels import _REGISTRY, reset_launch_counts
from fengshen_tpu_torch.utils.convert_common import write_safetensors

ATOL = 1e-4
BF16_RTOL = 5e-2
CHARS = "今天天气很好我们去公园散步吧明日会下雨人工智能改变世界"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class _Tok:
    """Specials, ``CHARS``, ascending sentinels; specials and sentinels
    encode as one token each."""

    pad_token_id, eos_token_id, unk_token_id = 0, 1, 2
    cls_token_id, sep_token_id, mask_token_id = 3, 4, 5
    sep_token, mask_token = "[SEP]", "[MASK]"
    _SPECIAL = re.compile(r"(\[[A-Z]+\]|<ans>|<extra_id_\d+>)")

    def __init__(self):
        self.tokens = (["[PAD]", "[EOS]", "[UNK]", "[CLS]", "[SEP]",
                        "[MASK]", "<ans>"] + list(CHARS) +
                       [f"<extra_id_{i}>" for i in range(8)])
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        self.sentinel_token_ids = [self.vocab[f"<extra_id_{i}>"]
                                   for i in range(8)]

    def __len__(self):
        return len(self.tokens)

    def get_vocab(self):
        return dict(self.vocab)

    def encode(self, text, add_special_tokens=True):
        ids = []
        for part in self._SPECIAL.split(text):
            ids.extend([self.vocab[part]] if part in self.vocab else
                       [self.vocab.get(c, 2) for c in part])
        return ids

    def __call__(self, text, max_length=None, padding=None,
                 truncation=False):
        ids = ([3] + self.encode(text) + [4])[:max_length]
        n = len(ids)
        return {"input_ids": ids + [0] * (max_length - n),
                "attention_mask": [1] * n + [0] * (max_length - n)}


VOCAB = len(_Tok())
#: family -> (package, config class, model class, 2-layer fp32 config)
FAMILIES = {
    "t5": (t5, "T5Config", "T5ForConditionalGeneration",
           dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False,
                dropout_rate=0.0)),
    "bart": (bart, "BartConfig", "BartForConditionalGeneration",
             dict(dropout=0.0)),
    "pegasus": (pegasus, "PegasusConfig", "PegasusForConditionalGeneration",
                {}),
    "deltalm": (deltalm, "DeltaLMConfig", "DeltaLMForConditionalGeneration",
                {}),
}


def _model(family, device, dtype="float32"):
    pkg, cfg_name, cls_name, over = FAMILIES[family]
    cfg = getattr(pkg, cfg_name).small_test_config(
        vocab_size=VOCAB, d_model=64, dtype=dtype, **over)
    gen = torch.Generator(device=device).manual_seed(0)
    return getattr(pkg, cls_name)(cfg, device=device, generator=gen), cfg


def _text(rng, lo=6, hi=20):
    return "".join(rng.choice(list(CHARS), rng.randint(lo, hi)))


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                            for r in rows))
    return str(path)


def _case(name, tmp_path):
    """``(family, main, argv, kwargs)`` of one example."""
    rng = np.random.RandomState(3)
    qa = [{"question": _text(rng, 3, 6), "context": c, "answer": c[2:5],
           "ans_span": None} for c in (_text(rng, 10, 30)
                                       for _ in range(8))]
    if name == "pretrain_t5":
        return "t5", pretrain_t5.main, [
            "--train_file", _jsonl(tmp_path / "t.json",
                                   [{"text": _text(rng, 10, 60)}
                                    for _ in range(8)]),
            "--max_seq_length", "32"], {}
    if name == "unimc":
        rows = []
        for _ in range(8):
            choice = [_text(rng, 1, 3) for _ in range(3)]
            rows.append({"texta": _text(rng), "textb": "", "question": "问",
                         "choice": choice, "answer": choice[1], "label": 1})
        return "t5", finetune_t5.main, [
            "--train_data_path", _jsonl(tmp_path / "t.json", rows),
            "--max_seq_length", "32", "--max_choices", "4"], {}
    if name == "qa_t5":
        return "t5", finetune_t5_cmrc.main, [
            "--train_file", _jsonl(tmp_path / "t.json", qa),
            "--max_seq_length", "32", "--max_target_length", "8"], {}
    if name == "pretrain_bart":
        tok = _Tok()
        builder = MMapIndexedDatasetBuilder(str(tmp_path / "corpus"))
        for _ in range(8):
            for _ in range(3):
                builder.add_item(tok.encode(_text(rng, 4, 9)) + [4])
            builder.end_document()
        builder.finalize()
        return "bart", pretrain_bart.main, [
            "--data_prefix", str(tmp_path / "corpus"),
            "--max_seq_length", "32"], {"zh_tokenizer": False}
    if name == "pegasus":
        docs = [{"text": "".join(_text(rng, 4, 9) + "。" for _ in range(4))}
                for _ in range(8)]
        return "pegasus", pretrain_pegasus.main, [
            "--train_file", _jsonl(tmp_path / "t.json", docs),
            "--max_seq_length", "32", "--max_target_length", "12"], {}
    if name == "bart_qg":
        return "bart", finetune_bart.main, [
            "--train_file", _jsonl(tmp_path / "t.json", qa),
            "--max_seq_length", "32", "--max_target_length", "10"], {}
    return "deltalm", finetune_deltalm.main, [
        "--train_file", _jsonl(tmp_path / "t.json",
                               [{"src": _text(rng), "tgt": _text(rng)}
                                for _ in range(8)]),
        "--max_enc_length", "16", "--max_dec_length", "12"], {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pretrain_t5", "unimc", "qa_t5",
                                  "pretrain_bart", "pegasus", "bart_qg",
                                  "deltalm"])
def test_example_step_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                  name):
    from fengshen_tpu_torch.models.auto.auto_factory import MODEL_REGISTRY
    family, main, argv, kw = _case(name, tmp_path)
    cpu_model, cfg = _model(family, "cpu")
    model_dir = tmp_path / "model"
    cfg.save_pretrained(str(model_dir))
    conv = __import__(MODEL_REGISTRY[family][0] + ".convert",
                      fromlist=["convert"])
    write_safetensors(str(model_dir / "model.safetensors"),
                      {k: v.contiguous() for k, v in
                       conv.params_to_torch_state(cpu_model.state_dict(),
                                                  cfg).items()})
    flag = "--pretrained_model_path" if name == "unimc" else "--model_path"
    losses = {}
    for dev in ("cpu", "cuda"):
        reset_launch_counts()
        trainer = main(argv + [
            flag, str(model_dir), "--train_batchsize", "4", "--max_steps",
            "2", "--learning_rate", "1e-3", "--log_every_n_steps", "1",
            "--seed", "0", "--default_root_dir", str(tmp_path / dev),
            "--save_ckpt_path", str(tmp_path / f"{dev}_ckpt"),
            "--load_ckpt_path", str(tmp_path / f"{dev}_ckpt"), "--device",
            dev], tokenizer=_Tok(), **kw)
        losses[dev] = [e["loss"] for e in trainer.history if "loss" in e]
        assert not any(e.launches for e in _REGISTRY.values()), dev
    assert len(losses["cuda"]) == 2 and np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_forward_holds_to_fp32(cuda_device, family):
    model, cfg = _model(family, cuda_device)
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(7, VOCAB, (4, 24))).cuda()
    mask = torch.ones_like(ids)
    mask[1, 12:] = 0
    mask[3, 5:] = 0
    dec = torch.from_numpy(rng.randint(7, VOCAB, (4, 10))).cuda()
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg.dtype = dtype
        with torch.no_grad():
            out[dtype] = model(ids, dec, attention_mask=mask).float()
    rel = ((out["bfloat16"] - out["float32"]).norm() /
           out["float32"].norm()).item()
    assert rel < BF16_RTOL, rel
