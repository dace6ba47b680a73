"""The MLM pretraining slice on the card (``gpu``-marked; skipped without
one). This file imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_mlm_pretrain_gpu.py

- Each example's ``main`` (``pretrain_erlangshen`` on MegatronBert,
  ``pretrain_deberta`` on DeBERTa-v2, ``pretrain_bert`` on BERT) fits 2
  steps at 2 layers in fp32 on the card and on the CPU from one
  HF-named checkpoint (word segmenter ``False``: the card's machine has
  no ``jieba``): the logged losses finite and within 1e-4 of each
  other, and no kernel of the port launches (the families' attention is
  dense, as in the reference).
- An Erlangshen MLM + SOP step and a DeBERTa MLM step at 2 layers of
  their published widths: the bf16 forward within 5e-2 relative L2 of
  fp32 compute on the same weights and a padded batch, and the bf16
  gradients finite.
- The index helpers built on the card's host with its C++ compiler:
  ``build_sample_idx`` and ``build_blending_indices`` equal their plain
  versions, and ``build_mapping``'s windows lie inside their documents.

Limits: fp32 reduction order on the two devices (~1e-6 measured on the
CPU side); bf16 rounding against fp32 (the smoke's bar).
"""

import json

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.data.megatron_dataloader import helpers
from fengshen_tpu_torch.examples.pretrain_bert import pretrain_bert
from fengshen_tpu_torch.examples.pretrain_erlangshen_bert import \
    pretrain_erlangshen
from fengshen_tpu_torch.examples.pretrain_erlangshen_deberta_v2 import \
    pretrain_deberta
from fengshen_tpu_torch.models import bert, deberta_v2, megatron_bert
from fengshen_tpu_torch.ops.kernels import _REGISTRY, reset_launch_counts
from fengshen_tpu_torch.utils.convert_common import write_safetensors

ATOL = 1e-4
BF16_RTOL = 5e-2
CHARS = "今天气很好我们去公园散步吧明日会下雨人工智能改变世界"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class _Tok:
    """Specials ``[PAD] [UNK] [CLS] [SEP] [MASK]``, then ``CHARS`` and
    the sentence ends, one token a character."""

    pad_token_id, unk_token_id, cls_token_id = 0, 1, 2
    sep_token_id, mask_token_id = 3, 4

    def __init__(self):
        self.tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
            list(CHARS + "。！？")
        self.vocab = {t: i for i, t in enumerate(self.tokens)}

    def __len__(self):
        return len(self.tokens)

    def get_vocab(self):
        return dict(self.vocab)

    def encode(self, text, add_special_tokens=True):
        del add_special_tokens
        return [self.vocab.get(c, self.unk_token_id) for c in text]


def _text(rng):
    return "".join("".join(rng.choice(list(CHARS), rng.randint(3, 12))) +
                   rng.choice(list("。！？")) for _ in range(rng.randint(2, 6)))


#: name -> (family, config class, model class, main, keyword naming the
#: segmenter)
EXAMPLES = {
    "erlangshen": (megatron_bert, "MegatronBertConfig",
                   "MegatronBertForPreTraining", pretrain_erlangshen.main,
                   "zh_tokenizer"),
    "deberta": (deberta_v2, "DebertaV2Config", "DebertaV2ForMaskedLM",
                pretrain_deberta.main, "zh_tokenizer"),
    "bert": (bert, "BertConfig", "BertForMaskedLM", pretrain_bert.main,
             "word_cuter"),
}


def _checkpoint(path, name, vocab):
    family, cfg_name, cls_name = EXAMPLES[name][:3]
    cfg = getattr(family, cfg_name).small_test_config(
        vocab_size=vocab, dtype="float32", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, max_position_embeddings=64)
    model = getattr(family, cls_name)(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    cfg.save_pretrained(str(path))
    convert = __import__(family.__name__ + ".convert", fromlist=["x"])
    write_safetensors(str(path / "model.safetensors"), {
        k: v.contiguous() for k, v in
        convert.params_to_torch_state(model.state_dict(), cfg).items()})
    return str(path)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_step_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                  name):
    tok = _Tok()
    model_dir = _checkpoint(tmp_path / "model", name, len(tok))
    rng = np.random.RandomState(1)
    train = tmp_path / "t.json"
    train.write_text("".join(json.dumps({"text": _text(rng)},
                                        ensure_ascii=False) + "\n"
                             for _ in range(8)))
    main, option = EXAMPLES[name][3], EXAMPLES[name][4]
    losses = {}
    for device in ("cpu", "cuda"):
        reset_launch_counts()
        trainer = main([
            "--model_path", model_dir, "--train_file", str(train),
            "--max_seq_length", "40", "--train_batchsize", "4",
            "--max_steps", "2", "--learning_rate", "1e-3",
            "--warmup_steps", "1", "--log_every_n_steps", "1", "--seed",
            "0", "--device", device, "--default_root_dir",
            str(tmp_path / device / "runs"), "--save_ckpt_path",
            str(tmp_path / device / "ckpt"), "--load_ckpt_path",
            str(tmp_path / device / "ckpt")], tokenizer=tok,
            **{option: False})
        losses[device] = [e["loss"] for e in trainer.history if "loss" in e]
        assert not any(e.launches for e in _REGISTRY.values())
    assert len(losses["cuda"]) == 2 and np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=ATOL)


def _bf16_rel(model, batch):
    def logits(dtype):
        before, model.config.dtype = model.config.dtype, dtype
        try:
            out = model(batch["input_ids"],
                        attention_mask=batch["attention_mask"],
                        token_type_ids=batch.get("token_type_ids"))
            return (out[0] if isinstance(out, tuple) else out).float()
        finally:
            model.config.dtype = before

    with torch.no_grad():
        want = logits("float32")
        got = logits("bfloat16")
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["erlangshen", "deberta"])
def test_bf16_step_at_published_width(cuda_device, name):
    """2 layers at the published width (MegatronBert 2048 / 32 heads,
    DeBERTa-v2 1536 / 24 heads with 256 buckets), 2 x 512 with the
    second row half padding: bf16 logits within BF16_RTOL of fp32, and a
    bf16 MLM step's loss and gradients finite."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1] / "configs"
    family, cfg_name, cls_name = EXAMPLES[name][:3]
    path = root / ("erlangshen_megatron_bert_1.3b.json" if name ==
                   "erlangshen" else "erlangshen_deberta_v2_710m.json")
    raw = json.loads(path.read_text())
    raw.update(num_hidden_layers=2, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    known = getattr(family, cfg_name).__dataclass_fields__
    cfg = getattr(family, cfg_name)(**{k: v for k, v in raw.items()
                                       if k in known})
    model = getattr(family, cls_name)(
        cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(4))
    gen = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(5, cfg.vocab_size, (2, 512), device="cuda",
                        generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 256:] = 0
    labels = torch.where(torch.rand(ids.shape, device="cuda",
                                    generator=gen) < 0.15, ids, -100)
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels}
    if name == "erlangshen":
        batch["token_type_ids"] = torch.zeros_like(ids)
        batch["next_sentence_label"] = torch.tensor([0, 1], device="cuda")
    rel = _bf16_rel(model, batch)
    assert rel < BF16_RTOL, rel
    module = (pretrain_erlangshen.ErLangShenBert if name == "erlangshen"
              else pretrain_deberta.DebertaPretrainModule)(None, model, cfg)
    loss, metrics = module.training_loss(batch)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
    assert 0 <= float(metrics["mlm_acc"]) <= 1


@pytest.mark.gpu
def test_index_helpers_build_on_the_cards_host(cuda_device):
    """The library compiles on the card's host; its builders agree with
    the plain versions and keep ``build_mapping``'s windows inside their
    documents."""
    rng = np.random.RandomState(2)
    counts = rng.randint(1, 12, 5000)
    docs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sizes = rng.randint(1, 60, int(docs[-1])).astype(np.int32)
    order = rng.permutation(len(sizes)).astype(np.int32)
    args = (sizes, order, 512, 1, int(sizes.sum()))
    np.testing.assert_array_equal(helpers.build_sample_idx(*args),
                                  helpers.build_sample_idx_plain(*args))
    for got, want in zip(helpers.build_blending_indices([0.7, 0.3], 20000),
                         helpers.build_blending_indices_plain([0.7, 0.3],
                                                              20000)):
        np.testing.assert_array_equal(got, want)
    maps = helpers.build_mapping(docs, sizes, 509, 0.1, 7)
    doc_of = np.searchsorted(docs, maps[:, 0], side="right") - 1
    assert (maps[:, 1] <= docs[doc_of + 1]).all()
    assert (maps[:, 1] - maps[:, 0] >= 2).all()
    assert (maps[:, 2] <= 509).all()
