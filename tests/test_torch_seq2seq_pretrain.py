"""The port's seq2seq pretraining and task examples against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port; weights are carried by ``params_from_jax`` at a tiny size
(``small_test_config``: d_model 32, 2 + 2 layers, 4 heads) in fp32 with
dropout off:

- ``data/megatron_dataloader``: the indexed corpus written by either
  package and read by the other, byte for byte; ``BartDataset`` samples
  and ``whole_word_spans`` bitwise, with ``jieba`` and with
  ``zh_tokenizer=False``; the ``ImportError`` without ``jieba``.
- ``data/t5_dataloader``: ``compute_input_and_target_lengths``,
  ``random_spans_noise_mask`` and successive span-corruption batches
  bitwise over lengths, densities and seeds.
- The collators of ``examples/pegasus`` (GSG), ``finetune_bart_qg``
  (every ``--mask_ans_style``), ``qa_t5``, ``pretrain_t5/finetune_t5``
  (UniMC) and ``translate`` bitwise; ``process_data``'s shards and
  ``convert_ckpt_to_bin``'s output equal; ``trim_vocab`` equal.
- ``models/deltalm``: logits, the cached decoder against the uncached
  one, the HF export read back bitwise and read by the JAX converter.
- Each new module's loss (and ``acc``, ``cond_acc``) and every
  gradient against the JAX module's ``training_loss`` on the same
  weights and batch; each ``main`` fitted 2 steps with ``device="cpu"``,
  its logged losses against the JAX ``main``'s on the same files.

Tolerances: forward and losses within 1e-4 absolute (~1e-6 measured:
reduction order); gradients within 1e-4 relative L2 per tensor (plus
1e-9 absolute, for key biases, whose gradient is zero up to rounding);
data arrays and bytes equal.

Hygiene: torch runs on one intra-op thread (restored after); the port's
Trainer installs a process-wide SIGTERM handler, put back after each
test.
"""

import argparse
import json
import re
import signal
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.data import megatron_dataloader as port_md
from fengshen_tpu_torch.data import t5_dataloader as port_t5d
from fengshen_tpu_torch.data.data_utils import mask_utils as port_mask
from fengshen_tpu_torch.examples.finetune_bart_qg import \
    finetune_bart as port_qg
from fengshen_tpu_torch.examples.pegasus import pretrain_pegasus as port_peg
from fengshen_tpu_torch.examples.pretrain_randeng_bart import \
    pretrain_bart as port_pbart
from fengshen_tpu_torch.examples.pretrain_t5 import \
    convert_ckpt_to_bin as port_ckpt
from fengshen_tpu_torch.examples.pretrain_t5 import finetune_t5 as port_unimc
from fengshen_tpu_torch.examples.pretrain_t5 import \
    process_data as port_process
from fengshen_tpu_torch.examples.pretrain_t5 import pretrain_t5 as port_pt5
from fengshen_tpu_torch.examples.qa_t5 import finetune_t5_cmrc as port_qa
from fengshen_tpu_torch.examples.translate import \
    finetune_deltalm as port_tr
from fengshen_tpu_torch.models import bart as port_bart
from fengshen_tpu_torch.models import deltalm as port_deltalm
from fengshen_tpu_torch.models import pegasus as port_pegasus
from fengshen_tpu_torch.models import t5 as port_t5
from fengshen_tpu_torch.models.bart import convert as bart_convert
from fengshen_tpu_torch.models.deltalm import convert as deltalm_convert
from fengshen_tpu_torch.models.pegasus import convert as pegasus_convert
from fengshen_tpu_torch.models.t5 import convert as t5_convert
from fengshen_tpu_torch.trainer import trainer as port_trainer
from fengshen_tpu_torch.utils.convert_common import (flax_to_state,
                                                     write_safetensors)

ATOL = 1e-4
GRAD_REL = 1e-4


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


# -- a tokenizer both packages take -------------------------------------------

CHARS = "今天天气很好我们去公园散步吧明日会下雨人工智能改变世界"
WORDS = ["abc", "de", "fgh", "ij", "klmn"]
N_SENTINELS = 8


class _Tok:
    """Characters of ``CHARS`` and ``a``-``n``, ``##`` continuation
    pieces of the letters, the specials ``[PAD] [EOS] [UNK] [CLS] [SEP]
    [MASK] <ans>`` and ``N_SENTINELS`` ascending ``<extra_id_i>``; the
    specials and sentinels encode as one token each."""

    pad_token_id, eos_token_id, unk_token_id = 0, 1, 2
    cls_token_id, sep_token_id, mask_token_id = 3, 4, 5
    sep_token, mask_token = "[SEP]", "[MASK]"
    _SPECIAL = re.compile(r"(\[[A-Z]+\]|<ans>|<extra_id_\d+>)")

    def __init__(self, sentinels=True):
        self.tokens = (["[PAD]", "[EOS]", "[UNK]", "[CLS]", "[SEP]",
                        "[MASK]", "<ans>"] + list(CHARS) +
                       list("abcdefghijklmn") +
                       ["##" + c for c in "abcdefghijklmn"] +
                       [f"<extra_id_{i}>" for i in range(N_SENTINELS)])
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        if sentinels:
            self.sentinel_token_ids = [self.vocab[f"<extra_id_{i}>"]
                                       for i in range(N_SENTINELS)]

    def __len__(self):
        return len(self.tokens)

    def get_vocab(self):
        return dict(self.vocab)

    def encode(self, text, add_special_tokens=True, truncation=False,
               max_length=None):
        del add_special_tokens
        ids = []
        for part in self._SPECIAL.split(text):
            if part in self.vocab:
                ids.append(self.vocab[part])
            else:
                ids.extend(self.vocab.get(c, self.unk_token_id)
                           for c in part)
        return ids[:max_length] if truncation and max_length else ids

    def __call__(self, text, max_length=None, padding=None,
                 truncation=False):
        ids = [self.cls_token_id] + self.encode(text) + [self.sep_token_id]
        if truncation:
            ids = ids[:max_length]
        mask = [1] * len(ids)
        if padding == "max_length":
            ids += [self.pad_token_id] * (max_length - len(ids))
            mask += [0] * (max_length - len(mask))
        return {"input_ids": ids, "attention_mask": mask}

    def batch_decode(self, rows, skip_special_tokens=False):
        out = []
        for row in rows:
            out.append("".join(
                self.tokens[int(i)] for i in row
                if not (skip_special_tokens and int(i) < 7)))
        return out


def _text(rng, lo=6, hi=14, letters=False):
    pool = list("abcdefghijklmn") if letters else list(CHARS)
    return "".join(rng.choice(pool, rng.randint(lo, hi)))


def _document(rng, n_sents):
    return "".join(_text(rng, 4, 9) + rng.choice(list("。！？；"))
                   for _ in range(n_sents))


def _write_jsonl(path, rows):
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                            for r in rows))
    return str(path)


# -- the indexed corpus -------------------------------------------------------

def _corpus_docs(seed=0, n_docs=6):
    """Documents of 1-4 sentences, each of letter and ``##`` pieces and
    characters, ``[SEP]``-ended or not."""
    tok = _Tok()
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n_docs):
        doc = []
        for _ in range(rng.randint(1, 5)):
            sent = []
            for _ in range(rng.randint(2, 6)):
                word = WORDS[rng.randint(len(WORDS))]
                sent.append(tok.vocab[word[0]])
                sent.extend(tok.vocab["##" + c] for c in word[1:])
                sent.extend(tok.vocab[c] for c in
                            rng.choice(list(CHARS), rng.randint(0, 3)))
            if rng.rand() < 0.5:
                sent.append(tok.sep_token_id)
            doc.append(sent)
        docs.append(doc)
    return docs


def _build(builder_cls, prefix, docs, dtype=np.int32):
    builder = builder_cls(str(prefix), dtype=dtype)
    for doc in docs:
        for sent in doc:
            builder.add_item(sent)
        builder.end_document()
    builder.finalize()


def test_indexed_corpus_written_and_read_both_ways(tmp_path):
    """Each builder writes the other's ``.bin`` and ``.idx`` bytes (int32
    and uint16), each reader reads the other's files to the same
    sequences, ``doc_idx``, ``get`` slices and ``exists``, and
    ``merge_file_`` appends a second corpus identically."""
    from fengshen_tpu.data.megatron_dataloader import indexed_dataset as jid
    docs = _corpus_docs(0)
    for dtype in (np.int32, np.uint16):
        name = np.dtype(dtype).name
        _build(jid.MMapIndexedDatasetBuilder, tmp_path / f"j_{name}", docs,
               dtype)
        _build(port_md.MMapIndexedDatasetBuilder, tmp_path / f"p_{name}",
               docs, dtype)
        for ext in (".bin", ".idx"):
            assert (tmp_path / f"p_{name}{ext}").read_bytes() == \
                (tmp_path / f"j_{name}{ext}").read_bytes()
    pairs = [(port_md.MMapIndexedDataset(str(tmp_path / "j_int32")),
              jid.MMapIndexedDataset(str(tmp_path / "p_int32")))]
    for got, want in pairs:
        assert len(got) == len(want) == sum(len(d) for d in docs)
        np.testing.assert_array_equal(got.doc_idx, want.doc_idx)
        np.testing.assert_array_equal(got.sizes, want.sizes)
        for i in range(len(got)):
            np.testing.assert_array_equal(got[i], want[i])
            np.testing.assert_array_equal(got.get(i, 1, 2),
                                          want.get(i, 1, 2))
        assert [a.tolist() for a in got[1:4]] == \
            [a.tolist() for a in want[1:4]]
    assert port_md.MMapIndexedDataset.exists(str(tmp_path / "j_int32"))
    assert not port_md.MMapIndexedDataset.exists(str(tmp_path / "none"))
    more = _corpus_docs(1, 3)
    _build(port_md.MMapIndexedDatasetBuilder, tmp_path / "more", more)
    for cls, name in ((port_md.MMapIndexedDatasetBuilder, "pm"),
                      (jid.MMapIndexedDatasetBuilder, "jm")):
        b = cls(str(tmp_path / name))
        for doc in docs[:2]:
            for sent in doc:
                b.add_item(sent)
            b.end_document()
        b.merge_file_(str(tmp_path / "more"))
        b.finalize()
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"pm{ext}").read_bytes() == \
            (tmp_path / f"jm{ext}").read_bytes()


# -- T5 span corruption -------------------------------------------------------

@pytest.mark.parametrize("length,density,span,seed", [
    (2, 0.15, 3.0, 0), (7, 0.15, 3.0, 1), (64, 0.15, 3.0, 2),
    (568, 0.15, 3.0, 3), (100, 0.3, 2.0, 4), (333, 0.5, 5.0, 5)])
def test_noise_mask_and_lengths_are_bitwise(length, density, span, seed):
    """``random_spans_noise_mask`` equal for one seeded generator (and
    the generators left in the same state); ``compute_input_and_target_
    lengths`` equal for inputs of 1..600 at the case's density."""
    from fengshen_tpu.data.t5_dataloader import t5_datasets as jt
    jr, pr = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):
        want = jt.random_spans_noise_mask(length, density, span, jr)
        got = port_t5d.random_spans_noise_mask(length, density, span, pr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert jr.randint(1 << 30) == pr.randint(1 << 30)
    for n in range(1, 601, 7):
        assert port_t5d.compute_input_and_target_lengths(n, density, span) \
            == jt.compute_input_and_target_lengths(n, density, span)
    assert port_t5d.compute_input_and_target_lengths(512, 0.15, 3.0) == \
        (568, 114)


def _sentinels_in_order(batch, sentinels):
    """Every row's label sentinels are its input sentinels, in order."""
    ids = set(sentinels)
    for inp, lab in zip(batch["input_ids"], batch["labels"]):
        a = [int(t) for t in inp if int(t) in ids]
        b = [int(t) for t in lab if int(t) in ids]
        if a != b:
            return False
    return True


@pytest.mark.parametrize("max_len,density,seed,sentinels", [
    (32, 0.15, 42, True), (64, 0.3, 7, True), (48, 0.15, 3, False)])
def test_span_corruption_batches_are_bitwise(max_len, density, seed,
                                             sentinels):
    """Three successive batches (texts short and long, one of a single
    character) equal the JAX collator's, with the tokenizer's ascending
    sentinels or the descending last 100 ids, and (with sentinels apart
    from the text's ids) the labels hold each row's input sentinels in
    order."""
    from fengshen_tpu.data.t5_dataloader import t5_datasets as jt
    tok = _Tok(sentinels)
    kw = dict(max_seq_length=max_len, noise_density=density, seed=seed)
    jc, pc = jt.T5SpanCorruptionCollator(tok, **kw), \
        port_t5d.T5SpanCorruptionCollator(tok, **kw)
    assert (pc.tokens_length, pc.targets_length) == \
        (jc.tokens_length, jc.targets_length)
    rng = np.random.RandomState(seed)
    for _ in range(3):
        rows = [{"text": _text(rng, 1, 90)} for _ in range(4)] + ["好"]
        want, got = jc(rows), pc(rows)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if sentinels:
            assert _sentinels_in_order(got, pc.sentinels)


# -- BART text infilling ------------------------------------------------------

@pytest.mark.parametrize("segmenter", ["jieba", "wordpiece"])
def test_whole_word_spans_and_bart_samples_are_bitwise(tmp_path, segmenter):
    """``whole_word_spans`` and every ``BartDataset`` sample (two seeds,
    two lengths, permutation and masking on and off) equal the JAX
    package's over one corpus, segmented by jieba or grouped by
    ``##`` pieces."""
    from fengshen_tpu.data.data_utils import mask_utils as jmask
    from fengshen_tpu.data.megatron_dataloader import bart_dataset as jb
    from fengshen_tpu.data.megatron_dataloader import indexed_dataset as jid
    if segmenter == "jieba":
        jieba = pytest.importorskip("jieba")
        zh = jieba.lcut
    else:
        zh = False
    tok = _Tok()
    rng = np.random.RandomState(1)
    for _ in range(5):
        pieces = [tok.tokens[i] for i in rng.randint(7, len(tok) -
                                                      N_SENTINELS, 12)]
        assert port_mask.whole_word_spans(pieces, None, zh or None) == \
            jmask.whole_word_spans(pieces, None, zh or None)
        assert [port_mask.is_start_piece(p) for p in pieces] == \
            [jmask.is_start_piece(p) for p in pieces]
    _build(port_md.MMapIndexedDatasetBuilder, tmp_path / "c",
           _corpus_docs(2, 8))
    corpus = port_md.MMapIndexedDataset(str(tmp_path / "c"))
    jcorpus = jid.MMapIndexedDataset(str(tmp_path / "c"))
    for kw in (dict(max_seq_length=64, seed=0),
               dict(max_seq_length=24, seed=5, masked_lm_prob=0.3,
                    random_ratio=0.5),
               dict(max_seq_length=40, permute_sentence_ratio=0.0,
                    masked_lm_prob=0.0)):
        got_ds = port_md.BartDataset(corpus, tok, zh_tokenizer=zh, **kw)
        want_ds = jb.BartDataset(jcorpus, tok, zh_tokenizer=zh, **kw)
        assert len(got_ds) == len(want_ds) == 8
        for i in range(len(got_ds)):
            got, want = got_ds[i], want_ds[i]
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{kw} {i} {k}")


def test_bart_dataset_without_jieba_names_the_opt_out(tmp_path,
                                                      monkeypatch):
    """``zh_tokenizer=None`` without ``jieba`` raises ``ImportError``
    naming ``zh_tokenizer=False`` (the JAX package falls back quietly);
    ``False`` builds."""
    _build(port_md.MMapIndexedDatasetBuilder, tmp_path / "c",
           _corpus_docs(3, 2))
    corpus = port_md.MMapIndexedDataset(str(tmp_path / "c"))
    monkeypatch.setitem(sys.modules, "jieba", None)
    with pytest.raises(ImportError, match="zh_tokenizer=False"):
        port_md.BartDataset(corpus, _Tok())
    assert port_md.BartDataset(corpus, _Tok(), zh_tokenizer=False)[0][
        "labels"].shape == (512,)


# -- task collators -----------------------------------------------------------

def _qa_rows(rng, n):
    out = []
    for _ in range(n):
        context = _text(rng, 10, 30)
        s = rng.randint(0, len(context) - 3)
        answer = context[s:s + 3]
        out.append({"question": _text(rng, 3, 8), "context": context,
                    "answer": [answer] if rng.rand() < 0.5 else answer,
                    "ans_span": [[s, s + 3]] if rng.rand() < 0.5 else None})
    return out


def _unimc_rows(rng, n):
    out = []
    for _ in range(n):
        choice = [_text(rng, 1, 4) for _ in range(rng.randint(2, 5))]
        label = rng.randint(len(choice))
        out.append({"texta": _text(rng, 5, 20),
                    "textb": _text(rng, 2, 6) if rng.rand() < 0.5 else "",
                    "question": _text(rng, 2, 5), "choice": choice,
                    "answer": choice[label], "label": label})
    return out


def _collator_pairs(name):
    """``[(JAX collator, port collator, rows)]`` of one example."""
    rng = np.random.RandomState(len(name))
    tok = _Tok()
    if name == "pegasus_gsg":
        from fengshen_tpu.examples.pegasus import pretrain_pegasus as j
        rows = [{"text": _document(rng, rng.randint(1, 7))}
                for _ in range(5)] + [{"text": "没有标点的一句话"}]
        return [(j.PegasusGSGCollator(tok, max_src_length=48,
                                      max_tgt_length=24, gsg_ratio=r),
                 port_peg.PegasusGSGCollator(tok, max_src_length=48,
                                             max_tgt_length=24, gsg_ratio=r),
                 rows) for r in (0.25, 0.5)]
    if name == "bart_qg":
        from fengshen_tpu.examples.finetune_bart_qg import finetune_bart as j
        rows = _qa_rows(rng, 6)
        return [(j.BartQGCollator(tok, max_src_length=40, max_tgt_length=12,
                                  decoder_start_token_id=4,
                                  mask_ans_style=s),
                 port_qg.BartQGCollator(tok, max_src_length=40,
                                        max_tgt_length=12,
                                        decoder_start_token_id=4,
                                        mask_ans_style=s), rows)
                for s in ("normal", "unmask", "anstoken")]
    if name == "qa_t5":
        from fengshen_tpu.examples.qa_t5 import finetune_t5_cmrc as j
        rows = _qa_rows(rng, 6)
        return [(j.T5QACollator(tok, max_src_length=n, max_tgt_length=8,
                                max_knowledge_length=k),
                 port_qa.T5QACollator(tok, max_src_length=n,
                                      max_tgt_length=8,
                                      max_knowledge_length=k), rows)
                for n, k in ((48, 425), (24, 12))]
    if name == "unimc":
        from fengshen_tpu.examples.pretrain_t5 import finetune_t5 as j
        rows = _unimc_rows(rng, 5)
        return [(j.TaskT5Collator(tok, max_seq_length=32, max_choices=c),
                 port_unimc.TaskT5Collator(tok, max_seq_length=32,
                                           max_choices=c), rows)
                for c in (4, 3)]
    from fengshen_tpu.examples.translate import finetune_deltalm as j
    rows = [{"src": _text(rng), "tgt": _text(rng, letters=True)}
            for _ in range(4)]
    return [(j.TranslationCollator(tok, max_src_length=12,
                                   max_tgt_length=10, reverse_src_tgt=r),
             port_tr.TranslationCollator(tok, max_src_length=12,
                                         max_tgt_length=10,
                                         reverse_src_tgt=r), rows)
            for r in (False, True)]


@pytest.mark.parametrize("name", ["pegasus_gsg", "bart_qg", "qa_t5",
                                  "unimc", "translation"])
def test_task_collators_are_bitwise(name):
    """Each example's collator gives the JAX collator's arrays, over
    each of its styles and cuts."""
    for jc, pc, rows in _collator_pairs(name):
        want, got = jc(rows), pc(rows)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == "pegasus_gsg":
        from fengshen_tpu.examples.pegasus import pretrain_pegasus as j
        rng = np.random.RandomState(9)
        for _ in range(5):
            doc = _document(rng, rng.randint(1, 9))
            sents = port_peg.split_sentences(doc)
            assert sents == j.split_sentences(doc)
            assert port_peg.gap_sentence_ids(sents, 0.3) == \
                j.gap_sentence_ids(sents, 0.3)
            assert port_peg.unigram_f1(doc[:5], doc) == \
                j.unigram_f1(doc[:5], doc)


def test_process_data_writes_the_jax_shards(tmp_path):
    """``process_data.main`` over a jsonl file and over a directory
    (jsonl, text and non-JSON lines) writes the JAX script's shards,
    array for array."""
    from fengshen_tpu.examples.pretrain_t5 import process_data as j
    rng = np.random.RandomState(4)
    src = tmp_path / "src"
    src.mkdir()
    _write_jsonl(src / "a.jsonl", [{"text": _text(rng, 1, 40)}
                                   for _ in range(13)])
    (src / "b.txt").write_text("\n".join(_text(rng) for _ in range(5)) +
                               "\n\n{not json\n")
    tok = _Tok()
    for data in (src / "a.jsonl", src):
        for pkg, out in ((j, "jax"), (port_process, "port")):
            argv = ["--train_data_path", str(data), "--saved_data_shards",
                    "3", "--max_seq_length", "16", "--train_split_size",
                    "0.8", "--saved_train_data_path",
                    str(tmp_path / data.name / out / "train"),
                    "--saved_test_data_path",
                    str(tmp_path / data.name / out / "test")]
            with mock.patch("transformers.AutoTokenizer.from_pretrained",
                            lambda *a, **k: tok):
                pkg.main(argv) if pkg is j else pkg.main(argv,
                                                         tokenizer=tok)
        for split in ("train", "test"):
            want_dir = tmp_path / data.name / "jax" / split
            got_dir = tmp_path / data.name / "port" / split
            names = sorted(p.name for p in want_dir.iterdir())
            assert names == sorted(p.name for p in got_dir.iterdir())
            for n in names:
                want = np.load(want_dir / n, allow_pickle=True)
                got = np.load(got_dir / n, allow_pickle=True)
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_convert_ckpt_to_bin_matches_jax(tmp_path):
    """``strip_prefix`` and ``main`` over DeepSpeed (``module``),
    Lightning (``state_dict``) and bare checkpoints save the JAX
    script's tensors under its names."""
    from fengshen_tpu.examples.pretrain_t5 import convert_ckpt_to_bin as j
    sd = {"model.a.weight": torch.arange(6.0).reshape(2, 3),
          "model.b": torch.ones(2), "other": torch.zeros(1)}
    for prefix in (None, "", "model.", "nope."):
        assert port_ckpt.strip_prefix(sd, prefix).keys() == \
            j.strip_prefix(sd, prefix).keys()
    for i, raw in enumerate(({"module": sd}, {"state_dict": sd}, sd)):
        path = tmp_path / f"c{i}.ckpt"
        torch.save(raw, path)
        for pkg, name in ((j, "j"), (port_ckpt, "p")):
            pkg.main(["--ckpt_path", str(path), "--bin_path",
                      str(tmp_path / f"{name}{i}.bin"), "--rm_prefix",
                      "model."])
        got = torch.load(tmp_path / f"p{i}.bin", weights_only=True)
        want = torch.load(tmp_path / f"j{i}.bin", weights_only=True)
        assert got.keys() == want.keys() == {"a.weight", "b", "other"}
        for k in want:
            assert torch.equal(got[k], want[k])


# -- models -------------------------------------------------------------------

FAMILIES = {
    "t5": ("fengshen_tpu.models.t5", "T5Config",
           "T5ForConditionalGeneration", port_t5, t5_convert,
           dict(dropout_rate=0.0, feed_forward_proj="gated-gelu",
                tie_word_embeddings=False)),
    "bart": ("fengshen_tpu.models.bart", "BartConfig",
             "BartForConditionalGeneration", port_bart, bart_convert,
             dict(dropout=0.0)),
    "pegasus": ("fengshen_tpu.models.pegasus", "PegasusConfig",
                "PegasusForConditionalGeneration", port_pegasus,
                pegasus_convert, {}),
    "deltalm": ("fengshen_tpu.models.deltalm", "DeltaLMConfig",
                "DeltaLMForConditionalGeneration", port_deltalm,
                deltalm_convert, {}),
}
VOCAB = len(_Tok())


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(family, seed=0, noise=0.05, **over):
    """``(JAX model, params, port config, port model)``: the JAX initial
    weights plus ``noise`` x N(0, 1) in both."""
    import importlib

    import jax
    import jax.numpy as jnp
    mod, cfg_name, cls_name, port_pkg, conv, base = FAMILIES[family]
    kw = dict(base, vocab_size=VOCAB, dtype="float32", **over)
    jmod = importlib.import_module(mod)
    jcfg = getattr(jmod, cfg_name).small_test_config(**kw)
    jm = getattr(jmod, cls_name)(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), ids,
                              ids[:, :2])["params"])
    rng = np.random.RandomState(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: (x + noise * rng.randn(*x.shape)).astype(x.dtype), params)
    pcfg = getattr(port_pkg, cfg_name).small_test_config(**kw)
    model = getattr(port_pkg, cls_name)(pcfg, device="cpu", init=False)
    model.load_state_dict(conv.params_from_jax(params, pcfg))
    return jm, params, pcfg, model


def _inputs(seed=0, batch=3, src=9, tgt=6):
    rng = np.random.RandomState(seed)
    ids = rng.randint(7, VOCAB, (batch, src)).astype(np.int32)
    mask = np.ones((batch, src), np.int32)
    mask[1, 6:] = 0
    dec = rng.randint(7, VOCAB, (batch, tgt)).astype(np.int32)
    return ids, mask, dec


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_deltalm_logits_match_jax():
    """``encode``, ``decode_logits`` and the full forward of the
    interleaved model with a padding mask, within 1e-4; the default
    config holds Randeng-Deltalm-362M's 362,510,592 parameters."""
    jm, params, _, model = _pair("deltalm")
    ids, mask, dec = _inputs()
    import jax

    def run(v):
        enc = jm.apply(v, ids, mask, method=jm.encode)
        return {"encode": enc,
                "decode_logits": jm.apply(v, dec, enc, mask,
                                          method=jm.decode_logits),
                "logits": jm.apply(v, ids, dec, attention_mask=mask)}
    want = jax.jit(run)({"params": params})
    with torch.no_grad():
        p_enc = model.encode(_t(ids), _t(mask))
        got = {"encode": p_enc,
               "decode_logits": model.decode_logits(_t(dec), p_enc,
                                                    _t(mask)),
               "logits": model(_t(ids), _t(dec), attention_mask=_t(mask))}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
    full = port_deltalm.DeltaLMForConditionalGeneration(
        port_deltalm.DeltaLMConfig(), device="meta")
    assert sum(p.numel() for p in full.parameters()) == 362_510_592


def test_deltalm_cached_decode_matches_the_uncached_decoder():
    """The decoder stepped token by token over its cache gives the
    uncached logits at every position (1e-5), and ``seq2seq_generate``
    greedy over the cache and over the buffer picks the same tokens,
    each the uncached forward's argmax."""
    from fengshen_tpu_torch.utils import generate as G
    _, _, cfg, model = _pair("deltalm", seed=1)
    ids, mask, dec = _inputs(seed=1)
    with torch.no_grad():
        enc = model.encode(_t(ids), _t(mask))
        want = model.decode_logits(_t(dec), enc, _t(mask))
        cache = model.new_cache(ids.shape[0], dec.shape[1])
        steps = [model.decode_logits(_t(dec[:, t:t + 1]), enc, _t(mask),
                                     cache=cache, cross_from_cache=t > 0,
                                     position_offset=t)[:, -1]
                 for t in range(dec.shape[1])]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               want.numpy(), rtol=0, atol=1e-5)
    common = dict(max_new_tokens=7, decoder_start_token_id=0,
                  eos_token_id=cfg.eos_token_id, pad_token_id=1,
                  device="cpu")
    cached = G.seq2seq_generate(model, _t(ids), _t(mask), **common)
    with mock.patch.object(G, "_cache_capacity", lambda m: 0):
        buffered = G.seq2seq_generate(model, _t(ids), _t(mask), **common)
    assert torch.equal(cached, buffered)
    with torch.no_grad():
        logits = model(_t(ids), cached[:, :-1], attention_mask=_t(mask))
    for b in range(ids.shape[0]):
        for t in range(1, cached.shape[1]):
            if int(cached[b, t - 1]) == cfg.eos_token_id or (
                    t > 1 and int(cached[b, t - 1]) == 1):
                break
            assert int(cached[b, t]) == int(logits[b, t - 1].argmax())
    beam = G.seq2seq_generate(model, _t(ids), _t(mask), num_beams=2,
                              **common)
    assert beam.shape == cached.shape


def test_deltalm_hf_export_reimports_bitwise(tmp_path):
    """The port's HF-named export, written as safetensors and read back
    by ``load_hf_pretrained``, gives bitwise logits; the JAX package's
    ``torch_to_params`` reads it (with and without the ``model.``
    prefix) to the JAX tree; ``models/auto`` resolves ``deltalm``."""
    import jax

    from fengshen_tpu.models.deltalm import convert as jconv
    from fengshen_tpu_torch.models.auto import AutoConfig, AutoModel
    jm, params, cfg, model = _pair("deltalm", seed=6)
    state = deltalm_convert.params_to_torch_state(model.state_dict(), cfg)
    d = tmp_path / "deltalm"
    cfg.save_pretrained(str(d))
    write_safetensors(str(d / "model.safetensors"),
                      {k: v.contiguous() for k, v in state.items()})
    _, loaded = deltalm_convert.load_hf_pretrained(str(d), device="cpu")
    ids, mask, dec = _inputs(seed=7)
    with torch.no_grad():
        want = model(_t(ids), _t(dec), attention_mask=_t(mask))
        got = loaded(_t(ids), _t(dec), attention_mask=_t(mask))
    assert torch.equal(got, want)
    np_state = {k: v.numpy() for k, v in state.items()}
    bare = {k[len("model."):]: v for k, v in np_state.items()
            if k.startswith("model.")}
    for sd in (np_state, bare):
        back = jconv.torch_to_params(sd, jm.config)
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               _np_tree(back), params)
        assert deltalm_convert.torch_to_params(
            {k: torch.as_tensor(v) for k, v in sd.items()}, cfg).keys() == \
            model.state_dict().keys()
    auto_cfg = AutoConfig.from_pretrained(str(d))
    assert auto_cfg == cfg
    built = AutoModel.from_config(auto_cfg, head="conditional_generation",
                                  device="cpu", init=False)
    assert isinstance(built, port_deltalm.DeltaLMForConditionalGeneration)


def test_trim_vocab_equals_jax():
    """``trim_vocab`` of the port's T5 state (tied and untied head)
    equals the JAX ``trim_vocab`` of the same tree, carried over."""
    from fengshen_tpu.examples.pretrain_t5 import pretrain_t5 as j
    keep = [5, 0, 3, 17, 9, 9, 40]
    for family_over in (dict(tie_word_embeddings=True),
                        dict(tie_word_embeddings=False)):
        _, params, cfg, model = _pair("t5", seed=2, **family_over)
        want = flax_to_state(_np_tree(j.trim_vocab(params, keep)))
        got = port_pt5.trim_vocab(model.state_dict(), keep)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert got["model.shared.weight"].shape[0] == len(keep)


# -- modules: loss and gradients ----------------------------------------------

def _module_case(name, tok):
    """``(JAX module, params, port module, batch)`` of one example's
    module on a collated batch."""
    rng = np.random.RandomState(11)
    if name == "pretrain_t5":
        from fengshen_tpu.examples.pretrain_t5 import pretrain_t5 as j
        jm, params, cfg, model = _pair("t5", seed=3)
        args = port_pt5.parse_args(["--max_seq_length", "24"])
        batch = port_t5d.T5SpanCorruptionCollator(tok, max_seq_length=24)(
            [{"text": _text(rng, 5, 40)} for _ in range(3)])
        return (j.T5PretrainModule(args, model=jm, config=jm.config),
                params, port_pt5.T5PretrainModule(args, model, cfg), batch)
    if name == "unimc":
        from fengshen_tpu.examples.pretrain_t5 import finetune_t5 as j
        jm, params, cfg, model = _pair("t5", seed=4)
        args = argparse.Namespace(max_seq_length=24)
        batch = port_unimc.TaskT5Collator(tok, max_seq_length=24,
                                          max_choices=4)(_unimc_rows(rng, 3))
        return (j.MT5FinetuneModule(args, model=jm, config=jm.config),
                params, port_unimc.MT5FinetuneModule(args, model, cfg),
                batch)
    if name == "qa_t5":
        from fengshen_tpu.examples.qa_t5 import finetune_t5_cmrc as j
        jm, params, cfg, model = _pair("t5", seed=5)
        args = argparse.Namespace(max_seq_length=24, max_target_length=8)
        batch = port_qa.T5QACollator(tok, max_src_length=24,
                                     max_tgt_length=8)(_qa_rows(rng, 3))
        return (j.T5QAModule(args, config=jm.config), params,
                port_qa.T5QAModule(args, model, cfg), batch)
    if name == "pretrain_bart":
        from fengshen_tpu.examples.pretrain_randeng_bart import \
            pretrain_bart as j
        jm, params, cfg, model = _pair("bart", seed=6)
        args = argparse.Namespace(max_seq_length=20)
        src = rng.randint(7, VOCAB, (3, 20)).astype(np.int32)
        src[1, 14:] = 0
        labels = rng.randint(7, VOCAB, (3, 20)).astype(np.int32)
        labels[:, 16:] = -100
        batch = {"input_ids": src, "attention_mask": (src != 0).astype(
            np.int32), "labels": labels}
        return (j.BartPretrainModule(args, config=jm.config), params,
                port_pbart.BartPretrainModule(args, model, cfg), batch)
    if name == "pegasus":
        from fengshen_tpu.examples.pegasus import pretrain_pegasus as j
        jm, params, cfg, model = _pair("pegasus", seed=7)
        args = argparse.Namespace(max_seq_length=32, max_target_length=12)
        batch = port_peg.PegasusGSGCollator(tok, max_src_length=32,
                                            max_tgt_length=12)(
            [{"text": _document(rng, 4)} for _ in range(3)])
        return (j.PegasusPretrainModule(args, config=jm.config), params,
                port_peg.PegasusPretrainModule(args, model, cfg), batch)
    if name == "bart_qg":
        from fengshen_tpu.examples.finetune_bart_qg import finetune_bart as j
        jm, params, cfg, model = _pair("bart", seed=8)
        args = argparse.Namespace(max_seq_length=32, max_target_length=10)
        batch = port_qg.BartQGCollator(tok, max_src_length=32,
                                       max_tgt_length=10)(_qa_rows(rng, 3))
        return (j.BartQGModule(args, config=jm.config), params,
                port_qg.BartQGModule(args, model, cfg), batch)
    from fengshen_tpu.examples.translate import finetune_deltalm as j
    jm, params, cfg, model = _pair("deltalm", seed=9)
    args = argparse.Namespace(max_enc_length=12, max_dec_length=10,
                              label_smooth=0.1)
    batch = port_tr.TranslationCollator(tok, max_src_length=12,
                                        max_tgt_length=10)(
        [{"src": _text(rng), "tgt": _text(rng, letters=True)}
         for _ in range(3)])
    return (j.DeltaLMTranslationModule(args, config=jm.config), params,
            port_tr.DeltaLMTranslationModule(args, model, cfg), batch)


@pytest.mark.parametrize("name", ["pretrain_t5", "unimc", "qa_t5",
                                  "pretrain_bart", "pegasus", "bart_qg",
                                  "deltalm"])
def test_module_loss_and_grads_match_jax(name):
    """Each module's ``training_loss`` (and its metrics: ``acc``,
    ``n_tokens``) against the JAX module's on the same weights and
    batch within 1e-4, every parameter's gradient against ``jax.grad``
    within 1e-4 relative L2; the UniMC module's validation ``cond_acc``
    equal."""
    import jax
    import jax.numpy as jnp
    jmod, params, pmod, batch = _module_case(name, _Tok())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wm), grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.training_loss(p, jbatch, jax.random.PRNGKey(0)),
        has_aux=True))(params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss, metrics = pmod.training_loss(tbatch)
    loss.backward()
    assert abs(loss.item() - float(want)) < ATOL
    assert metrics.keys() == wm.keys()
    for k in wm:
        assert abs(float(metrics[k]) - float(wm[k])) < ATOL, k
    want_g = flax_to_state(_np_tree(grads))
    got_g = {n: p.grad for n, p in pmod.model.named_parameters()}
    assert want_g.keys() == got_g.keys()
    for n, g in got_g.items():
        w = want_g[n].numpy()
        assert np.linalg.norm(g.numpy() - w) <= \
            GRAD_REL * np.linalg.norm(w) + 1e-9, n
    if name == "unimc":
        wl, wv = jax.jit(lambda p: jmod.validation_loss(p, jbatch, None))(
            params)
        gl, gv = pmod.validation_loss(tbatch)
        assert abs(float(gl) - float(wl)) < ATOL
        assert float(gv["cond_acc"]) == float(wv["cond_acc"])
    assert pmod.flops_per_token() > 0


# -- mains --------------------------------------------------------------------

def _checkpoint_dir(path, family, model, cfg):
    cfg.save_pretrained(str(path))
    conv = FAMILIES[family][4]
    write_safetensors(str(path / "model.safetensors"),
                      {k: v.contiguous() for k, v in
                       conv.params_to_torch_state(model.state_dict(),
                                                  cfg).items()})
    return str(path)


def _trainer_flags(root):
    return ["--train_batchsize", "4", "--max_steps", "2",
            "--learning_rate", "1e-3", "--warmup_steps", "1",
            "--log_every_n_steps", "1", "--seed", "0",
            "--default_root_dir", str(root / "runs"),
            "--save_ckpt_path", str(root / "ckpt"),
            "--load_ckpt_path", str(root / "ckpt")]


def _main_case(name, tmp_path):
    """``(family, JAX module path, JAX module class, port main, argv
    without the trainer flags, port main kwargs)``."""
    rng = np.random.RandomState(21)
    if name == "pretrain_t5":
        f = _write_jsonl(tmp_path / "t.json", [{"text": _text(rng, 5, 40)}
                                               for _ in range(8)])
        return ("t5", "fengshen_tpu.examples.pretrain_t5.pretrain_t5",
                "T5PretrainModule", port_pt5.main,
                ["--train_file", f, "--max_seq_length", "24"], {})
    if name == "unimc":
        f = _write_jsonl(tmp_path / "t.json", _unimc_rows(rng, 8))
        return ("t5", "fengshen_tpu.examples.pretrain_t5.finetune_t5",
                "MT5FinetuneModule", port_unimc.main,
                ["--train_data_path", f, "--max_seq_length", "24",
                 "--max_choices", "4"], {})
    if name == "qa_t5":
        f = _write_jsonl(tmp_path / "t.json", _qa_rows(rng, 8))
        return ("t5", "fengshen_tpu.examples.qa_t5.finetune_t5_cmrc",
                "T5QAModule", port_qa.main,
                ["--train_file", f, "--max_seq_length", "24",
                 "--max_target_length", "8"], {})
    if name == "pretrain_bart":
        _build(port_md.MMapIndexedDatasetBuilder, tmp_path / "corpus",
               _corpus_docs(4, 8))
        return ("bart",
                "fengshen_tpu.examples.pretrain_randeng_bart.pretrain_bart",
                "BartPretrainModule", port_pbart.main,
                ["--data_prefix", str(tmp_path / "corpus"),
                 "--max_seq_length", "24"], {"zh_tokenizer": None})
    if name == "pegasus":
        f = _write_jsonl(tmp_path / "t.json",
                         [{"text": _document(rng, 4)} for _ in range(8)])
        return ("pegasus", "fengshen_tpu.examples.pegasus.pretrain_pegasus",
                "PegasusPretrainModule", port_peg.main,
                ["--train_file", f, "--max_seq_length", "32",
                 "--max_target_length", "12", "--gsg_ratio", "0.25"], {})
    if name == "bart_qg":
        f = _write_jsonl(tmp_path / "t.json", _qa_rows(rng, 8))
        return ("bart", "fengshen_tpu.examples.finetune_bart_qg.finetune_bart",
                "BartQGModule", port_qg.main,
                ["--train_file", f, "--max_seq_length", "32",
                 "--max_target_length", "10", "--mask_ans_style",
                 "anstoken"], {})
    f = _write_jsonl(tmp_path / "t.json",
                     [{"src": _text(rng), "tgt": _text(rng, letters=True)}
                      for _ in range(8)])
    return ("deltalm", "fengshen_tpu.examples.translate.finetune_deltalm",
            "DeltaLMTranslationModule", port_tr.main,
            ["--train_file", f, "--max_enc_length", "12",
             "--max_dec_length", "10", "--label_smooth", "0.1"], {})


@pytest.mark.parametrize("name", ["pretrain_t5", "unimc", "qa_t5",
                                  "pretrain_bart", "pegasus", "bart_qg",
                                  "deltalm"])
def test_main_fits_as_the_jax_main(tmp_path, name):
    """Each example's ``main`` fits 2 steps on the CPU from an HF-named
    checkpoint; its logged losses equal the JAX ``main``'s (its module
    given the same weights, its tokenizer the test's) within 1e-4; the
    entry point needs the card unless asked for the CPU."""
    import importlib

    import jax
    family, jmod_name, jcls, port_main, argv, kw = _main_case(name,
                                                              tmp_path)
    _, params, cfg, model = _pair(family, seed=12)
    model_dir = _checkpoint_dir(tmp_path / "model", family, model, cfg)
    path_flag = "--pretrained_model_path" if name == "unimc" \
        else "--model_path"
    tok = _Tok()
    trainer = port_main(argv + [path_flag, model_dir, "--device", "cpu"] +
                        _trainer_flags(tmp_path / "port"),
                        tokenizer=tok, **kw)
    got = [e["loss"] for e in trainer.history if "loss" in e]
    assert len(got) == 2 and np.isfinite(got).all()

    jmod = importlib.import_module(jmod_name)
    with mock.patch("transformers.AutoTokenizer.from_pretrained",
                    lambda *a, **k: tok), \
            mock.patch.object(getattr(jmod, jcls), "init_params",
                              lambda self, rng: jax.tree_util.tree_map(
                                  np.array, params)):
        jmod.main(argv + [path_flag, model_dir] +
                  _trainer_flags(tmp_path / "jax"))
    want = [json.loads(line)["loss"] for line in
            (tmp_path / "jax" / "runs" / "metrics.jsonl").read_text()
            .splitlines() if '"loss"' in line]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_main(argv + [path_flag, model_dir], tokenizer=tok, **kw)


def test_pretrain_t5_eval_only_validates_without_a_step(tmp_path):
    """``--do_eval_only`` restores the fit's checkpoint and runs one
    validation sweep (``val_loss`` and ``val_acc``), no step; the
    ``--keep_tokens_path`` fit starts from the checkpoint's rows at
    ``keep`` and builds the model at the kept size."""
    rng = np.random.RandomState(5)
    _, _, cfg, model = _pair("t5", seed=13)
    model_dir = tmp_path / "model"
    _checkpoint_dir(model_dir, "t5", model, cfg)
    files = ["--train_file", _write_jsonl(tmp_path / "t.json",
                                          [{"text": _text(rng, 5, 40)}
                                           for _ in range(8)]),
             "--val_file", _write_jsonl(tmp_path / "v.json",
                                        [{"text": _text(rng, 5, 40)}
                                         for _ in range(8)]),
             "--val_batchsize", "4", "--max_seq_length", "24",
             "--model_path", str(model_dir), "--device", "cpu"]
    root = tmp_path / "run"
    fit = port_pt5.main(files + _trainer_flags(root), tokenizer=_Tok())
    assert fit.global_step == 2
    trained = {k: v.clone() for k, v in fit.state.model.state_dict().items()}
    ev = port_pt5.main(files + _trainer_flags(root) + ["--do_eval_only"],
                       tokenizer=_Tok())
    assert ev.global_step == 2
    assert not any("loss" in e and "val_loss" not in e for e in ev.history)
    vals = [e for e in ev.history if "val_loss" in e]
    assert len(vals) == 1 and np.isfinite(vals[0]["val_loss"])
    assert 0.0 <= vals[0]["val_acc"] <= 1.0
    for k, v in ev.state.model.state_dict().items():
        assert torch.equal(v, trained[k]), k

    keep = list(range(0, VOCAB, 2))
    (tmp_path / "keep.json").write_text(json.dumps(keep))
    torch.save(t5_convert.params_to_torch_state(model.state_dict(), cfg),
               model_dir / "pytorch_model.bin")
    module = port_pt5.T5PretrainModule(
        port_pt5.parse_args(["--model_path", str(model_dir),
                             "--keep_tokens_path",
                             str(tmp_path / "keep.json")]),
        port_t5.T5ForConditionalGeneration(
            port_t5.T5Config.small_test_config(
                vocab_size=len(keep), dtype="float32", dropout_rate=0.0,
                feed_forward_proj="gated-gelu", tie_word_embeddings=False),
            device="cpu", init=False), cfg)
    trimmed = module.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(trimmed.model.shared.weight,
                       model.model.shared.weight[keep])
    assert torch.equal(trimmed.lm_head.weight, model.lm_head.weight[keep])


def test_qa_predict_only_writes_one_line_a_row(tmp_path):
    """``finetune_t5_cmrc.main --do_eval_only`` restores the fit's step
    and writes one decoded line per test row (beam 2, 6 new tokens),
    equal to ``seq2seq_generate`` on the restored weights."""
    from fengshen_tpu_torch.utils.generate import seq2seq_generate
    rng = np.random.RandomState(8)
    _, _, cfg, model = _pair("t5", seed=14)
    model_dir = _checkpoint_dir(tmp_path / "model", "t5", model, cfg)
    tok = _Tok()
    base = ["--train_file", _write_jsonl(tmp_path / "t.json",
                                         _qa_rows(rng, 8)),
            "--test_file", _write_jsonl(tmp_path / "test.json",
                                        _qa_rows(rng, 4)),
            "--test_batchsize", "4", "--max_seq_length", "24",
            "--max_target_length", "6", "--num_beams", "2",
            "--model_path", model_dir, "--device", "cpu"] + \
        _trainer_flags(tmp_path)
    port_qa.main(base, tokenizer=tok)
    out = tmp_path / "pred.txt"
    ev = port_qa.main(base + ["--do_eval_only", "--prediction_res_path",
                              str(out)], tokenizer=tok)
    lines = out.read_text().splitlines()
    assert len(lines) == 4 and ev.global_step == 2
    batch = port_qa.T5QACollator(tok, max_src_length=24, max_tgt_length=6)(
        json.loads(r) for r in (tmp_path / "test.json").read_text()
        .splitlines())
    want = seq2seq_generate(ev.state.model, _t(batch["input_ids"]),
                            _t(batch["attention_mask"]), max_new_tokens=6,
                            eos_token_id=cfg.eos_token_id, num_beams=2,
                            device="cpu")
    assert lines == tok.batch_decode(want.numpy(), skip_special_tokens=True)
