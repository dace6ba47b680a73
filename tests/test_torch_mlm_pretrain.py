"""The port's MLM pretraining slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port; weights are carried by ``params_from_jax`` at a tiny size
(``small_test_config``: hidden 32, 2 layers, 4 heads) in fp32 with
dropout off:

- ``data/data_utils``: sentence split, sentence-order pairing,
  truncation, token types and ``create_masked_lm_predictions`` (BERT and
  T5 styles, whole-word or not, with jieba, the wordpiece grouping or a
  given segmenter), outputs and the ``RandomState`` after them bitwise.
- ``data/megatron_dataloader/helpers``: the port's build of
  ``csrc/index_helpers.cpp`` against the plain versions and against the
  JAX package's build of its own copy, bitwise; a failed compile raises;
  the ``.cpp`` stays out of the CUDA library.
- ``BertDataset``, ``GPTDataset`` (its ``.npy`` cache written by either
  package and read by the other) and ``BlendableDataset`` over a corpus
  the port's builder writes, bitwise.
- The three collators bitwise, given the same segmenter; without
  ``jieba`` each raises ``ImportError`` naming its ``False`` option.
- ``models/deberta_v2``: the log-bucket table bitwise (512 positions,
  256 buckets among them), the encoder, MLM and task heads with and
  without the conv branch and ``share_att_key``, MLM gradients, the HF
  export read by the JAX converter, ``deberta-v2`` in ``models/auto``.
- Each pretraining module's loss, metrics and every gradient against
  the JAX module's on the same weights and batch; each ``main`` fitted
  2 steps with ``device="cpu"``, its logged losses against the JAX
  ``main``'s on the same files.

Tolerances: forward and losses within 1e-4 absolute (~1e-6 measured:
reduction order); gradients within 1e-4 relative L2 per tensor (plus
1e-7 of the largest tensor's gradient norm, for a bias whose gradient is
zero up to rounding); data arrays, indices and bytes equal.

Hygiene: torch runs on one intra-op thread (restored after); the port's
Trainer installs a process-wide SIGTERM handler, put back after each
test.
"""

import argparse
import json
import signal
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.data import data_utils as port_du
from fengshen_tpu_torch.data import megatron_dataloader as port_md
from fengshen_tpu_torch.data.megatron_dataloader import helpers as port_h
from fengshen_tpu_torch.examples.pretrain_bert import pretrain_bert as port_pb
from fengshen_tpu_torch.examples.pretrain_erlangshen_bert import \
    pretrain_erlangshen as port_pe
from fengshen_tpu_torch.examples.pretrain_erlangshen_deberta_v2 import \
    pretrain_deberta as port_pd
from fengshen_tpu_torch.models import bert as port_bert
from fengshen_tpu_torch.models import deberta_v2 as port_deb
from fengshen_tpu_torch.models import megatron_bert as port_mb
from fengshen_tpu_torch.models.bert import convert as bert_convert
from fengshen_tpu_torch.models.deberta_v2 import convert as deb_convert
from fengshen_tpu_torch.models.megatron_bert import convert as mb_convert
from fengshen_tpu_torch.trainer import trainer as port_trainer
from fengshen_tpu_torch.utils.convert_common import write_safetensors

ATOL = 1e-4
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-7


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

CHARS = "今天气很好我们去公园散步吧明日会下雨人工智能改变世界"
LETTERS = "abcdefgh"
PUNCT = "。！？，"


class _Tok:
    """Characters of ``CHARS`` and ``PUNCT`` one token each; a run of
    ``LETTERS`` a wordpiece word (its first letter, then ``##`` pieces);
    the specials ``[PAD] [UNK] [CLS] [SEP] [MASK]``."""

    pad_token_id, unk_token_id, cls_token_id = 0, 1, 2
    sep_token_id, mask_token_id = 3, 4

    def __init__(self):
        self.tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] +
                       list(CHARS + PUNCT + LETTERS) +
                       ["##" + c for c in LETTERS])
        self.vocab = {t: i for i, t in enumerate(self.tokens)}

    def __len__(self):
        return len(self.tokens)

    def get_vocab(self):
        return dict(self.vocab)

    def encode(self, text, add_special_tokens=True):
        del add_special_tokens
        ids, prev_letter = [], False
        for c in text:
            if c in LETTERS:
                ids.append(self.vocab["##" + c if prev_letter else c])
                prev_letter = True
            else:
                ids.append(self.vocab.get(c, self.unk_token_id))
                prev_letter = False
        return ids


VOCAB = len(_Tok())


def _word(rng):
    if rng.rand() < 0.3:
        return "".join(rng.choice(list(LETTERS), rng.randint(1, 4)))
    return "".join(rng.choice(list(CHARS), rng.randint(1, 4)))


def _text(rng, n_sents=3):
    return "".join("".join(_word(rng) for _ in range(rng.randint(2, 6))) +
                   rng.choice(list("。！？")) for _ in range(n_sents))


def _segmenter(name):
    if name == "jieba":
        return pytest.importorskip("jieba").lcut
    if name == "callable":
        return lambda text: [text[i:i + 2] for i in range(0, len(text), 2)]
    return False


def _write_jsonl(path, rows):
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                            for r in rows))
    return str(path)


# -- data_utils ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_helpers_are_bitwise(seed):
    """Sentence split, SOP pairing, truncation and token types equal the
    JAX package's, and leave the ``RandomState`` where it leaves it."""
    from fengshen_tpu.data import data_utils as jdu
    rng = np.random.RandomState(seed)
    for _ in range(20):
        text = _text(rng, rng.randint(1, 5)) + ("尾巴" if rng.rand() < .5
                                                else "")
        assert port_du.ChineseSentenceSplitter()(text) == \
            jdu.ChineseSentenceSplitter()(text)
        sents = [rng.randint(5, VOCAB, rng.randint(1, 9)).tolist()
                 for _ in range(rng.randint(2, 6))]
        budget = int(rng.randint(3, 30))
        out = []
        for mod in (port_du, jdu):
            r = np.random.RandomState(seed + 7)
            a, b, swapped = mod.get_a_and_b_segments(
                [list(s) for s in sents], r)
            cut = mod.truncate_segments(a, b, len(a), len(b), budget, r)
            tokens, types = mod.create_tokens_and_tokentypes(a, b, 2, 3)
            out.append((a, b, swapped, cut, tokens, types, r.randint(1 << 30)))
        assert out[0] == out[1]


@pytest.mark.parametrize("style,whole_word,segmenter", [
    ("bert", True, "jieba"), ("bert", True, "wordpiece"),
    ("bert", True, "callable"), ("bert", False, "wordpiece"),
    ("t5", True, "jieba"), ("t5", False, "wordpiece")])
def test_masked_lm_predictions_are_bitwise(style, whole_word, segmenter):
    """``create_masked_lm_predictions`` equals the JAX package's over
    several seeds and lengths, its draws in the same order (the state
    after each call equal)."""
    from fengshen_tpu.data.data_utils import mask_utils as jmask
    zh = _segmenter(segmenter) or None
    tok = _Tok()
    vocab = tok.get_vocab()
    id_list = list(vocab.values())
    id_to_token = {v: k for k, v in vocab.items()}
    for seed in range(6):
        rng = np.random.RandomState(seed)
        body = tok.encode(_text(rng, 4))[: rng.randint(4, 60)]
        tokens = [2] + body + [3]
        outs = []
        for fn in (port_du.create_masked_lm_predictions,
                   jmask.create_masked_lm_predictions):
            r = np.random.RandomState(100 + seed)
            got = fn(tokens, id_list, id_to_token, 0.15 + 0.1 * (seed % 3),
                     2, 3, 4, max_predictions_per_seq=1 + seed * 3,
                     np_rng=r, masking_style=style, zh_tokenizer=zh,
                     do_whole_word_mask=whole_word)
            outs.append((got, r.randint(1 << 30)))
        assert outs[0] == outs[1]


# -- the native index builders ------------------------------------------------

def _corpus_arrays(seed, n_docs, max_sents=9, max_len=40):
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, max_sents, n_docs)
    docs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sizes = rng.randint(1, max_len, int(docs[-1])).astype(np.int32)
    return rng, docs, sizes


@pytest.mark.parametrize("seed,n_docs,target", [(0, 300, 61), (1, 40, 13)])
def test_native_builders_match_plain_and_jax(seed, n_docs, target):
    """The port's build of ``csrc/index_helpers.cpp`` gives the plain
    versions' ``build_sample_idx`` and ``build_blending_indices``
    bitwise, and every builder equals the JAX package's build of its
    copy (``build_mapping`` draws from ``mt19937_64``, so only a build
    of the same source can hold it)."""
    from fengshen_tpu.data.megatron_dataloader import helpers as jh
    rng, docs, sizes = _corpus_arrays(seed, n_docs)
    for prob in (0.0, 0.1, 0.5):
        got = port_h.build_mapping(docs, sizes, target, prob, seed + 3)
        np.testing.assert_array_equal(
            got, jh.build_mapping(docs, sizes, target, prob, seed + 3))
        assert got.dtype == np.int64 and len(got) > 0
        assert (got[:, 2] <= target).all() and (got[:, 1] > got[:, 0]).all()
    np.testing.assert_array_equal(
        port_h.build_blocks_mapping(docs, sizes, target),
        jh.build_blocks_mapping(docs, sizes, target))
    order = rng.permutation(len(sizes)).astype(np.int32)
    for seq in (target, 128, 4096 * 64):
        args = (sizes, order, seq, 1, int(sizes.sum()))
        got = port_h.build_sample_idx(*args)
        np.testing.assert_array_equal(got, port_h.build_sample_idx_plain(
            *args))
        np.testing.assert_array_equal(got, jh.build_sample_idx(*args))
    for weights, size in (([0.7, 0.3], 997), ([1, 2, 3, 0.5], 500)):
        got = port_h.build_blending_indices(weights, size)
        for want in (port_h.build_blending_indices_plain(weights, size),
                     jh.build_blending_indices(np.asarray(weights, float),
                                               size)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_index_helpers_build_where_they_should_and_fail_loudly(tmp_path):
    """The library is built into ``_build/`` under a name hashing the
    source, the compiler and the flags; a compiler at a missing path, a
    missing source and a source that does not compile each raise
    ``IndexHelpersError`` naming what failed; the ``.cpp`` is not among
    the CUDA library's sources or in its fingerprint."""
    from fengshen_tpu_torch.ops.kernels import build as cuda_build
    lib = port_h.build()
    assert lib.parent == port_h.BUILD_DIR == cuda_build.BUILD_DIR
    assert lib.name.startswith("libindex_helpers-") and lib.exists()
    assert port_h.library_path(cxx="g++") != port_h.library_path(
        cxx="clang++")
    missing = str(tmp_path / "no" / "c++")
    with pytest.raises(port_h.IndexHelpersError, match="no/c\\+\\+"):
        port_h.build(cxx=missing)
    with pytest.raises(port_h.IndexHelpersError, match="missing"):
        port_h.build(source=tmp_path / "none.cpp")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(port_h.IndexHelpersError, match="bad.cpp"):
        port_h.build(source=bad)
    assert not list(port_h.BUILD_DIR.glob("*.tmp.so"))
    assert port_h.SOURCE.parent == cuda_build.CSRC_DIR
    assert all(s.suffix == ".cu" for s in cuda_build.sources())
    # the CUDA library's fingerprint reads *.cu and *.cuh alone
    assert port_h.SOURCE.name not in [
        p.name for p in cuda_build.CSRC_DIR.glob("*.cu*")]


# -- datasets over an indexed corpus ------------------------------------------

def _corpus(tmp_path, seed=0, n_docs=12, name="c"):
    """Documents of 1-5 sentences of letter words and characters; the
    port's builder writes them."""
    tok = _Tok()
    rng = np.random.RandomState(seed)
    builder = port_md.MMapIndexedDatasetBuilder(str(tmp_path / name))
    for _ in range(n_docs):
        for _ in range(rng.randint(1, 6)):
            builder.add_item(tok.encode(
                "".join(_word(rng) for _ in range(rng.randint(1, 8)))))
        builder.end_document()
    builder.finalize()
    return (port_md.MMapIndexedDataset(str(tmp_path / name)),
            str(tmp_path / name))


def _same_items(got_ds, want_ds, tag=""):
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, (tag, i, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{tag} {i} {k}")


@pytest.mark.parametrize("segmenter", ["jieba", "wordpiece"])
def test_bert_dataset_is_bitwise(tmp_path, segmenter):
    """Every ``BertDataset`` sample equals the JAX package's over one
    corpus (two lengths, two seeds, short windows on and off)."""
    from fengshen_tpu.data.megatron_dataloader import bert_dataset as jb
    from fengshen_tpu.data.megatron_dataloader import indexed_dataset as jid
    zh = _segmenter(segmenter)
    corpus, prefix = _corpus(tmp_path, 1, 16)
    jcorpus = jid.MMapIndexedDataset(prefix)
    for kw in (dict(max_seq_length=64, seed=0),
               dict(max_seq_length=24, seed=5, masked_lm_prob=0.3,
                    short_seq_prob=0.5)):
        _same_items(port_md.BertDataset(corpus, _Tok(), zh_tokenizer=zh,
                                        **kw),
                    jb.BertDataset(jcorpus, _Tok(), zh_tokenizer=zh, **kw),
                    str(kw))


def test_gpt_dataset_and_its_cache_are_shared(tmp_path):
    """``GPTDataset`` samples equal the JAX package's (one and two
    epochs, a document subset); the sentence order is the JAX loop's;
    a cache written by either package is the file the other reads."""
    from fengshen_tpu.data.megatron_dataloader import gpt_dataset as jg
    from fengshen_tpu.data.megatron_dataloader import indexed_dataset as jid
    corpus, prefix = _corpus(tmp_path, 2, 20)
    jcorpus = jid.MMapIndexedDataset(prefix)
    for kw in (dict(seq_length=16, seed=3),
               dict(seq_length=7, seed=4, num_epochs=2),
               dict(seq_length=9, seed=1,
                    documents=np.arange(3, 15, dtype=np.int32))):
        _same_items(port_md.GPTDataset(corpus, **kw),
                    jg.GPTDataset(jcorpus, **kw), str(kw))
    order = np.random.RandomState(0).permutation(20).astype(np.int32)
    want = []
    for d in order:
        want.extend(range(int(corpus.doc_idx[d]), int(corpus.doc_idx[d + 1])))
    got = port_md.gpt_dataset.sequence_order(corpus.doc_idx, order)
    assert got.dtype == np.int32 and got.tolist() == want
    for writer, reader, name in ((port_md.GPTDataset, jg.GPTDataset, "p"),
                                 (jg.GPTDataset, port_md.GPTDataset, "j")):
        cache = tmp_path / f"cache_{name}"
        w = writer(corpus if writer is port_md.GPTDataset else jcorpus, 11,
                   seed=6, cache_dir=str(cache), name="wiki")
        files = sorted(p.name for p in cache.iterdir())
        assert len(files) == 1 and files[0].startswith("wiki_sample_idx_")
        r = reader(jcorpus if writer is port_md.GPTDataset else corpus, 11,
                   seed=6, cache_dir=str(cache), name="wiki")
        assert isinstance(r.sample_idx, np.memmap)
        np.testing.assert_array_equal(r.sample_idx, w.sample_idx)
        assert sorted(p.name for p in cache.iterdir()) == files
    assert sorted(p.name for p in (tmp_path / "cache_p").iterdir()) == \
        sorted(p.name for p in (tmp_path / "cache_j").iterdir())


def test_blendable_dataset_is_bitwise(tmp_path):
    """A ``BlendableDataset`` of a BERT and a GPT dataset (weights 0.7 /
    0.3, past their total so both wrap) equals the JAX package's item
    for item."""
    from fengshen_tpu.data.megatron_dataloader import bert_dataset as jb
    from fengshen_tpu.data.megatron_dataloader import blendable_dataset as jbl
    from fengshen_tpu.data.megatron_dataloader import gpt_dataset as jg
    from fengshen_tpu.data.megatron_dataloader import indexed_dataset as jid
    corpus, prefix = _corpus(tmp_path, 3, 14)
    jcorpus = jid.MMapIndexedDataset(prefix)
    parts = [(port_md.BertDataset(corpus, _Tok(), 32, zh_tokenizer=False),
              jb.BertDataset(jcorpus, _Tok(), 32, zh_tokenizer=False)),
             (port_md.GPTDataset(corpus, 8), jg.GPTDataset(jcorpus, 8))]
    size = 3 * sum(len(p) for p, _ in parts)
    got = port_md.BlendableDataset([p for p, _ in parts], [0.7, 0.3], size)
    want = jbl.BlendableDataset([j for _, j in parts], [0.7, 0.3], size)
    np.testing.assert_array_equal(got.dataset_index, want.dataset_index)
    np.testing.assert_array_equal(got.dataset_sample_index,
                                  want.dataset_sample_index)
    _same_items(got, want)
    with pytest.raises(ValueError):
        port_md.BlendableDataset([parts[0][0]], [0.5, 0.5])


# -- collators ------------------------------------------------------------------

def _collator_pair(name, segmenter):
    """``(port collator, JAX collator)`` given one segmenter (the JAX
    collators take ``jieba`` at build time where it imports; their
    attribute is then set to the same segmenter)."""
    from fengshen_tpu.examples.pretrain_bert import pretrain_bert as jpb
    from fengshen_tpu.examples.pretrain_erlangshen_bert import \
        pretrain_erlangshen as jpe
    from fengshen_tpu.examples.pretrain_erlangshen_deberta_v2 import \
        pretrain_deberta as jpd
    tok, zh = _Tok(), _segmenter(segmenter)
    if name == "erlangshen":
        got = port_pe.ErLangShenCollator(tok, 48, zh_tokenizer=zh)
        want = jpe.ErLangShenCollator(tok, 48)
        want.zh_tokenizer = zh or None
        return got, want
    if name == "wwm":
        got = port_pb.WWMBertCollator(tok, 40, word_cuter=zh)
        want = jpb.WWMBertCollator(tok, 40)
        want.word_cuter = zh or port_pb._characters
        return got, want
    got = port_pd.DeBERTaV2Collator(tok, 32, zh_tokenizer=zh)
    want = jpd.DeBERTaV2Collator(tok, 32)
    want.zh_tokenizer = zh or None
    return got, want


@pytest.mark.parametrize("name,segmenter", [
    ("erlangshen", "jieba"), ("erlangshen", "wordpiece"),
    ("wwm", "jieba"), ("wwm", "characters"),
    ("deberta", "jieba"), ("deberta", "wordpiece")])
def test_collators_are_bitwise(name, segmenter):
    """Successive batches (long texts truncated, one-sentence texts
    split in half, empty texts) equal the JAX collator's."""
    got_c, want_c = _collator_pair(name, segmenter)
    rng = np.random.RandomState(5)
    for _ in range(4):
        rows = [{"text": _text(rng, rng.randint(1, 12))} for _ in range(3)]
        rows.append({"text": "" if name != "erlangshen" else "今天"})
        got, want = got_c(rows), want_c(rows)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_without_jieba_each_user_names_its_opt_out(tmp_path, monkeypatch):
    """``zh_tokenizer=None`` (``word_cuter=None``) without ``jieba``
    raises ``ImportError`` naming ``=False``; ``False`` builds (the JAX
    package falls back quietly)."""
    corpus, _ = _corpus(tmp_path, 4, 3)
    monkeypatch.setitem(sys.modules, "jieba", None)
    tok = _Tok()
    for build, option in (
            (lambda z: port_pe.ErLangShenCollator(tok, zh_tokenizer=z),
             "zh_tokenizer"),
            (lambda z: port_pd.DeBERTaV2Collator(tok, zh_tokenizer=z),
             "zh_tokenizer"),
            (lambda z: port_pb.WWMBertCollator(tok, word_cuter=z),
             "word_cuter"),
            (lambda z: port_md.BertDataset(corpus, tok, 32,
                                           zh_tokenizer=z),
             "zh_tokenizer")):
        with pytest.raises(ImportError, match=f"{option}=False"):
            build(None)
        assert build(False) is not None


# -- DeBERTa-v2 ------------------------------------------------------------------

@pytest.mark.parametrize("seq,buckets,max_pos", [
    (512, 256, 512), (512, 256, -1), (100, 16, 64), (300, 0, 512)])
def test_deberta_bucket_table_is_bitwise(seq, buckets, max_pos):
    """``build_relative_position`` equals the JAX table element for
    element, at the Erlangshen-DeBERTa geometry (512 positions, 256
    buckets) and others; the table is int32 on the device asked."""
    from fengshen_tpu.models.deberta_v2 import modeling_deberta_v2 as jd
    want = np.asarray(jd.build_relative_position(seq, seq, buckets, max_pos))
    got = port_deb.build_relative_position(seq, seq, buckets, max_pos,
                                           device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


DEB_VARIANTS = {
    "default": {},
    "conv": dict(conv_kernel_size=3),
    "unshared": dict(share_att_key=False),
    "conv_unshared_even": dict(conv_kernel_size=4, share_att_key=False),
    "c2p_position_biased": dict(pos_att_type="c2p",
                                position_biased_input=True),
}


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _deb_pair(cls_name, variant, seed=0, jmod=None, port_mod=None, **kw):
    """``(JAX model, params, port model)``: JAX initial weights plus
    0.05 x N(0, 1), the same in both."""
    import jax
    import jax.numpy as jnp
    from fengshen_tpu.models import deberta_v2 as jdeb
    over = dict(DEB_VARIANTS[variant], vocab_size=VOCAB, dtype="float32",
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jm = getattr(jmod or jdeb, cls_name)(
        jdeb.DebertaV2Config.small_test_config(**over), **kw)
    shape = (1, 2, 6) if "MultipleChoice" in cls_name else (1, 6)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed),
                              jnp.zeros(shape, jnp.int32))["params"])
    rng = np.random.RandomState(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(x.dtype), params)
    cfg = port_deb.DebertaV2Config.small_test_config(**over)
    model = getattr(port_mod or port_deb, cls_name)(cfg, device="cpu",
                                                    init=False, **kw)
    model.load_state_dict(deb_convert.params_from_jax(params, cfg))
    return jm, params, model


def _ids(seed=0, batch=3, seq=20):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, VOCAB, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[1, seq - 7:] = 0
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("variant", sorted(DEB_VARIANTS))
def test_deberta_forward_matches_jax(variant):
    """The encoder, the MLM logits and the classification logits equal
    the JAX models' within 1e-4 in fp32 (padding masked)."""
    import jax.numpy as jnp
    ids, mask = _ids(1)
    for i, cls_name in enumerate(("DebertaV2Model", "DebertaV2ForMaskedLM",
                                  "DebertaV2ForSequenceClassification")):
        jm, params, model = _deb_pair(cls_name, variant, seed=i)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                                   jnp.asarray(mask)))
        with torch.no_grad():
            got = model(_t(ids), _t(mask)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=cls_name)


def _assert_grads(got: dict, want: dict):
    """Each tensor within GRAD_REL of its norm, plus GRAD_FLOOR of the
    largest tensor's norm (for gradients that are zero up to rounding:
    a position-key bias adds one constant to each query's scores)."""
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(np.linalg.norm(w.numpy())
                             for w in want.values())
    for n, g in got.items():
        w = want[n].numpy()
        assert np.linalg.norm(g.numpy() - w) <= \
            GRAD_REL * np.linalg.norm(w) + floor, n


@pytest.mark.parametrize("variant", ["default", "conv_unshared_even"])
def test_deberta_mlm_gradients_match_jax(variant):
    """Gradients of a weighted sum of the MLM logits equal ``jax.grad``
    for every parameter."""
    import jax
    import jax.numpy as jnp
    jm, params, model = _deb_pair("DebertaV2ForMaskedLM", variant, seed=3)
    ids, mask = _ids(2)
    w = np.random.RandomState(9).randn(3, 20, VOCAB).astype(np.float32)
    grads = jax.grad(lambda p: (jm.apply({"params": p}, jnp.asarray(ids),
                                         jnp.asarray(mask)) * w).sum())(
        params)
    (model(_t(ids), _t(mask)) * torch.from_numpy(w)).sum().backward()
    _assert_grads({n: p.grad for n, p in model.named_parameters()},
                  deb_convert.params_from_jax(_np_tree(grads), None))


def test_deberta_task_heads_match_jax():
    """Token classification, question answering and multiple choice
    (the factory's heads over an encoder without a pooler) equal the
    JAX heads."""
    import jax.numpy as jnp
    from fengshen_tpu.models.deberta_v2 import task_heads as jth
    from fengshen_tpu_torch.models.deberta_v2 import task_heads as pth
    ids, mask = _ids(4, batch=4, seq=12)
    for cls_name in ("DebertaV2ForTokenClassification",
                     "DebertaV2ForQuestionAnswering",
                     "DebertaV2ForMultipleChoice"):
        jm, params, model = _deb_pair(cls_name, "conv", seed=5, jmod=jth,
                                      port_mod=pth)
        x, m = (ids, mask) if "Multiple" not in cls_name else \
            (ids.reshape(2, 2, 12), mask.reshape(2, 2, 12))
        want = jm.apply({"params": params}, jnp.asarray(x),
                        attention_mask=jnp.asarray(m))
        with torch.no_grad():
            got = model(_t(x), attention_mask=_t(m))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL, err_msg=cls_name)


def test_deberta_hf_export_reimports(tmp_path):
    """The port's HF export (MLM and classification heads) reads back to
    the same state bitwise, and the JAX converter's tree of it gives
    the port's logits; ``deberta-v2`` resolves in ``models/auto`` as in
    the JAX registry; the model is made on the card unless asked for the
    CPU."""
    import jax.numpy as jnp
    from fengshen_tpu.models.auto.auto_factory import MODEL_REGISTRY as JREG
    from fengshen_tpu.models.deberta_v2 import convert as jconv
    from fengshen_tpu_torch.models.auto import AutoConfig, AutoModel
    from fengshen_tpu_torch.models.auto import auto_factory
    ids, mask = _ids(6)
    for cls_name in ("DebertaV2ForMaskedLM",
                     "DebertaV2ForSequenceClassification"):
        jm, _, model = _deb_pair(cls_name, "conv_unshared_even", seed=7)
        cfg = model.config
        hf = deb_convert.params_to_torch_state(model.state_dict(), cfg)
        back = deb_convert.torch_to_params(hf, cfg)
        assert back.keys() == model.state_dict().keys()
        for k, v in model.state_dict().items():
            assert torch.equal(back[k], v), k
        jparams = jconv.torch_to_params(
            {k: v.numpy() for k, v in hf.items()}, jm.config)
        want = np.asarray(_jax_encoder(jm.config).apply(
            {"params": jparams["deberta"]}, jnp.asarray(ids),
            jnp.asarray(mask)))
        with torch.no_grad():
            got = model.deberta(_t(ids), _t(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    cfg_path = tmp_path / "config.json"
    port_deb.DebertaV2Config.small_test_config(
        pos_att_type="p2c|c2p").save_pretrained(str(tmp_path))
    cfg = AutoConfig.from_pretrained(str(tmp_path))
    assert cfg_path.exists() and cfg.pos_att_type == ("p2c", "c2p")
    assert auto_factory.MODEL_REGISTRY["deberta-v2"][1:] == \
        (JREG["deberta-v2"][1], JREG["deberta-v2"][2])
    for head, cls in auto_factory.MODEL_REGISTRY["deberta-v2"][2].items():
        assert type(AutoModel.from_config(cfg, head=head, device="cpu")
                    ).__name__ == cls
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_deb.DebertaV2Model(cfg)


def _jax_encoder(config):
    from fengshen_tpu.models.deberta_v2 import DebertaV2Model
    return DebertaV2Model(config)


# -- modules and mains ----------------------------------------------------------

def _np_params(jm, seed, noise=0.05):
    import jax
    import jax.numpy as jnp
    params = _np_tree(jm.init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 6), jnp.int32))["params"])
    rng = np.random.RandomState(seed + 100)
    return jax.tree_util.tree_map(
        lambda x: (x + noise * rng.randn(*x.shape)).astype(x.dtype), params)


#: name -> (JAX family module, config, model class, port family, converter,
#: JAX example module, its module class, port example, collator maker)
FAMILY = {
    "erlangshen": ("fengshen_tpu.models.megatron_bert", "MegatronBertConfig",
                   "MegatronBertForPreTraining", port_mb, mb_convert,
                   "fengshen_tpu.examples.pretrain_erlangshen_bert."
                   "pretrain_erlangshen", "ErLangShenBert", port_pe),
    "bert": ("fengshen_tpu.models.bert", "BertConfig", "BertForMaskedLM",
             port_bert, bert_convert,
             "fengshen_tpu.examples.pretrain_bert.pretrain_bert",
             "BertPretrainModule", port_pb),
    "deberta": ("fengshen_tpu.models.deberta_v2", "DebertaV2Config",
                "DebertaV2ForMaskedLM", port_deb, deb_convert,
                "fengshen_tpu.examples.pretrain_erlangshen_deberta_v2."
                "pretrain_deberta", "DebertaPretrainModule", port_pd),
}
MODULE_CLS = {"erlangshen": port_pe.ErLangShenBert,
              "bert": port_pb.BertPretrainModule,
              "deberta": port_pd.DebertaPretrainModule}


def _family_pair(name, seed):
    """``(JAX config, params, port config, port model)``."""
    import importlib
    jfam, cfg_name, cls_name, port_fam, conv = FAMILY[name][:5]
    over = dict(vocab_size=VOCAB, dtype="float32", hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0,
                max_position_embeddings=64)
    jcfg = getattr(importlib.import_module(jfam), cfg_name
                   ).small_test_config(**over)
    params = _np_params(getattr(importlib.import_module(jfam), cls_name)(
        jcfg), seed)
    cfg = getattr(port_fam, cfg_name).small_test_config(**over)
    model = getattr(port_fam, cls_name)(cfg, device="cpu", init=False)
    model.load_state_dict(conv.params_from_jax(params, cfg))
    return jcfg, params, cfg, model


def _batch(name, tok, rng):
    rows = [{"text": _text(rng, rng.randint(2, 8))} for _ in range(3)]
    if name == "erlangshen":
        return port_pe.ErLangShenCollator(tok, 40, zh_tokenizer=False)(rows)
    if name == "bert":
        return port_pb.WWMBertCollator(tok, 40, mask_rate=0.3,
                                       word_cuter=False)(rows)
    return port_pd.DeBERTaV2Collator(tok, 40, zh_tokenizer=False)(rows)


@pytest.mark.parametrize("name", ["erlangshen", "bert", "deberta"])
def test_module_loss_and_grads_match_jax(name):
    """Each module's ``training_loss`` and metrics (``mlm_loss``,
    ``sop_loss``, ``mlm_acc``, ``n_tokens``) against the JAX module's on
    the same weights and batch within 1e-4, every gradient against
    ``jax.grad`` within 1e-4 relative L2; Erlangshen's
    ``flops_per_token`` equal."""
    import importlib

    import jax
    import jax.numpy as jnp
    jcfg, params, cfg, model = _family_pair(name, seed=11)
    args = argparse.Namespace(max_seq_length=40, masked_lm_prob=0.15)
    jmod = getattr(importlib.import_module(FAMILY[name][5]),
                   FAMILY[name][6])(args, config=jcfg)
    pmod = MODULE_CLS[name](args, model, cfg)
    batch = _batch(name, _Tok(), np.random.RandomState(12))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wm), grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.training_loss(p, jbatch, jax.random.PRNGKey(0)),
        has_aux=True))(params)
    loss, metrics = pmod.training_loss({k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(want)) < ATOL
    assert metrics.keys() == wm.keys()
    for k in wm:
        assert abs(float(metrics[k]) - float(wm[k])) < ATOL, k
    _assert_grads({n: p.grad for n, p in model.named_parameters()},
                  FAMILY[name][4].params_from_jax(_np_tree(grads), cfg))
    if name == "erlangshen":
        assert pmod.flops_per_token() == jmod.flops_per_token()


def _checkpoint_dir(path, name, model, cfg):
    cfg.save_pretrained(str(path))
    conv = FAMILY[name][4]
    write_safetensors(str(path / "model.safetensors"),
                      {k: v.contiguous() for k, v in
                       conv.params_to_torch_state(model.state_dict(),
                                                  cfg).items()})
    return str(path)


def _trainer_flags(root):
    return ["--train_batchsize", "4", "--max_steps", "2",
            "--learning_rate", "1e-3", "--warmup_steps", "1",
            "--log_every_n_steps", "1", "--seed", "0",
            "--max_seq_length", "40", "--default_root_dir",
            str(root / "runs"), "--save_ckpt_path", str(root / "ckpt"),
            "--load_ckpt_path", str(root / "ckpt")]


@pytest.mark.parametrize("name", ["erlangshen", "bert", "deberta"])
def test_main_fits_as_the_jax_main(tmp_path, name):
    """Each example's ``main`` fits 2 steps on the CPU from an HF-named
    checkpoint, jieba segmenting in both packages; its logged losses
    (and Erlangshen's ``mlm_loss`` and ``sop_loss``) equal the JAX
    ``main``'s (its module given the same weights, its tokenizer the
    test's) within 1e-4; the entry point needs the card unless asked
    for the CPU."""
    import importlib

    import jax
    pytest.importorskip("jieba")
    _, params, cfg, model = _family_pair(name, seed=13)
    model_dir = _checkpoint_dir(tmp_path / "model", name, model, cfg)
    rng = np.random.RandomState(14)
    train = _write_jsonl(tmp_path / "t.json",
                         [{"text": _text(rng, rng.randint(2, 8))}
                          for _ in range(8)])
    argv = ["--model_path", model_dir, "--train_file", train]
    tok = _Tok()
    trainer = FAMILY[name][7].main(
        argv + ["--device", "cpu"] + _trainer_flags(tmp_path / "port"),
        tokenizer=tok)
    logged = [e for e in trainer.history if "loss" in e]
    assert len(logged) == 2 and np.isfinite([e["loss"] for e in logged]).all()

    jmod = importlib.import_module(FAMILY[name][5])
    with mock.patch("transformers.AutoTokenizer.from_pretrained",
                    lambda *a, **k: tok), \
            mock.patch.object(getattr(jmod, FAMILY[name][6]), "init_params",
                              lambda self, rng: jax.tree_util.tree_map(
                                  np.array, params)):
        jmod.main(argv + _trainer_flags(tmp_path / "jax"))
    want = [json.loads(line) for line in
            (tmp_path / "jax" / "runs" / "metrics.jsonl").read_text()
            .splitlines() if '"loss"' in line]
    keys = ["loss"] + (["mlm_loss", "sop_loss"] if name == "erlangshen"
                       else [])
    for k in keys:
        np.testing.assert_allclose([e[k] for e in logged],
                                   [e[k] for e in want], rtol=0, atol=ATOL,
                                   err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FAMILY[name][7].main(argv, tokenizer=tok)


def test_resume_draws_the_uninterrupted_runs_batches(tmp_path):
    """``pretrain_bert.main`` with dropout on, 4 steps and a checkpoint
    at step 3; a second run resumed from it logs step 4 with the first
    run's loss exactly: the checkpoint holds the collator's generator.
    Resumed from a checkpoint without it, the collator starts over and
    step 4 differs."""
    family, cfg_name = port_bert, "BertConfig"
    cfg = getattr(family, cfg_name).small_test_config(
        vocab_size=VOCAB, dtype="float32", max_position_embeddings=64)
    model = family.BertForMaskedLM(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(2))
    model_dir = _checkpoint_dir(tmp_path / "model", "bert", model, cfg)
    rng = np.random.RandomState(15)
    train = _write_jsonl(tmp_path / "t.json",
                         [{"text": _text(rng, rng.randint(2, 8))}
                          for _ in range(24)])

    def run(root, steps):
        argv = ["--model_path", model_dir, "--train_file", train,
                "--device", "cpu", "--every_n_train_steps", "3"]
        flags = _trainer_flags(root)
        flags[flags.index("--max_steps") + 1] = str(steps)
        trainer = port_pb.main(argv + flags, tokenizer=_Tok(),
                               word_cuter=False)
        return {e["step"]: e["loss"] for e in trainer.history
                if "loss" in e}

    whole = run(tmp_path / "a", 4)
    assert sorted(whole) == [1, 2, 3, 4]
    import shutil
    shutil.copytree(tmp_path / "a" / "ckpt", tmp_path / "b" / "ckpt")
    shutil.copytree(tmp_path / "a" / "ckpt", tmp_path / "c" / "ckpt")
    assert sorted(p.name for p in (tmp_path / "a" / "ckpt").iterdir()) == \
        ["3"]
    assert run(tmp_path / "b", 4) == {4: whole[4]}
    meta_path = tmp_path / "c" / "ckpt" / "3" / "meta.json"
    meta = json.loads(meta_path.read_text())
    assert len(meta.pop("collate_state")["np_rng"][1]) == 624
    meta_path.write_text(json.dumps(meta))
    assert run(tmp_path / "c", 4)[4] != whole[4]


def test_bulk_corpus_writes_the_per_item_bytes(tmp_path):
    """``add_items`` and ``end_documents`` write the bytes of one
    ``add_item`` per sequence and one ``end_document`` per document (the
    JAX package's files); counts that do not add up raise."""
    from fengshen_tpu.data.megatron_dataloader import indexed_dataset as jid
    rng = np.random.RandomState(8)
    counts = rng.randint(1, 5, 30)
    sizes = rng.randint(1, 9, int(counts.sum()))
    tokens = rng.randint(0, 500, int(sizes.sum()))
    bulk = port_md.MMapIndexedDatasetBuilder(str(tmp_path / "bulk"))
    half = int(counts[:12].sum())
    bulk.add_items(tokens[:int(sizes[:half].sum())], sizes[:half])
    bulk.end_documents(counts[:12])
    bulk.add_items(tokens[int(sizes[:half].sum()):], sizes[half:])
    bulk.end_documents(counts[12:])
    bulk.finalize()
    one = jid.MMapIndexedDatasetBuilder(str(tmp_path / "one"))
    pos, seq = 0, 0
    for c in counts:
        for _ in range(c):
            one.add_item(tokens[pos:pos + sizes[seq]])
            pos, seq = pos + sizes[seq], seq + 1
        one.end_document()
    one.finalize()
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"bulk{ext}").read_bytes() == \
            (tmp_path / f"one{ext}").read_bytes()
    bad = port_md.MMapIndexedDatasetBuilder(str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="add up"):
        bad.add_items(tokens[:5], [2, 2])
    bad.add_items(tokens[:4], [2, 2])
    with pytest.raises(ValueError, match="2 were added"):
        bad.end_documents([1, 2])
