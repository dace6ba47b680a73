"""The encoder-decoder path on the card (``gpu``-marked; skipped without
one). This file imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_seq2seq_gpu.py

- T5 (gated-gelu, untied), BART and Pegasus at a small width in fp32:
  the same weights on ``cuda`` and on the CPU give the same logits
  (within 1e-4), the same greedy and beam-4 tokens over the cache, and
  the cache's stepped decoder equals the uncached one on the card; no
  kernel of the port launches (the families' attention is dense, as in
  the reference).
- ``seq2seq_summary.main`` on the card and on the CPU from one HF-named
  checkpoint: the logged losses within 1e-4 and ``predict.json`` equal.

Limits: fp32 reduction order on the two devices (~1e-6 measured on
the CPU side); tokens equal, or parting only where the CPU forward's
top-2 gap is below 1e-4.
"""

import json

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.examples.summary import seq2seq_summary as ss
from fengshen_tpu_torch.models import bart, pegasus, t5
from fengshen_tpu_torch.models.t5 import convert as t5_convert
from fengshen_tpu_torch.ops.kernels import _REGISTRY, reset_launch_counts
from fengshen_tpu_torch.utils.convert_common import write_safetensors
from fengshen_tpu_torch.utils.generate import seq2seq_generate

ATOL = 1e-4
TIE_MARGIN = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(family, device):
    if family == "t5":
        cfg = t5.T5Config.small_test_config(
            vocab_size=64, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            feed_forward_proj="gated-gelu", tie_word_embeddings=False,
            dtype="float32", dropout_rate=0.0)
        cls = t5.T5ForConditionalGeneration
    elif family == "bart":
        cfg = bart.BartConfig.small_test_config(
            vocab_size=64, d_model=64, dtype="float32", dropout=0.0,
            init_std=0.2)
        cls = bart.BartForConditionalGeneration
    else:
        cfg = pegasus.PegasusConfig.small_test_config(
            vocab_size=64, d_model=64, dtype="float32", init_std=0.2)
        cls = pegasus.PegasusForConditionalGeneration
    return cls(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0)), cfg


def _inputs():
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(2, 64, (4, 12)))
    mask = torch.ones_like(ids)
    mask[1, 8:] = 0
    dec = torch.from_numpy(rng.randint(2, 64, (4, 7)))
    return ids, mask, dec


def _kernel_launches():
    return {name: entry.launches for name, entry in _REGISTRY.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["t5", "bart", "pegasus"])
def test_the_card_matches_the_cpu(cuda_device, family):
    cpu_model, _ = _model(family, "cpu")
    model, _ = _model(family, cuda_device)
    model.load_state_dict(cpu_model.state_dict())
    ids, mask, dec = _inputs()
    reset_launch_counts()
    with torch.no_grad():
        want = cpu_model(ids, dec, attention_mask=mask)
        got = model(ids.cuda(), dec.cuda(), attention_mask=mask.cuda())
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)
        enc = model.encode(ids.cuda(), mask.cuda())
        cache = model.new_cache(ids.shape[0], dec.shape[1])
        kw = {} if family == "t5" else {"position_offset": 0}
        steps = []
        for t in range(dec.shape[1]):
            if kw:
                kw["position_offset"] = t
            steps.append(model.decode_logits(
                dec[:, t:t + 1].cuda(), enc, mask.cuda(), cache=cache,
                cross_from_cache=t > 0, **kw)[:, -1])
        np.testing.assert_allclose(torch.stack(steps, 1).cpu().numpy(),
                                   got.cpu().numpy(), rtol=0, atol=ATOL)
    common = dict(max_new_tokens=10, decoder_start_token_id=0,
                  eos_token_id=1, pad_token_id=0)
    for beams in (1, 4):
        want_tok = seq2seq_generate(cpu_model, ids, mask, num_beams=beams,
                                    device="cpu", **common)
        got_tok = seq2seq_generate(model, ids, mask, num_beams=beams,
                                   **common).cpu()
        for b in range(ids.shape[0]):
            row_w, row_g = want_tok[b].tolist(), got_tok[b].tolist()
            if row_w == row_g:
                continue
            first = next(i for i, (a, c) in enumerate(zip(row_w, row_g))
                         if a != c)
            with torch.no_grad():
                logits = cpu_model(ids[b:b + 1], want_tok[b:b + 1, :first],
                                   attention_mask=mask[b:b + 1])[0, -1]
            top = logits.topk(2).values
            assert beams == 1 and float(top[0] - top[1]) < TIE_MARGIN, \
                (family, beams, b, row_w, row_g)
    assert not any(_kernel_launches().values())


class _CharTok:
    pad_token_id, eos_token_id = 0, 1

    def encode(self, text, add_special_tokens=True):
        return [ord(c) - 94 if "a" <= c <= "z" else 2 for c in text]

    def batch_decode(self, rows, skip_special_tokens=False):
        return ["".join(chr(int(i) + 94) for i in r if 3 <= int(i) <= 28)
                for r in rows]


@pytest.mark.gpu
def test_summary_main_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    cpu_model, cfg = _model("t5", "cpu")
    model_dir = tmp_path / "model"
    cfg.save_pretrained(str(model_dir))
    write_safetensors(str(model_dir / "model.safetensors"),
                      t5_convert.params_to_torch_state(
                          cpu_model.state_dict(), cfg))
    rng = np.random.RandomState(1)
    for split, n in (("train", 8), ("test", 6)):
        rows = []
        for _ in range(n):
            text = "".join(chr(97 + c) for c in rng.randint(0, 26, 12))
            rows.append({"text": text, "summary": text[2:6]})
        (tmp_path / f"{split}.json").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    out = {}
    for dev in ("cpu", "cuda"):
        argv = [str(x) for x in (
            "--model_type", "t5", "--pretrained_model_path", model_dir,
            "--train_file", tmp_path / "train.json", "--test_file",
            tmp_path / "test.json", "--max_enc_length", 16,
            "--max_dec_length", 6, "--train_batchsize", 4,
            "--test_batchsize", 3, "--learning_rate", 1e-3, "--prompt", "",
            "--max_steps", 3, "--log_every_n_steps", 1, "--seed", 0,
            "--default_root_dir", tmp_path / dev, "--save_ckpt_path",
            tmp_path / f"{dev}_ckpt", "--load_ckpt_path",
            tmp_path / f"{dev}_ckpt", "--output_save_path",
            tmp_path / f"{dev}.json", "--device", dev)]
        trainer = ss.main(argv, tokenizer=_CharTok())
        out[dev] = ([e["loss"] for e in trainer.history if "loss" in e],
                    (tmp_path / f"{dev}.json").read_text())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=ATOL)
    assert out["cuda"][1] == out["cpu"][1]
    assert len(out["cuda"][1].splitlines()) == 6
