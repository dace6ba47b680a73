"""Offline corpus tokenization for T5 pretraining: the port of
``fengshen_tpu/examples/pretrain_t5/process_data.py`` (driven by
``process_data_bert_tokenizer.sh``), array for array the same shards.

The corpus (a jsonl file, a directory of ``.json`` / ``.jsonl`` /
``.txt`` files, or plain text with one document a line) is tokenized
once, split train/test by ``--train_split_size``, and saved as
``shard_NNNNN.npy`` object arrays of int32 id lists, row ``j`` of shard
``i`` being row ``i + j x shards``. The tokenizer is the caller's
(``tokenizer=``), else ``--tokenizer_type``'s from
``--pretrained_model_path``. No device is used.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def iter_texts(path: str, text_column: str):
    """The documents of ``path``: a jsonl row's ``text_column``, else
    the line itself (:25)."""
    paths = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith((".json", ".jsonl", ".txt")):
                paths.append(os.path.join(path, name))
    else:
        paths = [path]
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("{"):
                    try:
                        yield json.loads(line).get(text_column, "")
                        continue
                    except json.JSONDecodeError:
                        pass
                yield line


def save_shards(rows: list, out_dir: str, n_shards: int) -> int:
    """Write ``rows`` round-robin into ``n_shards`` (at most one a row)
    ``.npy`` files under ``out_dir``; return the shard count (:52)."""
    os.makedirs(out_dir, exist_ok=True)
    n_shards = max(1, min(n_shards, len(rows) or 1))
    for i in range(n_shards):
        shard = rows[i::n_shards]
        arr = np.empty(len(shard), dtype=object)
        for j, ids in enumerate(shard):
            arr[j] = np.asarray(ids, np.int32)
        np.save(os.path.join(out_dir, f"shard_{i:05d}.npy"), arr,
                allow_pickle=True)
    return n_shards


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Pretrain Unsupervise.")
    parser.add_argument("--train_data_path", default=None, type=str)
    parser.add_argument("--preprocessing_num_workers", default=30,
                        type=int)
    parser.add_argument("--saved_data_shards", default=800, type=int)
    parser.add_argument("--saved_train_data_path", default=None, type=str)
    parser.add_argument("--saved_test_data_path", default=None, type=str)
    parser.add_argument("--max_seq_length", default=512, type=int)
    parser.add_argument("--train_split_size", default=0.999, type=float)
    parser.add_argument("--pretrained_model_path", default=None, type=str)
    parser.add_argument("--tokenizer_type", default="t5_tokenizer",
                        choices=["t5_tokenizer", "bert_tokenizer"])
    parser.add_argument("--text_column_name", default="text")
    parser.add_argument("--remove_columns", nargs="+", default=[])
    return parser


def main(argv=None, tokenizer=None) -> tuple:
    """Tokenize, split and save; return ``(train rows, test rows)``."""
    args = build_parser().parse_args(argv)
    if tokenizer is None:
        if args.tokenizer_type == "bert_tokenizer":
            from fengshen_tpu_torch.models.t5 import T5Tokenizer
            tokenizer = T5Tokenizer.from_pretrained(
                args.pretrained_model_path)
        else:
            from fengshen_tpu_torch.models.auto import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(
                args.pretrained_model_path)

    rows = []
    for text in iter_texts(args.train_data_path, args.text_column_name):
        ids = tokenizer.encode(text, add_special_tokens=False,
                               truncation=True,
                               max_length=args.max_seq_length)
        if ids:
            rows.append(ids)

    split = int(len(rows) * args.train_split_size)
    train, test = rows[:split], rows[split:]
    n_train = save_shards(train, args.saved_train_data_path,
                          args.saved_data_shards)
    n_test = save_shards(test, args.saved_test_data_path,
                         max(1, args.saved_data_shards // 100))
    print(f"train: {len(train)} docs / {n_train} shards -> "
          f"{args.saved_train_data_path}")
    print(f"test:  {len(test)} docs / {n_test} shards -> "
          f"{args.saved_test_data_path}")
    return len(train), len(test)


if __name__ == "__main__":
    main()
