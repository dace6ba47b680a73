"""Text-classification fine-tune: the port of
``fengshen_tpu/examples/classification/finetune_classification.py``, the
script behind the reference's ``finetune_classification_*.sh`` and
``demo_classification_*.sh`` shells.

The chain: :func:`main` -> :class:`TaskDataModel` (jsonl splits, the
label schema in first-seen order, :class:`TaskCollator`'s pair or single
encoding per sample) -> ``Trainer.fit`` (validation, the checkpoint
callback of :class:`TaskModelCheckpoint`) -> :class:`ClassificationModule`
-> :class:`TaskModel` (the encoder and its pooler, then ``cls_layer``)
-> ``Trainer.predict`` -> :func:`save_test`. ``--do_predict_only``
restores the checkpoint and predicts.

Ported families (``model_dict``): ``huggingface-bert`` (the parser's
default; the RoBERTa AFQMC demos), ``huggingface-megatron_bert`` (the
Erlangshen shells), ``fengshen-megatron_t5`` (``T5EncoderModel``, its
first token pooled) and ``fengshen-bart`` (``BartModel.encode``, the
last real token pooled); ``huggingface-auto`` resolves through the
checkpoint's ``config.json`` and warns when it falls back. The other
families (roformer, longformer, zen1),
``--offload_params`` / ``--offload_optimizer`` and ``--dataset_name`` (a
``datasets.load_dataset`` download) raise ``NotImplementedError``
naming their ROADMAP.md queue item.

Port differences: the model drops out with the per-step generator the
Trainer hands the module (``ops/dropout.py``), so a resumed run replays
its masks; the tokenizer is the caller's, or
``transformers.AutoTokenizer`` of ``--pretrained_model_path`` (imported
there only); ``--monitor`` ranks the checkpoints as Lightning's
``ModelCheckpoint`` does, and after the fit the prediction runs on the
best monitored checkpoint, the one ``--do_predict_only`` restores
(``utils/universal_checkpoint.py``).

Run (on the card; ``--device cpu`` for the CPU), as the AFQMC shell:
    python -m fengshen_tpu_torch.examples.classification.\\
finetune_classification \\
        --pretrained_model_path <erlangshen-dir> \\
        --model_type huggingface-megatron_bert --data_dir <afqmc-dir> \\
        --train_batchsize 8 --valid_batchsize 32 --max_length 128 \\
        --texta_name sentence1 --textb_name sentence2 \\
        --learning_rate 1e-5 --weight_decay 1e-2 --warmup 0.01 \\
        --monitor val_acc --mode max --save_top_k 3 \\
        --every_n_train_steps 0 --save_weights_only True \\
        --dirpath ckpt --filename 'model-{epoch:02d}-{val_acc:.4f}' \\
        --gradient_clip_val 1.0 --val_check_interval 100 \\
        --output_save_path predict.json
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.layers import init_weights, place
from fengshen_tpu_torch.parallel.cross_entropy import stable_cross_entropy
from fengshen_tpu_torch.trainer.module import TrainModule

logger = logging.getLogger("fengshen_tpu_torch.classification")

_NOT_PORTED = "is not yet ported in fengshen_tpu_torch"

#: model_type -> (family module, config class, encoder class); None for
#: a family the port does not have yet (:54-71)
model_dict: dict = {
    "huggingface-bert": ("fengshen_tpu_torch.models.bert", "BertConfig",
                         "BertModel"),
    "huggingface-megatron_bert": ("fengshen_tpu_torch.models.megatron_bert",
                                  "MegatronBertConfig",
                                  "MegatronBertModel"),
    "fengshen-roformer": None,
    "fengshen-megatron_t5": ("fengshen_tpu_torch.models.t5", "T5Config",
                             "T5EncoderModel"),
    "fengshen-longformer": None,
    "fengshen-zen1": None,
    "fengshen-bart": ("fengshen_tpu_torch.models.bart", "BartConfig",
                      "BartModel"),
}

#: config.json model_type -> model_dict key, for ``huggingface-auto``
_AUTO_TYPES = {
    "bert": "huggingface-bert",
    "roberta": "huggingface-bert",
    "megatron-bert": "huggingface-megatron_bert",
    "roformer": "fengshen-roformer",
    "longformer": "fengshen-longformer",
    "t5": "fengshen-megatron_t5",
    "zen": "fengshen-zen1",
    "bart": "fengshen-bart",
}


def resolve_model_type(model_type: str, pretrained_path: str) -> str:
    """``huggingface-auto`` reads the checkpoint's ``config.json``
    ``model_type`` (:87); an unreadable config or an unknown type falls
    back to MegatronBert with a warning."""
    if model_type != "huggingface-auto":
        return model_type
    cfg_file = os.path.join(pretrained_path, "config.json") \
        if os.path.isdir(pretrained_path) else pretrained_path
    try:
        with open(cfg_file) as f:
            raw = json.load(f)
        key = raw.get("fengshen_model_type", raw.get("model_type", "bert"))
    except (OSError, json.JSONDecodeError) as e:
        logger.warning(
            "huggingface-auto could not read %s (%s); assuming a "
            "MegatronBert-family checkpoint — pass --model_type "
            "explicitly if that is wrong", cfg_file, e)
        key = "megatron-bert"
    if key not in _AUTO_TYPES:
        logger.warning(
            "huggingface-auto: unknown model_type %r in %s; assuming a "
            "MegatronBert-family checkpoint", key, cfg_file)
    return _AUTO_TYPES.get(key, "huggingface-megatron_bert")


def _family(model_type: str):
    """``(module, config class, encoder class)`` of ``model_type``."""
    if model_type not in model_dict:
        raise KeyError(f"unknown --model_type {model_type!r}; known: "
                       f"{sorted(model_dict)}")
    entry = model_dict[model_type]
    if entry is None:
        raise NotImplementedError(
            f"--model_type {model_type} {_NOT_PORTED} (ROADMAP.md queue "
            "1 item 11: the rest of the zoo)")
    mod_name, cfg_name, enc_name = entry
    mod = importlib.import_module(mod_name)
    return mod, getattr(mod, cfg_name), getattr(mod, enc_name)


# -- data -----------------------------------------------------------------

class TaskDataset:
    """A jsonl split with configurable field names (:122): rows of
    ``{texta, textb, label id, id}``."""

    def __init__(self, data_path: str, args, label2id: dict):
        self.args = args
        self.label2id = label2id
        self.data = self.load_data(data_path, args)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        return self.data[index]

    def load_data(self, data_path: str, args) -> list:
        samples = []
        with open(data_path, "r", encoding="utf8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                data = json.loads(line)
                text_id = int(data[args.id_name]) \
                    if args.id_name in data else 0
                texta = data.get(args.texta_name, "")
                textb = data.get(args.textb_name, "")
                label = self.label2id[data[args.label_name]] \
                    if args.label_name in data else 0
                samples.append({args.texta_name: texta,
                                args.textb_name: textb,
                                args.label_name: label, "id": text_id})
        return samples


@dataclass
class TaskCollator:
    """Pair encoding, decided per sample (:157-213): a row with both
    texts is a pair, any other row a single text; every row is padded to
    ``--max_length``, so the two groups reassemble by index. RoFormer
    would take ``texta<eos>textb`` as one sequence. The batch is numpy
    int32, as the reference's."""

    args: Any = None
    tokenizer: Any = None

    def __call__(self, samples: list) -> dict:
        args, tok = self.args, self.tokenizer
        texta = [s[args.texta_name] for s in samples]
        textb = [s[args.textb_name] for s in samples]
        pair_idx = [i for i, (a, b) in enumerate(zip(texta, textb))
                    if a != "" and b != ""]
        single_idx = [i for i in range(len(samples)) if i not in pair_idx]

        def encode_pairs(idx):
            a = [texta[i] for i in idx]
            b = [textb[i] for i in idx]
            if args.model_type != "fengshen-roformer":
                return tok(a, b, max_length=args.max_length,
                           padding="max_length",
                           truncation="longest_first",
                           return_tensors="np")
            sep = tok.eos_token or tok.sep_token or ""
            return tok([x + sep + y for x, y in zip(a, b)],
                       max_length=args.max_length, padding="max_length",
                       truncation=True, return_tensors="np")

        def encode_singles(idx):
            return tok([texta[i] for i in idx],
                       max_length=args.max_length, padding="max_length",
                       truncation=True, return_tensors="np")

        parts = []
        if pair_idx:
            parts.append((pair_idx, encode_pairs(pair_idx)))
        if single_idx:
            parts.append((single_idx, encode_singles(single_idx)))
        keys = set().union(*(e.keys() for _, e in parts))
        batch = {}
        for key in ("input_ids", "attention_mask", "token_type_ids"):
            if key not in keys:
                continue
            out = np.zeros((len(samples), args.max_length), np.int32)
            for idx, enc in parts:
                if key in enc:
                    out[idx] = np.asarray(enc[key]).astype(np.int32)
            batch[key] = out
        batch["labels"] = np.asarray(
            [int(s[args.label_name]) for s in samples], np.int32)
        batch["id"] = np.asarray([int(s["id"]) for s in samples], np.int32)
        return batch


class TaskDataModel:
    """The task datamodule (:240): train, validation and test splits of
    ``--data_dir``, the label schema of the train split, and loaders over
    the reference's ``_SimpleBatchSampler`` (train shuffled per epoch
    with its tail dropped; validation and prediction in order, every
    row kept). ``tokenizer`` defaults to ``--pretrained_model_path``'s,
    through ``transformers.AutoTokenizer``."""

    @staticmethod
    def add_data_specific_args(parent_args: argparse.ArgumentParser):
        parser = parent_args.add_argument_group("TASK NAME DataModel")
        parser.add_argument("--data_dir", default="./data", type=str)
        parser.add_argument("--num_workers", default=8, type=int)
        parser.add_argument("--train_data", default="train.json", type=str)
        parser.add_argument("--valid_data", default="dev.json", type=str)
        parser.add_argument("--test_data", default="test.json", type=str)
        parser.add_argument("--train_batchsize", default=16, type=int)
        parser.add_argument("--valid_batchsize", default=32, type=int)
        parser.add_argument("--max_length", default=128, type=int)
        parser.add_argument("--texta_name", default="text", type=str)
        parser.add_argument("--textb_name", default="sentence2", type=str)
        parser.add_argument("--label_name", default="label", type=str)
        parser.add_argument("--id_name", default="id", type=str)
        parser.add_argument(
            "--dataset_name", default=None, type=str,
            help="not ported: datasets.load_dataset is a download")
        return parent_args

    def __init__(self, args, tokenizer=None):
        self.args = args
        self.trainer = None  # set by Trainer.fit
        if getattr(args, "dataset_name", None) is not None:
            raise NotImplementedError(
                "--dataset_name loads through datasets.load_dataset, a "
                f"download, and {_NOT_PORTED} (ROADMAP.md queue 1 item 8: "
                "named datasets, local loaders only); pass --data_dir")
        if tokenizer is None:
            from fengshen_tpu_torch.pipelines.text_generation import \
                auto_tokenizer
            tokenizer = auto_tokenizer(args.pretrained_model_path)
        self.tokenizer = tokenizer
        self.collator = TaskCollator(args=args, tokenizer=tokenizer)
        train_path = os.path.join(args.data_dir, args.train_data)
        self.label2id, self.id2label = self.load_schema(train_path, args)
        self.train_data = TaskDataset(train_path, args, self.label2id)
        self.valid_data = TaskDataset(
            os.path.join(args.data_dir, args.valid_data), args,
            self.label2id)
        self.test_data = TaskDataset(
            os.path.join(args.data_dir, args.test_data), args,
            self.label2id)

    def _loader(self, dataset, batch_size: int, shuffle: bool):
        from fengshen_tpu_torch.data.universal_datamodule import (
            DataLoader, _SimpleBatchSampler)
        sampler = _SimpleBatchSampler(
            len(dataset), batch_size, 0, 1, shuffle,
            seed=getattr(self.args, "seed", 42), drop_last=shuffle)
        return DataLoader(dataset, sampler, self.collator,
                          global_batch_size=batch_size)

    def train_dataloader(self):
        return self._loader(self.train_data, self.args.train_batchsize,
                            shuffle=True)

    def val_dataloader(self):
        return self._loader(self.valid_data, self.args.valid_batchsize,
                            shuffle=False)

    def predict_dataloader(self):
        return self._loader(self.test_data, self.args.valid_batchsize,
                            shuffle=False)

    def load_schema(self, data_path: str, args):
        with open(data_path, "r", encoding="utf8") as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return self._schema_from_rows(rows, args)

    @staticmethod
    def _schema_from_rows(rows, args):
        """The labels in first-seen order (:325-343)."""
        label_list: list = []
        for data in rows:
            label = data[args.label_name] if args.label_name in data else 0
            if label not in label_list:
                label_list.append(label)
        label2id = {k: i for i, k in enumerate(label_list)}
        id2label = {i: k for i, k in enumerate(label_list)}
        return label2id, id2label


# -- model ----------------------------------------------------------------

class TaskModel(nn.Module):
    """The encoder (``bert_encoder``) with its pooler (T5: the first
    token; BART: the last real token), then a linear ``cls_layer`` over
    the pooled representation (:345). ``cls_layer`` is a
    flax ``nn.Dense`` with no dtype in the reference: fp32 parameters,
    and the pooled input promoted to fp32, so the logits are fp32.
    ``device=None`` means ``cuda``; the weights are drawn there from
    ``generator`` (``init=False`` leaves them unwritten)."""

    def __init__(self, config, model_type: str, num_labels: int = 2,
                 device=None, generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        _, _, encoder_cls = _family(model_type)
        self.config, self.model_type = config, model_type
        with torch.device("meta"):
            if model_type == "fengshen-megatron_t5":
                self.bert_encoder = encoder_cls(config, device="meta",
                                                init=False)
            elif model_type == "fengshen-bart":
                self.bert_encoder = encoder_cls(config, device="meta",
                                                init=False,
                                                with_decoder=False)
            else:
                self.bert_encoder = encoder_cls(
                    config, add_pooling_layer=True, device="meta",
                    init=False)
            self.cls_layer = nn.Linear(config.hidden_size, num_labels,
                                       dtype=torch.float32)
        place(self, device, None, False, 0.0)
        dev = resolve_device(device)
        if init and dev.type != "meta":
            self.init_weights(generator or torch.Generator(
                device=dev).manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        std = getattr(self.config, "initializer_range", 0.02)
        if self.model_type == "fengshen-megatron_t5":
            # T5's own initialisers for the encoder, then the head
            self.bert_encoder.init_weights(generator)
            init_weights(self.cls_layer, generator, std)
        else:
            init_weights(self, generator, std)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        if self.model_type == "fengshen-megatron_t5":
            # the T5 encoder has no pooler: the first token (:358-363)
            encode = self.bert_encoder(
                input_ids, attention_mask=attention_mask,
                deterministic=deterministic, dropout_rng=dropout_rng)[:, 0]
        elif self.model_type == "fengshen-bart":
            # the encoder alone, pooled at the last real token (the eos,
            # as HF's BartForSequenceClassification pools it, :364-375)
            hidden = self.bert_encoder.encode(
                input_ids, attention_mask=attention_mask,
                deterministic=deterministic, dropout_rng=dropout_rng)
            if attention_mask is None:
                last = torch.full((input_ids.shape[0],),
                                  input_ids.shape[1] - 1,
                                  device=input_ids.device)
            else:
                last = (attention_mask.sum(-1) - 1).clamp(min=0)
            encode = hidden[torch.arange(hidden.shape[0],
                                         device=hidden.device), last.long()]
        else:
            _, encode = self.bert_encoder(
                input_ids, attention_mask=attention_mask,
                token_type_ids=token_type_ids, deterministic=deterministic,
                dropout_rng=dropout_rng)
        return self.cls_layer(encode.float())


class ClassificationModule(TrainModule):
    """The LightningModule analog (:398). The model is built on
    ``device`` (None: ``cuda``) when the module is; :meth:`init_params`
    draws its weights, then loads the backbone from
    ``--pretrained_model_path`` when it holds importable weights."""

    def __init__(self, args, config: Optional[Any] = None, device=None):
        super().__init__(args)
        self.model_type = resolve_model_type(
            args.model_type, args.pretrained_model_path)
        _, config_cls, _ = _family(self.model_type)
        if config is None:
            config = config_cls.from_pretrained(args.pretrained_model_path)
        self.config = config
        self.model = TaskModel(config, self.model_type,
                               num_labels=args.num_labels, device=device,
                               init=False)

    @staticmethod
    def add_model_specific_args(parent_args: argparse.ArgumentParser):
        parser = parent_args.add_argument_group("BaseModel")
        parser.add_argument("--num_labels", default=2, type=int)
        parser.add_argument(
            "--offload_params", action="store_true", default=False,
            help="not yet ported (ROADMAP.md queue 1 item 10)")
        from fengshen_tpu_torch.trainer.modules import add_lora_args
        add_lora_args(
            parser,
            targets_default=(
                r"(self/(query|key|value)|attention_output_dense)"),
            # the task head is random init: it trains fully
            train_default=r"cls_layer")
        return parent_args

    def init_params(self, generator: torch.Generator) -> nn.Module:
        """Weights drawn from ``generator``, the backbone replaced by the
        checkpoint's when ``--pretrained_model_path`` holds one that
        fits (:449)."""
        self.model.init_weights(generator)
        state = self._import_backbone()
        if state is not None:
            self.model.bert_encoder.load_state_dict(state)
        return self.model

    def _import_backbone(self) -> Optional[dict]:
        """The backbone's state dict through the family's converter (the
        reference's ``.from_pretrained``, :459-499), or None (random init
        kept, and logged) when the path holds no importable weights or
        their names and shapes differ from the encoder's."""
        path = getattr(self.args, "pretrained_model_path", None)
        if not path or not os.path.isdir(path):
            return None
        mod, _, _ = _family(self.model_type)
        try:
            convert = importlib.import_module(mod.__name__ + ".convert")
            from fengshen_tpu_torch.utils.convert_common import (
                load_torch_checkpoint, strip_prefix)
            state = load_torch_checkpoint(path)
            imported = convert.torch_to_params(state, self.config)
        except (FileNotFoundError, KeyError) as e:
            logger.info("no backbone import from %s (%s); random init",
                        path, e)
            return None
        want = {k: tuple(v.shape) for k, v in
                self.model.bert_encoder.state_dict().items()}
        for cand in (strip_prefix(imported, "bert."), imported):
            if {k: tuple(v.shape) for k, v in cand.items()} == want:
                return cand
        logger.warning(
            "imported tree from %s does not match the %s encoder "
            "structure; keeping random init", path, self.model_type)
        return None

    def _apply(self, batch, deterministic: bool):
        return self.model(
            batch["input_ids"], attention_mask=batch.get("attention_mask"),
            token_type_ids=batch.get("token_type_ids"),
            deterministic=deterministic,
            dropout_rng=None if deterministic else self.dropout_generator)

    @staticmethod
    def _loss_and_acc(logits, labels):
        loss, _ = stable_cross_entropy(logits[:, None, :], labels[:, None])
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    def training_loss(self, batch: dict):
        loss, acc = self._loss_and_acc(
            self._apply(batch, deterministic=False), batch["labels"])
        return loss, {"train_acc": acc}

    def validation_loss(self, batch: dict):
        with torch.no_grad():
            loss, acc = self._loss_and_acc(
                self._apply(batch, deterministic=True), batch["labels"])
        return loss, {"val_acc": acc}

    def predict_step(self, batch: dict):
        """``{"id", "logits"}`` of the batch (:525)."""
        return {"id": batch["id"],
                "logits": self._apply(batch, deterministic=True)}

    def flops_per_token(self) -> Optional[float]:
        """6 x the parameters of the matrix products (embedding, position
        and bias tables excluded) plus the attention's 12 x encoder
        layers x hidden x ``--max_length``."""
        cfg = self.config
        tables = ("embeddings", "shared", "embed_positions",
                  "relative_attention_bias")
        n = sum(p.numel() for name, p in self.model.named_parameters()
                if p.dim() >= 2 and not any(t in name for t in tables))
        seq = int(getattr(self.args, "max_length", 128))
        # the encoder's layers: T5's num_layers, BART's encoder_layers
        layers = getattr(cfg, "encoder_layers", None) or \
            getattr(cfg, "num_layers", None) or cfg.num_hidden_layers
        return 6.0 * n + 12.0 * layers * cfg.hidden_size * seq


# -- checkpoint arg surface -------------------------------------------------

def _bool(value: str) -> bool:
    return str(value).lower() in ("true", "1", "yes")


class TaskModelCheckpoint:
    """The reference's checkpoint flags (:553), realised as the port's
    ``UniversalCheckpoint`` (``--dirpath`` is the save and load path;
    ``--save_weights_only`` takes a value, as in the reference's
    shells)."""

    @staticmethod
    def add_argparse_args(parent_args: argparse.ArgumentParser):
        parser = parent_args.add_argument_group("TaskModelCheckpoint")
        parser.add_argument("--monitor", default="train_loss", type=str)
        parser.add_argument("--mode", default="min", type=str)
        parser.add_argument("--dirpath", default="./log/", type=str)
        parser.add_argument(
            "--filename", default="model-{epoch:02d}-{train_loss:.4f}",
            type=str)
        parser.add_argument("--save_top_k", default=3, type=float)
        parser.add_argument("--every_n_train_steps", default=100,
                            type=float)
        parser.add_argument("--save_weights_only", default=True,
                            type=_bool)
        return parent_args

    def __init__(self, args):
        from fengshen_tpu_torch.utils.universal_checkpoint import (
            UniversalCheckpoint)
        args.save_ckpt_path = args.dirpath
        args.load_ckpt_path = args.dirpath
        args.save_top_k = int(args.save_top_k)
        args.every_n_train_steps = int(args.every_n_train_steps or 0)
        args.save_last = False
        args.every_n_epochs = None
        args.save_on_train_epoch_end = None
        self.callbacks = UniversalCheckpoint(args)


# -- predict output --------------------------------------------------------

def save_test(data: list, args, data_model: TaskDataModel,
              rank: int = 0) -> None:
    """Write ``{"id": ..., "label": id2label[argmax]}`` lines to
    ``--output_save_path`` + ``.<rank>`` (:587), each id once (the tail
    batch cycles rows)."""
    file_name = args.output_save_path + f".{rank}"
    written: set = set()
    with open(file_name, "w", encoding="utf-8") as f:
        for out in data:
            ids = _numpy(out["id"]).reshape(-1)
            logits = _numpy(out["logits"])
            for sample_id, sample in zip(ids, logits):
                if int(sample_id) in written:
                    continue
                written.add(int(sample_id))
                label_id = int(np.argmax(sample))
                f.write(json.dumps(
                    {"id": int(sample_id),
                     "label": data_model.id2label[label_id]},
                    ensure_ascii=False) + "\n")
    print("save the result to " + file_name)


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


# -- main ------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    from fengshen_tpu_torch.models.model_utils import add_module_args
    from fengshen_tpu_torch.trainer import add_trainer_args

    total_parser = argparse.ArgumentParser("TASK NAME")
    total_parser.add_argument("--pretrained_model_path", default="",
                              type=str)
    total_parser.add_argument("--output_save_path",
                              default="./predict.json", type=str)
    total_parser.add_argument("--model_type", default="huggingface-bert",
                              type=str)
    total_parser.add_argument(
        "--warmup", default=None, type=float,
        help="legacy alias of --warmup_ratio (the bert-3.9B shells)")
    total_parser.add_argument(
        "--do_predict_only", action="store_true", default=False)
    total_parser = TaskDataModel.add_data_specific_args(total_parser)
    total_parser = add_trainer_args(total_parser)
    total_parser = TaskModelCheckpoint.add_argparse_args(total_parser)
    total_parser = add_module_args(total_parser)
    total_parser = ClassificationModule.add_model_specific_args(
        total_parser)
    return total_parser


def _refuse_unported(args) -> None:
    for flag in ("offload_params", "offload_optimizer"):
        if getattr(args, flag, False):
            raise NotImplementedError(
                f"--{flag} {_NOT_PORTED} (ROADMAP.md queue 1 item 10: "
                "offload)")


def main(argv=None, tokenizer=None):
    """Fit, then predict and write ``--output_save_path``.0 (or, with
    ``--do_predict_only``, restore and predict). Returns the Trainer
    (its ``state`` and logged ``history``). ``tokenizer`` defaults to
    ``--pretrained_model_path``'s."""
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.trainer.modules import maybe_wrap_lora

    args = build_parser().parse_args(argv)
    if args.warmup is not None:
        args.warmup_ratio = args.warmup
    _refuse_unported(args)
    # resolved once, so the collator and the module agree on the family
    args.model_type = resolve_model_type(args.model_type,
                                         args.pretrained_model_path)
    _family(args.model_type)
    # the Trainer first: it resolves the device, which raises without a
    # card unless the CPU is asked for, before anything is loaded
    trainer = Trainer(args)
    data_model = TaskDataModel(args, tokenizer=tokenizer)
    module = maybe_wrap_lora(
        ClassificationModule(args, device=trainer.device), args)
    ckpt = TaskModelCheckpoint(args)
    trainer.callbacks.append(ckpt.callbacks)

    if args.do_predict_only:
        state = trainer.restore_for_predict(module)
    else:
        state = trainer.fit(module, data_model)
        if ckpt.callbacks.best_step() is not None:
            # the best monitored checkpoint predicts, as the one a
            # --do_predict_only run restores
            state = ckpt.callbacks.maybe_restore(state, trainer,
                                                 weights_only=True)
    result = trainer.predict(module, data_model.predict_dataloader(),
                             state=state)
    save_test(result, args, data_model)
    return trainer


if __name__ == "__main__":
    main()
