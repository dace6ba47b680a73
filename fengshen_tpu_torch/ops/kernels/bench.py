"""Kernel-layer bench: the port of ``fengshen_tpu/ops/pallas/bench.py``
(its ``fused_ce`` and ``long_context`` rungs).

    python -m fengshen_tpu_torch.ops.kernels.bench            # on the card
    KERNEL_BENCH_MODE=long_context KERNEL_BENCH_SEQ=64 ... \\
        python -m fengshen_tpu_torch.ops.kernels.bench --device cpu

Prints one JSON row per rung with the reference's fields:

- ``kernel_fused_ce_steps_per_sec``: a gradient step of the fused
  LM-head CE seam (kernel K2 on a card) against the materialised
  ``[B, S, V]`` logits and a log-softmax CE (:168-173). ``vs_baseline``
  = fused / materialised.
- ``long_context_tokens_per_sec``: ``configs/long_context_32k.json``
  through ``Trainer.fit`` and ``CausalLMModule`` (ring attention, which
  on one device is flash attention, K1; remat ``dots_no_batch``; the
  fused LM-head CE, K2). ``sequence_parallel`` is 1: the port has no
  mesh.

``kernel`` is the dispatch the rung's tensors took (``cuda`` or
``plain``) and ``backend`` the torch device type. The env knobs are the
reference's (``KERNEL_BENCH_*``): MODE (fused_ce | long_context | all),
BATCH, ITERS, STEPS, SEQ, HIDDEN, INTER, LAYERS, HEADS, KV, VOCAB,
FUSED_CE, DTYPE, CONFIG. SP other than 1 is refused. The reference's
``decode`` rung is not ported here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

CONFIG_PATH = Path(__file__).resolve().parents[3] / "configs" / \
    "long_context_32k.json"


def _env(name: str, default: int) -> int:
    return int(os.environ.get(f"KERNEL_BENCH_{name}", default))


def _seconds_per_call(fn, iters: int, device: torch.device) -> float:
    """Host seconds per call, one warm-up call first, synchronised."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def bench_fused_ce(device=None) -> dict:
    """Fused LM-head CE gradient step against materialised-logits CE."""
    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.ops.kernels import kernel_choice
    from fengshen_tpu_torch.ops.kernels.fused_ce import fused_ce_loss

    dev = resolve_device(device)
    batch, seq = _env("BATCH", 4), _env("SEQ", 512)
    hidden_dim, vocab = _env("HIDDEN", 256), _env("VOCAB", 2048)
    iters = _env("ITERS", 10)
    rng = np.random.RandomState(1)
    hidden = torch.tensor(rng.randn(batch, seq, hidden_dim) * 0.05,
                          dtype=torch.float32, device=dev)
    head = torch.tensor(rng.randn(hidden_dim, vocab) * 0.05,
                        dtype=torch.float32, device=dev, requires_grad=True)
    labels = torch.tensor(rng.randint(0, vocab, (batch, seq)),
                          dtype=torch.long, device=dev)

    def fused():
        return torch.autograd.grad(fused_ce_loss(hidden, head, labels)[0],
                                   head)

    def materialized():
        logits = hidden @ head                   # the full [B, S, V]
        logp = torch.log_softmax(logits.float(), dim=-1)
        gold = torch.gather(logp, -1, labels[..., None])
        return torch.autograd.grad(-gold.mean(), head)

    fused_s = _seconds_per_call(fused, iters, dev)
    naive_s = _seconds_per_call(materialized, iters, dev)
    return {
        "metric": "kernel_fused_ce_steps_per_sec",
        "value": round(1.0 / fused_s, 2),
        "unit": "steps/s",
        "vs_baseline": round(naive_s / fused_s, 4),
        "kernel": kernel_choice("fused_ce_fwd", hidden),
        "backend": dev.type,
        "tokens": batch * seq, "vocab": vocab,
    }


def long_context_config(path: Optional[str] = None):
    """The long-context config with the ``KERNEL_BENCH_*`` width
    overrides applied (never the attention path), as the reference's
    rung does."""
    from fengshen_tpu_torch.models.llama import LlamaConfig
    config = LlamaConfig.from_pretrained(
        path or os.environ.get("KERNEL_BENCH_CONFIG", str(CONFIG_PATH)))
    overrides = {
        "max_position_embeddings": _env(
            "SEQ", config.max_position_embeddings),
        "hidden_size": _env("HIDDEN", config.hidden_size),
        "intermediate_size": _env("INTER", config.intermediate_size),
        "num_hidden_layers": _env("LAYERS", config.num_hidden_layers),
        "num_attention_heads": _env("HEADS", config.num_attention_heads),
        "num_key_value_heads": _env("KV", config.num_key_value_heads),
        "vocab_size": _env("VOCAB", config.vocab_size),
        "fused_ce_chunks": _env("FUSED_CE", config.fused_ce_chunks),
    }
    if os.environ.get("KERNEL_BENCH_DTYPE"):
        overrides["dtype"] = os.environ["KERNEL_BENCH_DTYPE"]
        overrides["param_dtype"] = os.environ["KERNEL_BENCH_DTYPE"]
    config = dataclasses.replace(config, **overrides)
    if config.hidden_size % config.num_attention_heads:
        raise ValueError("KERNEL_BENCH_HEADS must divide "
                         "KERNEL_BENCH_HIDDEN")
    config.multiple_of = min(config.multiple_of, config.hidden_size)
    return config


def long_context_args(root: str, steps: int, batch: int, device):
    """The rung's Trainer flags (the reference's, plus ``--device``)."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.model_utils import add_module_args
    from fengshen_tpu_torch.trainer import add_trainer_args
    sp = _env("SP", 1)
    if sp != 1:
        raise NotImplementedError(
            f"KERNEL_BENCH_SP={sp}: context parallelism is not yet ported "
            "(ROADMAP.md queue 1 item 9); the port runs one device")
    parser = argparse.ArgumentParser()
    add_module_args(parser)
    add_trainer_args(parser)
    UniversalDataModule.add_data_specific_args(parser)
    return parser.parse_args([
        "--max_steps", str(steps), "--train_batchsize", str(batch),
        "--data_parallel_size", "1", "--fsdp_parallel_size", "1",
        "--sequence_parallel_size", str(sp),
        "--tensor_model_parallel_size", "1",
        "--log_every_n_steps", "1", "--warmup_steps", "1",
        "--default_root_dir", root, "--device", str(device)])


def long_context_rows(vocab: int, seq: int, n: int) -> list:
    """The rung's training rows: ``n`` random ``input_ids`` rows from
    numpy seed 2, as the reference makes them."""
    rng = np.random.RandomState(2)
    return [{"input_ids": rng.randint(0, vocab - 1, seq).tolist()}
            for _ in range(n)]


def long_context_fit(config=None, device=None, root: Optional[str] = None,
                     pretrained_state: Optional[dict] = None,
                     steps: Optional[int] = None,
                     batch: Optional[int] = None):
    """``Trainer.fit`` of the long-context rung (``steps`` and ``batch``
    default to ``KERNEL_BENCH_STEPS`` / ``_BATCH``). Returns ``(trainer,
    state, module, elapsed_s)``; ``pretrained_state`` replaces the
    seeded initial weights (the tests hand it the JAX package's)."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.models.llama import LlamaForCausalLM
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.trainer.modules import CausalLMModule

    dev = resolve_device(device)
    config = config or long_context_config()
    batch = batch or _env("BATCH", 1)
    steps = steps or _env("STEPS", 2)
    root = root or tempfile.mkdtemp(prefix="fstpu_torch_kernel_bench_")
    args = long_context_args(root, steps, batch, dev)
    rows = long_context_rows(config.vocab_size,
                             config.max_position_embeddings,
                             batch * (steps + 1))
    trainer = Trainer(args)
    module = CausalLMModule(args, LlamaForCausalLM(config, device=dev),
                            config)
    module.pretrained_state = pretrained_state
    data = UniversalDataModule(args=args, datasets={"train": rows})
    t0 = time.perf_counter()
    state = trainer.fit(module, data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return trainer, state, module, time.perf_counter() - t0


def bench_long_context(device=None) -> dict:
    """The 32k long-context trainer config through the port's Trainer on
    one device."""
    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.ops.kernels import kernel_choice

    dev = resolve_device(device)
    config = long_context_config()
    trainer, state, module, elapsed = long_context_fit(config, dev)
    seq = config.max_position_embeddings
    # steady-state tokens/s from the trainer's windowed metric (step 1
    # left out); the wall clock for runs too short to have one
    tps = [e["tokens_per_sec"] for e in trainer.history
           if "tokens_per_sec" in e][1:]
    value = float(np.mean(tps)) if tps else \
        state.step * _env("BATCH", 1) * seq / elapsed
    return {
        "metric": "long_context_tokens_per_sec",
        "value": round(value, 1),
        "unit": "tokens/s",
        "vs_baseline": 1.0,
        "kernel": kernel_choice("flash_attention_fwd",
                                module.model.lm_head.weight),
        "backend": dev.type,
        "seq": seq, "attention_impl": config.attention_impl,
        "sequence_parallel": 1,
    }


_RUNGS = {
    "fused_ce": bench_fused_ce,
    "long_context": bench_long_context,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="default cuda (raises without a card)")
    opts = parser.parse_args(argv)
    mode = os.environ.get("KERNEL_BENCH_MODE", "all")
    names = list(_RUNGS) if mode == "all" else [mode]
    unknown = [n for n in names if n not in _RUNGS]
    if unknown:
        print(f"kernel-bench: unknown KERNEL_BENCH_MODE {mode!r} "
              f"(expected {'|'.join(_RUNGS)}|all)", file=sys.stderr)
        return 2
    for name in names:
        row = _RUNGS[name](opts.device)
        if os.environ.get("BENCH_DEGRADED", "0") == "1":
            row["degraded"] = True
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
