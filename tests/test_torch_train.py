"""The port's training slice against the JAX package, on the CPU.

``Trainer.fit`` of both packages runs the Ziya SFT path (``LlamaSFTCollator``
-> ``UniversalDataModule`` -> ``CausalLMModule`` -> LLaMA with
``attention_impl="flash"``, gradient checkpointing and the scan layout ->
CE -> AdamW with clipping) on a tiny fp32 LLaMA (2 layers, hidden 64,
GQA 4/2, sequences of 32) for 3 steps, the JAX one on a one-device mesh.
Both start from the JAX package's initial parameters and read the same
batches (the samplers are numpy, seeded alike). lr 1e-2, so every update
moves the parameters by ~1e-2.

Tolerances (fp32; the two differ by reduction order, ~1e-7 relative):
loss per step rtol 1e-5; step-1 gradients atol 1e-6 + rtol 1e-4;
parameters after 3 steps: 99.9 % of the elements of every tensor within
2e-6 (a five-thousandth of one update), and every element within 1e-4
(a hundredth of one update). Adam divides each gradient by its running
RMS, so an element whose gradient is ~1e-8 (against a median of ~1e-3)
turns a 1e-7 rounding difference into a few 1e-5 of update; any wrong
term of the update moves far more than 1e-4, and moves most elements.

Both fits also validate at the end of their epoch (the per-epoch
schedule) on the same validation split; the LoRA fits below validate on
crossing step 2.

The second half holds the slice of PR 15 to the JAX package: LoRA
(``LoraTrainModule`` on a ``{'base', 'lora'}`` two-tree carried across:
merged kernels, step-1 loss and adapter gradients, adapters after 3
steps, validation on crossing); and the port's own checkpoint,
preemption and rewind paths
(kill-and-resume bitwise equal to the uninterrupted run, whose losses
match the JAX Trainer's).

Hygiene: the JAX Trainer and the port's both install a process-wide
SIGTERM handler, and the JAX one a process-global mesh; the fixtures
save them (and the environment) and restore them, run with
``default_root_dir`` under a temp dir and no metrics server, and torch
runs on one intra-op thread.
"""

import argparse
import copy
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.examples.ziya_llama import finetune_ziya_llama as port_sft
from fengshen_tpu_torch.models import model_utils as port_utils
from fengshen_tpu_torch.models.llama import (LlamaConfig, lora_from_jax,
                                             params_from_jax,
                                             params_to_numpy)
from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
from fengshen_tpu_torch.trainer import Trainer
from fengshen_tpu_torch.trainer import trainer as port_trainer
from fengshen_tpu_torch.trainer.modules import maybe_wrap_lora
from fengshen_tpu_torch.utils.universal_checkpoint import UniversalCheckpoint

SEED = 7
CONFIG = dict(dtype="float32", param_dtype="float32", num_key_value_heads=2,
              attention_impl="flash", gradient_checkpointing=True,
              scan_layers=True)


#: the LoRA runs' flags (the reference's defaults otherwise)
LORA_FLAGS = {"--lora_rank": 4, "--lora_alpha": 16,
              "--val_check_interval": 2, "--limit_val_batches": 2}


def _argv(root, **extra):
    flags = {"--train_batchsize": 4, "--val_batchsize": 4,
             "--max_seq_length": 32,
             "--max_steps": 3, "--learning_rate": 1e-2,
             "--warmup_steps": 0, "--warmup_ratio": 0,
             "--weight_decay": 0.1, "--gradient_clip_val": 1.0,
             "--log_every_n_steps": 1, "--seed": SEED,
             "--default_root_dir": str(root), **extra}
    return [str(x) for kv in flags.items() for x in kv]


def _records(n=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = lambda k: " ".join(map(str, rng.randint(3, 250, k)))  # noqa: E731
    return [{"query": ids(rng.randint(2, 8)),
             "answer": ids(rng.randint(2, 12))} for _ in range(n)]


def _val_records():
    return _records(10, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _sigterm_restored():
    """Every port Trainer installs the process-wide SIGTERM handler:
    put the previous handler and the module's state back after each
    test."""
    handler = signal.getsignal(signal.SIGTERM)
    state = dict(port_trainer._SIGTERM_STATE)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_trainer._SIGTERM_STATE.clear()
    port_trainer._SIGTERM_STATE.update(state)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer.fit, its initial params, its step-1 gradients and
    its final params, with every process-global it touches restored."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.data import UniversalDataModule
    from fengshen_tpu.examples.ziya_llama.finetune_ziya_llama import (
        Llama, LlamaSFTCollator)
    from fengshen_tpu.models.llama import LlamaConfig as JaxConfig
    from fengshen_tpu.models.model_utils import add_module_args
    from fengshen_tpu.parallel import MeshConfig, get_mesh, make_mesh, set_mesh
    from fengshen_tpu.trainer import trainer as jax_trainer

    root = tmp_path_factory.mktemp("jax_fit")
    parser = argparse.ArgumentParser()
    add_module_args(parser)
    jax_trainer.add_trainer_args(parser)
    UniversalDataModule.add_data_specific_args(parser)
    Llama.add_module_specific_args(parser)
    args = parser.parse_args(_argv(root))
    cfg = JaxConfig.small_test_config(**CONFIG)

    def one_device_mesh(config=None, devices=None):
        return make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])

    saved_handler = signal.getsignal(signal.SIGTERM)
    saved_state = dict(jax_trainer._SIGTERM_STATE)
    saved_mesh, saved_env = get_mesh(), dict(os.environ)
    threads = set(threading.enumerate())
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trainer, "make_mesh", one_device_mesh)
            module = Llama(args, cfg)
            collator = LlamaSFTCollator(IdTokenizer(), max_seq_length=32)
            data = UniversalDataModule(collate_fn=collator, args=args,
                                       datasets={"train": _records(),
                                                 "validation":
                                                     _val_records()})
            trainer = jax_trainer.Trainer(args)
            params0 = module.init_params(jax.random.PRNGKey(SEED))
            batch0 = next(iter(data.train_dataloader()))
            grad_step = jax.jit(trainer._make_grad_step(module))
            grads0, metrics0 = grad_step(
                params0, jax.tree_util.tree_map(jnp.asarray, batch0),
                jax.random.PRNGKey(SEED), jnp.int32(0))
            state = trainer.fit(module, data)
    finally:
        signal.signal(signal.SIGTERM, saved_handler)
        jax_trainer._SIGTERM_STATE.clear()
        jax_trainer._SIGTERM_STATE.update(saved_state)
        set_mesh(saved_mesh)
        os.environ.clear()
        os.environ.update(saved_env)
    assert set(threading.enumerate()) <= threads
    with open(root / "metrics.jsonl") as f:
        entries = [json.loads(line) for line in f]
    losses = [e["loss"] for e in entries if "loss" in e]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params0=to_np(params0), batch0=batch0,
                grads0=to_np(grads0), loss0=float(metrics0["loss"]),
                grad_norm0=float(metrics0["grad_norm"]), losses=losses,
                params=to_np(state.params), step=int(state.step),
                val=[e for e in entries if "val_loss" in e])


def _port_module(jax_run, tmp_path, **extra):
    args = port_sft.parse_args(_argv(tmp_path, **{"--device": "cpu",
                                                  **extra}))
    cfg = LlamaConfig.small_test_config(**CONFIG)
    module = port_sft.Llama(args, cfg, device="cpu")
    module.pretrained_state = params_from_jax(jax_run["params0"], cfg)
    return args, cfg, module


def _datamodule(args):
    from fengshen_tpu_torch.data import UniversalDataModule
    collator = port_sft.LlamaSFTCollator(IdTokenizer(), max_seq_length=32)
    return UniversalDataModule(collate_fn=collator, args=args,
                               datasets={"train": _records(),
                                         "validation": _val_records()})


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    args, cfg, module = _port_module(jax_run,
                                     tmp_path_factory.mktemp("port_fit"))
    trainer = Trainer(args)
    state = trainer.fit(module, _datamodule(args))
    return trainer, state, cfg


def test_fit_loss_per_step_matches_jax(jax_run, port_run):
    trainer, state, _ = port_run
    losses = [e["loss"] for e in trainer.history if "loss" in e]
    assert jax_run["step"] == state.step == 3 and state.bad_step_count == 0
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    assert losses[0] == pytest.approx(jax_run["loss0"], rel=1e-5)


def test_step1_grads_match_jax(jax_run, tmp_path):
    args, cfg, module = _port_module(jax_run, tmp_path)
    trainer = Trainer(args)
    module.init_params(torch.Generator().manual_seed(0))
    batch = trainer._to_device(jax_run["batch0"])
    metrics = trainer._make_grad_step(module)(batch)
    assert float(metrics["loss"]) == pytest.approx(jax_run["loss0"],
                                                   rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        jax_run["grad_norm0"], rel=1e-5)
    want = params_from_jax(jax_run["grads0"], cfg)
    got = {n: p.grad for n, p in module.model.named_parameters()}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)


def test_params_after_three_steps_match_jax(jax_run, port_run):
    _, state, cfg = port_run
    got = params_to_numpy(state.model.state_dict(), cfg)
    import jax
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax_run["params"]))
    assert flat_got.keys() == flat_want.keys()
    initial = dict(jax.tree_util.tree_leaves_with_path(jax_run["params0"]))
    moved = 0.0
    for path, want in flat_want.items():
        diff = np.abs(flat_got[path] - want)
        name = jax.tree_util.keystr(path)
        assert np.quantile(diff, 0.999) <= 2e-6, name
        np.testing.assert_allclose(flat_got[path], want, atol=1e-4,
                                   err_msg=name)
        moved = max(moved, float(np.abs(want - initial[path]).max()))
    assert moved > 1e-2       # the updates show


def test_collator_matches_jax():
    from fengshen_tpu.examples.ziya_llama.finetune_ziya_llama import (
        LlamaSFTCollator as JaxCollator)
    tok = IdTokenizer()
    eos_tok = copy.copy(tok)
    eos_tok.eos_token_id = 2
    samples = _records(5, seed=3) + [{"query": " 9 " * 20,
                                      "answer": "4 " * 30}]
    for t in (tok, eos_tok):
        want = JaxCollator(t, max_seq_length=24)(samples)
        got = port_sft.LlamaSFTCollator(t, max_seq_length=24)(samples)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_decay_mask_matches_jax(jax_run):
    import jax

    from fengshen_tpu.models.model_utils import decay_mask_fn
    from fengshen_tpu_torch.models.llama import LlamaForCausalLM
    cfg = LlamaConfig.small_test_config(**{**CONFIG, "scan_layers": False})
    model = LlamaForCausalLM(cfg, device="cpu")
    jax_params = params_to_numpy(model.state_dict(), cfg)
    want = {}
    for path, keep in jax.tree_util.tree_leaves_with_path(
            decay_mask_fn(jax_params)):
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        name = name.replace("layers_", "layers.")
        for leaf in ("kernel", "embedding", "scale"):
            name = name.replace(leaf, "weight")
        want[name] = bool(keep)
    assert port_utils.decay_mask_fn(model) == want
    assert sum(want.values()) == 2 + 7 * cfg.num_hidden_layers


@pytest.mark.parametrize("stype", ["polynomial", "constant", "cosine",
                                   "inverse_sqrt", "constant_with_warmup",
                                   "direct"])
def test_schedule_matches_jax(stype):
    import argparse

    from fengshen_tpu.models.model_utils import get_scheduler
    args = argparse.Namespace(learning_rate=3e-4, warmup_steps=4,
                              warmup_ratio=0.1, lr_decay_steps=0,
                              min_learning_rate=1e-6, scheduler_type=stype,
                              warmup_min_lr=1e-8, warmup_max_lr=3e-4)
    want, got = get_scheduler(args, 20), port_utils.get_scheduler(args, 20)
    # optax evaluates in fp32 (relative rounding ~1e-7 of the peak rate);
    # the port in fp64
    for step in range(0, 25):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-6 * args.learning_rate), step


def test_trainer_refuses_unported_flags_and_installs_no_handler(tmp_path):
    """The mesh, offload, ``steps_per_execution`` and AOT flags raise,
    naming their queue item; ``--metrics_port`` and ``--profile_steps``
    run. The Trainer installs one process-wide SIGTERM handler that
    chains the previous one: a second Trainer re-points it and stacks
    nothing. ``fused_ce_chunks`` trains on the CPU (the fused head + CE
    gives the logits path's loss and gradients); over a tensor degree
    above 1 it raises."""
    for flag, value, item in (
            ("--tensor_model_parallel_size", 2, "item 9"),
            ("--offload", "opt", "item 10"),
            ("--steps_per_execution", 2, "item 1"),
            ("--aot_cache_dir", str(tmp_path), "item 10")):
        args = port_sft.parse_args(_argv(tmp_path, **{"--device": "cpu",
                                                      flag: value}))
        with pytest.raises(NotImplementedError, match=item):
            Trainer(args)
    calls = []

    def previous(signum, frame):
        calls.append(signum)

    signal.signal(signal.SIGTERM, previous)
    port_trainer._SIGTERM_STATE.update(handler=None, prev=None, ref=None)
    first = Trainer(port_sft.parse_args(_argv(tmp_path, **{
        "--device": "cpu", "--metrics_port": 0,
        "--profile_steps": "1,2"})))
    handler = signal.getsignal(signal.SIGTERM)
    assert handler is port_trainer._SIGTERM_STATE["handler"]
    assert port_trainer._SIGTERM_STATE["prev"] is previous
    second = Trainer(port_sft.parse_args(_argv(tmp_path, **{
        "--device": "cpu"})))
    assert signal.getsignal(signal.SIGTERM) is handler
    assert port_trainer._SIGTERM_STATE["prev"] is previous
    handler(signal.SIGTERM, None)
    assert second._preempted and not first._preempted
    assert calls == [signal.SIGTERM]
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        3, 250, (2, 12))).long()
    args = port_sft.parse_args(_argv(tmp_path))
    results = []
    for chunks in (0, 2):
        cfg = LlamaConfig.small_test_config(**{**CONFIG,
                                               "fused_ce_chunks": chunks})
        module = port_sft.Llama(args, cfg, device="cpu")
        module.init_params(torch.Generator().manual_seed(0))
        loss, metrics = module.training_loss({"input_ids": ids})
        loss.backward()
        results.append((loss.detach(), metrics, {
            n: p.grad for n, p in module.model.named_parameters()}))
    (loss0, m0, g0), (loss2, m2, g2) = results
    assert torch.isfinite(loss2)
    torch.testing.assert_close(loss2, loss0, rtol=1e-6, atol=0)
    assert int(m2["n_tokens"]) == int(m0["n_tokens"]) == 22
    torch.testing.assert_close(m2["acc"].float(), m0["acc"].float())
    for name, g in g0.items():
        torch.testing.assert_close(g2[name], g, rtol=1e-5, atol=1e-7)
    with pytest.raises(NotImplementedError, match="tensor"):
        args = port_sft.parse_args(_argv(tmp_path, **{
            "--tensor_model_parallel_size": 2}))
        module = port_sft.Llama(args, cfg, device="cpu")
        module.training_loss({"input_ids": ids})


def test_guard_skips_a_non_finite_step(jax_run, tmp_path):
    """A step with a NaN loss leaves parameters, moments and the
    schedule untouched and counts one bad step; the next step applies."""
    args, cfg, module = _port_module(jax_run, tmp_path)
    real_loss = module.training_loss
    calls = []

    def poisoned(batch):
        loss, metrics = real_loss(batch)
        calls.append(1)
        return (loss * float("nan") if len(calls) == 2 else loss), metrics

    module.training_loss = poisoned
    seen = []

    class Probe(Trainer):
        def _make_update_applier(self):
            apply = super()._make_update_applier()

            def wrapped(state, metrics):
                before = {n: p.detach().clone()
                          for n, p in state.model.named_parameters()}
                lr = state.optimizer.param_groups[0]["lr"]
                state, metrics = apply(state, metrics)
                after = {n: p.detach().clone()
                         for n, p in state.model.named_parameters()}
                seen.append((before, lr,
                             state.optimizer.param_groups[0]["lr"], after))
                return state, metrics

            return wrapped

    state = Probe(args).fit(module, _datamodule(args))
    assert state.step == 3 and state.bad_step_count == 1
    before, lr_before, lr_after, after = seen[1]
    for name, p in after.items():
        torch.testing.assert_close(p, before[name], rtol=0, atol=0)
    assert lr_before == lr_after
    assert any(not torch.equal(seen[2][3][n], seen[2][0][n]) for n in before)


def test_main_runs_the_sft_path_from_files(tmp_path):
    """``main`` end to end on the CPU: a config directory, a jsonl train
    file, the IdTokenizer stand-in passed in; loss logged per step,
    finite; without ``--every_n_train_steps`` the checkpoint callback
    saves the last step."""
    cfg = LlamaConfig.small_test_config(**CONFIG)
    cfg.save_pretrained(str(tmp_path / "model"))
    with open(tmp_path / "sft.jsonl", "w") as f:
        for r in _records(8):
            f.write(json.dumps(r) + "\n")
    ckpt = tmp_path / "ckpt"
    trainer = port_sft.main(_argv(
        tmp_path / "runs", **{"--device": "cpu",
                              "--model_path": tmp_path / "model",
                              "--train_file": tmp_path / "sft.jsonl",
                              "--save_ckpt_path": ckpt,
                              "--load_ckpt_path": ckpt,
                              "--max_steps": 2}), tokenizer=IdTokenizer())
    losses = [e["loss"] for e in trainer.history if "loss" in e]
    assert len(losses) == 2 and np.isfinite(losses).all()
    lines = (tmp_path / "runs" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["event"] == "fit_end"
    assert sorted(os.listdir(ckpt)) == ["2"]


def test_datamodule_reads_json_and_jsonl_and_refuses_other_splits(tmp_path):
    """The local-file branch reads a JSON array or JSON lines with the
    stdlib; the train batches follow the reference's seeded sampler and
    the validation split's batches the reference's in-order loader; the
    test split is refused (not yet ported)."""
    from fengshen_tpu.data import UniversalDataModule as JaxDataModule
    from fengshen_tpu_torch.data import UniversalDataModule
    records = _records(8, seed=1)
    (tmp_path / "a.json").write_text(json.dumps(records))
    (tmp_path / "b.jsonl").write_text(
        "\n".join(json.dumps(r) for r in records) + "\n")
    collator = port_sft.LlamaSFTCollator(IdTokenizer(), max_seq_length=16)
    for name in ("a.json", "b.jsonl"):
        want = JaxDataModule(collate_fn=collator, args=port_sft.parse_args(
            _argv(tmp_path)), datasets={"train": records}).train_dataloader()
        args = port_sft.parse_args(_argv(tmp_path, **{
            "--train_file": tmp_path / name}))
        loader = UniversalDataModule(collate_fn=collator,
                                     args=args).train_dataloader()
        assert loader.num_samples == 8 and loader.global_batch_size == 4
        for got, ref in zip(loader, want):
            np.testing.assert_array_equal(got["input_ids"],
                                          ref["input_ids"])
    args = port_sft.parse_args(_argv(tmp_path, **{
        "--train_file": tmp_path / "a.json",
        "--val_file": tmp_path / "b.jsonl", "--val_batchsize": 3}))
    got = list(UniversalDataModule(collate_fn=collator,
                                   args=args).val_dataloader())
    want = list(JaxDataModule(collate_fn=collator, args=args, datasets={
        "train": records, "validation": records}).val_dataloader())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
    args = port_sft.parse_args(_argv(tmp_path, **{
        "--train_file": tmp_path / "a.json",
        "--test_file": tmp_path / "a.json"}))
    with pytest.raises(NotImplementedError, match="test"):
        UniversalDataModule(collate_fn=collator, args=args)


def test_accumulated_grad_step_averages_micro_batches(jax_run, tmp_path):
    """``--accumulate_grad_batches 2`` gives the mean of the two
    micro-batches' losses and gradients, as the reference's scan does
    (each micro-batch's CE is its own token mean)."""
    args, cfg, module = _port_module(jax_run, tmp_path, **{
        "--accumulate_grad_batches": 2})
    trainer = Trainer(args)
    module.init_params(torch.Generator().manual_seed(0))
    batch = trainer._to_device(jax_run["batch0"])
    metrics = trainer._make_grad_step(module)(batch)
    got = {n: p.grad.clone() for n, p in module.model.named_parameters()}
    single = Trainer(port_sft.parse_args(_argv(tmp_path, **{
        "--device": "cpu"})))._make_grad_step(module)
    losses, grads = [], []
    for half in range(2):
        m = single({k: v[half * 2:(half + 1) * 2] for k, v in batch.items()})
        losses.append(float(m["loss"]))
        grads.append({n: p.grad.clone()
                      for n, p in module.model.named_parameters()})
    assert float(metrics["loss"]) == pytest.approx(sum(losses) / 2,
                                                   rel=1e-6)
    for name, g in got.items():
        torch.testing.assert_close(g, (grads[0][name] + grads[1][name]) / 2,
                                   rtol=1e-5, atol=1e-7)


# -- validation ---------------------------------------------------------

def test_validation_per_epoch_matches_jax(jax_run, port_run):
    """Both fits end their epoch with one validation sweep (interval 0):
    ``val_loss``, the row-weighted ``val_acc`` and the summed
    ``val_n_tokens`` equal the JAX Trainer's ``_run_validation`` on the
    same weights and batches (fp32, rtol 1e-5)."""
    trainer, _, _ = port_run
    got = [e for e in trainer.history if "val_loss" in e]
    want = jax_run["val"]
    assert len(got) == len(want) == 1
    assert got[0].keys() == want[0].keys()
    assert got[0]["step"] == want[0]["step"] == 3
    for key in ("val_loss", "val_acc"):
        assert got[0][key] == pytest.approx(want[0][key], rel=1e-5), key
    assert got[0]["val_n_tokens"] == want[0]["val_n_tokens"]


# -- LoRA ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_lora_run(tmp_path_factory):
    """The JAX ``LoraTrainModule`` (rank 4, alpha 16, q/k/v/o) over the
    Ziya module: its initial two-tree, step-1 loss and gradients, and a
    3-step ``Trainer.fit`` validating on crossing step 2."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.data import UniversalDataModule
    from fengshen_tpu.examples.ziya_llama.finetune_ziya_llama import (
        Llama, LlamaSFTCollator)
    from fengshen_tpu.models.llama import LlamaConfig as JaxConfig
    from fengshen_tpu.models.model_utils import add_module_args
    from fengshen_tpu.parallel import MeshConfig, get_mesh, make_mesh, set_mesh
    from fengshen_tpu.trainer import trainer as jax_trainer
    from fengshen_tpu.trainer.modules import maybe_wrap_lora as jax_wrap

    root = tmp_path_factory.mktemp("jax_lora")
    parser = argparse.ArgumentParser()
    add_module_args(parser)
    jax_trainer.add_trainer_args(parser)
    UniversalDataModule.add_data_specific_args(parser)
    Llama.add_module_specific_args(parser)
    args = parser.parse_args(_argv(root, **LORA_FLAGS))
    cfg = JaxConfig.small_test_config(**CONFIG)

    def one_device_mesh(config=None, devices=None):
        return make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])

    saved_handler = signal.getsignal(signal.SIGTERM)
    saved_state = dict(jax_trainer._SIGTERM_STATE)
    saved_mesh, saved_env = get_mesh(), dict(os.environ)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trainer, "make_mesh", one_device_mesh)
            module = jax_wrap(Llama(args, cfg), args)
            collator = LlamaSFTCollator(IdTokenizer(), max_seq_length=32)
            data = UniversalDataModule(
                collate_fn=collator, args=args,
                datasets={"train": _records(),
                          "validation": _val_records()})
            trainer = jax_trainer.Trainer(args)
            params0 = module.init_params(jax.random.PRNGKey(SEED))
            batch0 = next(iter(data.train_dataloader()))
            grad_step = jax.jit(trainer._make_grad_step(module))
            grads0, metrics0 = grad_step(
                params0, jax.tree_util.tree_map(jnp.asarray, batch0),
                jax.random.PRNGKey(SEED), jnp.int32(0))
            state = trainer.fit(module, data)
    finally:
        signal.signal(signal.SIGTERM, saved_handler)
        jax_trainer._SIGTERM_STATE.clear()
        jax_trainer._SIGTERM_STATE.update(saved_state)
        set_mesh(saved_mesh)
        os.environ.clear()
        os.environ.update(saved_env)
    with open(root / "metrics.jsonl") as f:
        entries = [json.loads(line) for line in f]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params0=to_np(params0), batch0=batch0,
                grads0=to_np(grads0), loss0=float(metrics0["loss"]),
                grad_norm0=float(metrics0["grad_norm"]),
                losses=[e["loss"] for e in entries if "loss" in e],
                val=[e for e in entries if "val_loss" in e],
                params=to_np(state.params))


def _port_lora_module(jax_lora_run, root, **extra):
    """The port's Ziya module wrapped by ``maybe_wrap_lora``, starting
    from the JAX two-tree (base through ``params_from_jax``, adapters
    through ``lora_from_jax``)."""
    args = port_sft.parse_args(_argv(root, **{
        "--device": "cpu", **LORA_FLAGS, **extra}))
    cfg = LlamaConfig.small_test_config(**CONFIG)
    inner = port_sft.Llama(args, cfg, device="cpu")
    inner.pretrained_state = params_from_jax(jax_lora_run["params0"]["base"],
                                             cfg)
    module = maybe_wrap_lora(inner, args)
    module.pretrained_lora = lora_from_jax(jax_lora_run["params0"]["lora"],
                                           cfg)
    return args, cfg, module


def _adapter_grads(tree, cfg) -> dict:
    return {k: v for k, v in lora_from_jax(tree, cfg).items()
            if not k.endswith("lora_scale")}


@pytest.fixture(scope="module")
def port_lora_run(jax_lora_run, tmp_path_factory):
    args, cfg, module = _port_lora_module(
        jax_lora_run, tmp_path_factory.mktemp("port_lora"))
    trainer = Trainer(args)
    state = trainer.fit(module, _datamodule(args))
    return trainer, state, cfg


def test_lora_merged_kernels_match_jax(jax_lora_run, port_lora_run):
    """Every adapted projection's merged weight (``W + scale * A@B`` in
    fp32, over the trained adapters) equals the JAX ``apply_lora``'s
    kernel, transposed (atol 1e-6: one fp32 product of rank 4)."""
    from fengshen_tpu.ops.lora import apply_lora
    from fengshen_tpu_torch.ops.lora import LoraLinear
    _, state, cfg = port_lora_run
    params = jax_lora_run["params"]
    want = params_from_jax(apply_lora(params["base"], params["lora"]), cfg)
    model = copy.deepcopy(state.model)
    model.load_state_dict({**params_from_jax(params["base"], cfg),
                           **lora_from_jax(params["lora"], cfg)})
    adapted = {n: m for n, m in model.named_modules()
               if isinstance(m, LoraLinear)}
    assert len(adapted) == 4 * cfg.num_hidden_layers
    for name, m in adapted.items():
        with torch.no_grad():
            np.testing.assert_allclose(
                m.merged_weight().numpy(), want[f"{name}.weight"].numpy(),
                atol=1e-6, rtol=0, err_msg=name)


def test_lora_step1_loss_and_adapter_grads_match_jax(jax_lora_run, tmp_path):
    """Step 1 on the carried two-tree: the loss (rtol 1e-5), the global
    grad norm over the trainable tensors (rtol 1e-5) and each adapter's
    gradient (atol 1e-6 + rtol 1e-4) equal the JAX ``LoraTrainModule``'s;
    only ``lora_a`` / ``lora_b`` require gradients, and the optimizer
    holds moments for them alone."""
    args, cfg, module = _port_lora_module(jax_lora_run, tmp_path)
    trainer = Trainer(args)
    model = module.init_params(torch.Generator().manual_seed(0))
    metrics = trainer._make_grad_step(module)(
        trainer._to_device(jax_lora_run["batch0"]))
    assert float(metrics["loss"]) == pytest.approx(jax_lora_run["loss0"],
                                                   rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        jax_lora_run["grad_norm0"], rel=1e-5)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    want = _adapter_grads(jax_lora_run["grads0"]["lora"], cfg)
    assert trainable == set(want)
    for name, p in model.named_parameters():
        if name in want:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       atol=1e-6, rtol=1e-4, err_msg=name)
        else:
            assert p.grad is None, name
    optimizer, _ = module.configure_optimizers(3, model)
    assert sum(len(g["params"]) for g in optimizer.param_groups) == \
        len(want)


def test_lora_fit_matches_jax(jax_lora_run, port_lora_run):
    """Three steps of the LoRA fit against the JAX Trainer's: losses
    (rtol 1e-5), the validation entry of crossing step 2 (rtol 1e-5),
    and the adapters after 3 steps within the full fine-tune's bounds
    (99.9 % of each tensor within 2e-6, all within 1e-4); the base stays
    bitwise what it was."""
    trainer, state, cfg = port_lora_run
    losses = [e["loss"] for e in trainer.history if "loss" in e]
    np.testing.assert_allclose(losses, jax_lora_run["losses"], rtol=1e-5)
    got_val = [e for e in trainer.history if "val_loss" in e]
    assert [e["step"] for e in got_val] == \
        [e["step"] for e in jax_lora_run["val"]] == [2]
    for key in ("val_loss", "val_acc"):
        assert got_val[0][key] == pytest.approx(jax_lora_run["val"][0][key],
                                                rel=1e-5)
    sd = state.model.state_dict()
    want = _adapter_grads(jax_lora_run["params"]["lora"], cfg)
    start = _adapter_grads(jax_lora_run["params0"]["lora"], cfg)
    moved = 0.0
    for name, w in want.items():
        diff = (sd[name] - w).abs().numpy()
        assert np.quantile(diff, 0.999) <= 2e-6, name
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), atol=1e-4,
                                   err_msg=name)
        moved = max(moved, float((w - start[name]).abs().max()))
    assert moved > 1e-3
    base = params_from_jax(jax_lora_run["params0"]["base"], cfg)
    for name, w in base.items():
        assert torch.equal(sd[name], w), name


def test_lora_train_modules_head_trains_and_a_bad_regex_raises(
        jax_lora_run, tmp_path):
    """``--lora_train_modules lm_head`` trains the head fully beside the
    adapters (it requires a gradient and moves in one step; the rest of
    the base does not); a regex that matches no base parameter
    raises."""
    args, cfg, module = _port_lora_module(
        jax_lora_run, tmp_path, **{"--lora_train_modules": "lm_head",
                                   "--max_steps": 1})
    before = params_from_jax(jax_lora_run["params0"]["base"], cfg)
    state = Trainer(args).fit(module, _datamodule(args))
    trainable = sorted(n for n, p in state.model.named_parameters()
                       if p.requires_grad and "lora" not in n)
    assert trainable == ["lm_head.weight"]
    sd = state.model.state_dict()
    assert not torch.equal(sd["lm_head.weight"], before["lm_head.weight"])
    assert torch.equal(sd["model.norm.weight"], before["model.norm.weight"])
    _, _, bad = _port_lora_module(jax_lora_run, tmp_path, **{
        "--lora_train_modules": "no_such_head"})
    with pytest.raises(ValueError, match="matches no base parameter"):
        bad.init_params(torch.Generator().manual_seed(0))


# -- checkpoints, preemption, rewind ------------------------------------

class _Killed(Exception):
    pass


class _KillAt:
    """A callback that ends the fit as a dying process would, after the
    callbacks before it (the checkpoint) ran at ``step``."""

    def __init__(self, step):
        self.step = step

    def on_train_step_end(self, trainer, state):
        if trainer.global_step == self.step:
            raise _Killed


def _fit(make_module, args, data=None, callbacks=(), plan=None):
    trainer = Trainer(args)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.callbacks.extend(callbacks)
    if plan is not None:
        plan.install(trainer)
    state = trainer.fit(make_module(args), data or _datamodule(args))
    return trainer, state


def _ckpt_flags(path, every=1):
    return {"--save_ckpt_path": path, "--load_ckpt_path": path,
            "--every_n_train_steps": every}


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_kill_and_resume_equals_the_uninterrupted_run(
        jax_run, jax_lora_run, port_run, port_lora_run, kind, tmp_path):
    """A fit killed after its step-2 checkpoint and restored finishes
    bitwise equal to the uninterrupted fit (fp32: parameters, AdamW
    moments and the schedule's position come back exactly; the sampler
    resumes at ``consumed_samples``), full fine-tune and LoRA; the
    resumed step 3 matches the JAX Trainer's uninterrupted run (rtol
    1e-5)."""
    ref_trainer, ref_state, _ = port_run if kind == "full" else port_lora_run
    jax_losses = (jax_run if kind == "full" else jax_lora_run)["losses"]
    extra = {} if kind == "full" else LORA_FLAGS

    def make_module(args):
        if kind == "full":
            return _port_module(jax_run, tmp_path, **{
                "--device": "cpu"})[2]
        return _port_lora_module(jax_lora_run, tmp_path)[2]

    args = port_sft.parse_args(_argv(tmp_path, **{
        "--device": "cpu", **extra, **_ckpt_flags(tmp_path / "ckpt")}))
    with pytest.raises(_Killed):
        _fit(make_module, args, callbacks=[_KillAt(2)])
    trainer, state = _fit(make_module, args)
    losses = {e["step"]: e["loss"] for e in trainer.history if "loss" in e}
    ref = {e["step"]: e["loss"] for e in ref_trainer.history
           if "loss" in e}
    assert sorted(losses) == [3] and losses[3] == ref[3]
    assert losses[3] == pytest.approx(jax_losses[2], rel=1e-5)
    got, want = state.model.state_dict(), ref_state.model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for p, q in zip(state.model.parameters(), ref_state.model.parameters()):
        if p.requires_grad:
            mine, theirs = state.optimizer.state[p], \
                ref_state.optimizer.state[q]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(mine[key], theirs[key]), key


def test_sigterm_saves_and_the_resume_equals_the_uninterrupted_run(
        jax_lora_run, port_lora_run, tmp_path):
    """A real SIGTERM at step 2 (``FaultPlan.sigterm_at_step``): the
    handler is checked first (a missing one would end the test process),
    the loop saves synchronously, logs ``preempted_saved`` and returns;
    the resumed fit then equals the uninterrupted one bitwise."""
    from fengshen_tpu_torch.resilience import FaultPlan
    ref_trainer, ref_state, _ = port_lora_run
    args = port_sft.parse_args(_argv(tmp_path, **{
        "--device": "cpu", **LORA_FLAGS,
        **_ckpt_flags(tmp_path / "ckpt", every=5)}))

    def make_module(args):
        return _port_lora_module(jax_lora_run, tmp_path)[2]

    class Guard:
        def on_train_step_end(self, trainer, state):
            assert signal.getsignal(signal.SIGTERM) is \
                port_trainer._SIGTERM_STATE["handler"]

    trainer, _ = _fit(make_module, args, callbacks=[Guard()],
                      plan=FaultPlan(sigterm_at_step=2))
    assert trainer.global_step == 2
    assert [e["step"] for e in trainer.history
            if e.get("event") == "preempted_saved"] == [2]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]
    trainer, state = _fit(make_module, args)
    ref = {e["step"]: e["loss"] for e in ref_trainer.history if "loss" in e}
    assert [(e["step"], e["loss"]) for e in trainer.history
            if "loss" in e] == [(3, ref[3])]
    want = ref_state.model.state_dict()
    for name, t in state.model.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_rewind_after_consecutive_bad_steps(jax_lora_run, tmp_path):
    """NaN losses planted at steps 4 and 5 are guarded away; the second
    one rewinds to the step-3 checkpoint, keeps ``consumed_samples``
    past the bad window, dumps a flight-recorder bundle and replays
    clean to step 6. A plan that keeps firing raises once
    ``--max_rewinds`` is spent."""
    from fengshen_tpu_torch.resilience import FaultPlan
    args = port_sft.parse_args(_argv(tmp_path, **{
        "--device": "cpu", **LORA_FLAGS, "--max_steps": 6,
        "--max_epochs": 3, "--max_consecutive_bad_steps": 2,
        **_ckpt_flags(tmp_path / "ckpt", every=3)}))

    def make_module(args):
        return _port_lora_module(jax_lora_run, tmp_path)[2]

    plan = FaultPlan(nan_loss_at_steps={3, 4})
    trainer, state = _fit(make_module, args, plan=plan)
    rewinds = [e for e in trainer.history if e.get("event") == "rewind"]
    assert [(e["from_step"], e["to_step"]) for e in rewinds] == [(5, 3)]
    assert rewinds[0]["consumed_samples"] == 5 * 4
    assert trainer.global_step == 6 and state.bad_step_count == 2
    assert trainer.consumed_samples == 8 * 4
    bundles = sorted((tmp_path / "flightrec").glob("dump-*-rewind"))
    assert len(bundles) == 1
    manifest = json.loads((bundles[0] / "manifest.json").read_text())
    assert manifest["extra"] == {"from_step": 5, "to_step": 3,
                                 "bad_steps": 2}
    assert ("nan_disarmed", [3, 4]) in plan.fired
    args = port_sft.parse_args(_argv(tmp_path / "again", **{
        "--device": "cpu", **LORA_FLAGS, "--max_steps": 12,
        "--max_epochs": 5, "--max_consecutive_bad_steps": 2,
        "--max_rewinds": 1,
        **_ckpt_flags(tmp_path / "again" / "ckpt", every=1)}))
    with pytest.raises(RuntimeError, match="rewind budget exhausted"):
        _fit(make_module, args, plan=FaultPlan(
            nan_loss_at_steps=range(2, 12), clear_nan_on_rewind=False))
