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

Hygiene: the JAX Trainer installs a process-wide SIGTERM handler and a
process-global mesh; the fixture saves both (and the environment) and
restores them, runs with ``default_root_dir`` under a temp dir and no
metrics server, and torch runs on one intra-op thread.
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
from fengshen_tpu_torch.models.llama import (LlamaConfig, params_from_jax,
                                             params_to_numpy)
from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
from fengshen_tpu_torch.trainer import Trainer

SEED = 7
CONFIG = dict(dtype="float32", param_dtype="float32", num_key_value_heads=2,
              attention_impl="flash", gradient_checkpointing=True,
              scan_layers=True)


def _argv(root, **extra):
    flags = {"--train_batchsize": 4, "--max_seq_length": 32,
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                                       datasets={"train": _records()})
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
        losses = [e["loss"] for e in map(json.loads, f) if "loss" in e]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params0=to_np(params0), batch0=batch0,
                grads0=to_np(grads0), loss0=float(metrics0["loss"]),
                grad_norm0=float(metrics0["grad_norm"]), losses=losses,
                params=to_np(state.params), step=int(state.step))


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
                               datasets={"train": _records()})


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
    handler = signal.getsignal(signal.SIGTERM)
    for flag, value in (("--tensor_model_parallel_size", 2),
                        ("--offload", "opt"), ("--steps_per_execution", 2),
                        ("--metrics_port", 9100), ("--profile_steps", "1,2"),
                        ("--aot_cache_dir", str(tmp_path))):
        args = port_sft.parse_args(_argv(tmp_path, **{"--device": "cpu",
                                                      flag: value}))
        with pytest.raises(NotImplementedError):
            Trainer(args)
    Trainer(port_sft.parse_args(_argv(tmp_path, **{"--device": "cpu"})))
    assert signal.getsignal(signal.SIGTERM) is handler
    with pytest.raises(NotImplementedError, match="K2"):
        cfg = LlamaConfig.small_test_config(**{**CONFIG,
                                               "fused_ce_chunks": 2})
        args = port_sft.parse_args(_argv(tmp_path))
        module = port_sft.Llama(args, cfg, device="cpu")
        module.training_loss({"input_ids": torch.zeros(1, 4).long()})


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
    file, the IdTokenizer stand-in; loss logged per step, finite."""
    cfg = LlamaConfig.small_test_config(**CONFIG)
    cfg.save_pretrained(str(tmp_path / "model"))
    with open(tmp_path / "sft.jsonl", "w") as f:
        for r in _records(8):
            f.write(json.dumps(r) + "\n")
    trainer = port_sft.main(_argv(
        tmp_path / "runs", **{"--device": "cpu",
                              "--model_path": tmp_path / "model",
                              "--train_file": tmp_path / "sft.jsonl",
                              "--max_steps": 2}))
    losses = [e["loss"] for e in trainer.history if "loss" in e]
    assert len(losses) == 2 and np.isfinite(losses).all()
    lines = (tmp_path / "runs" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["event"] == "fit_end"


def test_datamodule_reads_json_and_jsonl_and_refuses_other_splits(tmp_path):
    """The local-file branch reads a JSON array or JSON lines with the
    stdlib; the batches follow the reference's seeded sampler; a
    validation split is refused (validation is not ported)."""
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
        "--val_file": tmp_path / "a.json"}))
    with pytest.raises(NotImplementedError, match="validation"):
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
