"""The fine-tuning surface of the port against the JAX package, on the CPU:
the packed SFT collator (bitwise) and packed logits (flash and dense);
``ResilientLoader`` (retry, exhaustion and skip budget, scenario for
scenario against the JAX wrapper), ``JsonlSink``, ``StepStats`` and the
FLOPs estimator (the same lines, echo and numbers as the JAX ones), the
Trainer's ``--metrics_port`` and ``--profile_steps``, the port's
checkpoint format (every-n on crossing, idempotent saves with a
verified commit, a truncated step falling back, a wrong model raising at
once, a weights-only checkpoint in a full run, ``validate`` restoring
weights only), the LoRA merge CLI whose output ``Pipeline(model=dir)``
serves, and ``main`` reading a ``--model_path`` that holds weights
(bitwise the JAX package's ``load_hf_pretrained``).

Tiny shapes: the Ziya SFT path on ``small_test_config`` (2 layers,
hidden 64, fp32, flash attention's plain version), sequences of 32.
Torch runs on one intra-op thread; the SIGTERM handler every Trainer
installs is put back after each test; no test sleeps (backoff bases
are 0 or the sleep is injected).
"""

import copy
import json
import os
import signal
import urllib.request

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.data import UniversalDataModule
from fengshen_tpu_torch.examples.ziya_llama import finetune_ziya_llama as ft
from fengshen_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                             params_from_jax)
from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
from fengshen_tpu_torch.trainer import Trainer
from fengshen_tpu_torch.trainer import trainer as port_trainer
from fengshen_tpu_torch.utils.universal_checkpoint import (
    CheckpointStructureMismatch, UniversalCheckpoint, committed_steps)

CONFIG = dict(dtype="float32", param_dtype="float32", num_key_value_heads=2,
              attention_impl="flash", gradient_checkpointing=True)


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


def _records(n=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = lambda k: " ".join(map(str, rng.randint(3, 250, k)))  # noqa: E731
    return [{"query": ids(rng.randint(2, 8)),
             "answer": ids(rng.randint(2, 12))} for _ in range(n)]


def _args(root, **extra):
    flags = {"--train_batchsize": 4, "--val_batchsize": 4,
             "--max_seq_length": 32, "--max_steps": 3,
             "--learning_rate": 1e-2, "--warmup_steps": 0,
             "--log_every_n_steps": 1, "--seed": 3, "--device": "cpu",
             "--default_root_dir": root, "--save_ckpt_path": root / "ckpt",
             "--load_ckpt_path": root / "ckpt", **extra}
    argv = []
    for flag, value in flags.items():
        argv += [flag] if value is True else [flag, str(value)]
    return ft.parse_args(argv)


def _module(args, **cfg):
    from fengshen_tpu_torch.trainer.modules import maybe_wrap_lora
    config = LlamaConfig.small_test_config(**{**CONFIG, **cfg})
    return maybe_wrap_lora(ft.Llama(args, config, device="cpu"), args)


def _data(args, val=False):
    collator = ft.LlamaSFTCollator(IdTokenizer(), max_seq_length=32)
    splits = {"train": _records()}
    if val:
        splits["validation"] = _records(8, seed=9)
    return UniversalDataModule(collate_fn=collator, args=args,
                               datasets=splits)


def _fit(args, callbacks=(), val=False, **cfg):
    trainer = Trainer(args)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.callbacks.extend(callbacks)
    state = trainer.fit(_module(args, **cfg), _data(args, val))
    return trainer, state


# -- packed sequences ---------------------------------------------------

def _packed_samples():
    return _records(9, seed=11) + [{"query": "3 " * 20, "answer": "4 " * 9}]


def test_packed_collator_matches_jax():
    """``LlamaSFTPackedCollator`` gives the JAX collator's arrays
    bitwise, with and without ``fixed_rows`` (all-pad filler rows; overflow
    rows dropped and counted in ``dropped_rows``), with and without an
    eos id."""
    from fengshen_tpu.examples.ziya_llama.finetune_ziya_llama import (
        LlamaSFTPackedCollator as JaxPacked)
    tok = IdTokenizer()
    eos_tok = copy.copy(tok)
    eos_tok.eos_token_id = 2
    samples = _packed_samples()
    for t in (tok, eos_tok):
        for rows in (None, 2, 7):
            want_c = JaxPacked(t, max_seq_length=64, fixed_rows=rows)
            got_c = ft.LlamaSFTPackedCollator(t, max_seq_length=64,
                                                    fixed_rows=rows)
            for _ in range(2):
                want, got = want_c(samples), got_c(samples)
                assert want.keys() == got.keys()
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key])
            assert getattr(got_c, "dropped_rows", 0) == \
                getattr(want_c, "dropped_rows", 0)
    packed = ft.LlamaSFTPackedCollator(
        tok, max_seq_length=64, fixed_rows=7)(samples)
    assert packed["attention_mask"].max() >= 2
    assert not packed["attention_mask"][-1].any()      # a filler row


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_packed_logits_match_jax_and_packed_loss_equals_padded(impl):
    """``packed_sequences=True``: the logits on packed rows (segment ids
    to K1's plain version, or the dense path's block-diagonal causal
    mask; positions restarting per example) equal the JAX model's within
    ``test_torch_llama``'s tolerance (atol = rtol = 1e-4); and the
    summed token loss over the packed rows equals the padded batch's
    (same label set, rtol 2e-5), as ``tests/test_packed_sft.py`` holds
    the reference."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.models.llama import LlamaConfig as JaxConfig
    from fengshen_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from fengshen_tpu_torch.models.llama import LlamaForCausalLM
    from fengshen_tpu_torch.parallel.cross_entropy import (
        vocab_parallel_cross_entropy)
    base = dict(dtype="float32", param_dtype="float32",
                num_key_value_heads=2, initializer_range=0.2,
                attention_impl=impl)
    samples = _packed_samples()[:6]
    tok = IdTokenizer()
    packed = ft.LlamaSFTPackedCollator(tok, max_seq_length=48)(samples)
    padded = ft.LlamaSFTCollator(tok, max_seq_length=48)(samples)
    assert packed["input_ids"].shape[0] < padded["input_ids"].shape[0]
    jcfg = JaxConfig.small_test_config(**base, packed_sequences=True)
    jmodel = JaxLlama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.asarray(packed["input_ids"]))["params"]
    ref = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(packed["input_ids"]),
        attention_mask=jnp.asarray(packed["attention_mask"]),
        position_ids=jnp.asarray(packed["position_ids"])))
    cfg = LlamaConfig.small_test_config(**base, packed_sequences=True)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    t = {k: torch.from_numpy(v).long() for k, v in packed.items()}
    with torch.no_grad():
        got = model(t["input_ids"], attention_mask=t["attention_mask"],
                    position_ids=t["position_ids"])
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
        pad_cfg = LlamaConfig.small_test_config(**base)
        pad_model = LlamaForCausalLM(pad_cfg, device="cpu")
        pad_model.load_state_dict(model.state_dict())
        sums = []
        for m, batch in ((model, packed), (pad_model, padded)):
            b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
            logits = m(b["input_ids"], attention_mask=b["attention_mask"],
                       position_ids=b.get("position_ids"))
            mean, n = vocab_parallel_cross_entropy(logits[:, :-1],
                                                   b["labels"][:, 1:])
            sums.append((float(mean) * float(n), float(n)))
    (loss_pack, n_pack), (loss_pad, n_pad) = sums
    assert n_pack == n_pad
    np.testing.assert_allclose(loss_pack, loss_pad, rtol=2e-5)


# -- ResilientLoader ------------------------------------------------------

class _Flaky:
    """Yields ``data``, raising ``fail_at[pos]`` times before position
    ``pos`` (resumable: the cursor survives re-entry)."""

    def __init__(self, data, fail_at):
        self.data, self.fail_at, self.pos = list(data), dict(fail_at), 0

    def skip_next(self):
        self.pos = min(self.pos + 1, len(self.data))

    def __iter__(self):
        while self.pos < len(self.data):
            i = self.pos
            if self.fail_at.get(i, 0) > 0:
                self.fail_at[i] -= 1
                raise IOError(f"flaky read at {i}")
            self.pos += 1
            yield self.data[i]


class _Restarting:
    """Restarts from 0 on every ``iter()``: not mid-epoch resumable."""

    def __init__(self, data, fail_at):
        self.data, self.fail_at = list(data), dict(fail_at)

    def __iter__(self):
        for i, x in enumerate(self.data):
            if self.fail_at.get(i, 0) > 0:
                self.fail_at[i] -= 1
                raise IOError(f"flaky read at {i}")
            yield x


#: name -> (loader factory, wrapper kwargs)
LOADER_CASES = {
    "retry": (lambda: _Flaky(range(5), {2: 3}),
              dict(max_retries=3, backoff_base=0.1, resumable=True)),
    "exhaust": (lambda: _Flaky(range(3), {1: 99}),
                dict(max_retries=2, backoff_base=0, resumable=True)),
    "skip_budget": (lambda: _Flaky(range(4), {1: 99}),
                    dict(max_retries=1, backoff_base=0,
                         skip_batch_budget=1, resumable=True)),
    "fast_forward": (lambda: _Restarting(range(4), {2: 1}),
                     dict(max_retries=2, backoff_base=0)),
    "no_fake_skips": (lambda: _Restarting(range(4), {2: 99}),
                      dict(max_retries=1, backoff_base=0,
                           skip_batch_budget=3)),
}


def _drive(cls, make, kw):
    sleeps, events = [], []
    loader = cls(make(), sleep=sleeps.append, log=events.append, **kw)
    got, error = [], None
    try:
        for x in loader:
            got.append(x)
    except IOError as e:
        error = str(e)
    return dict(got=got, error=error, sleeps=sleeps,
                retries=loader.retries_total, skipped=loader.skipped_total,
                resumable=loader.resumable,
                events=[(e["event"], e.get("attempt"),
                         e.get("skipped_this_epoch")) for e in events])


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_resilient_loader_matches_jax(case):
    """Each scenario of ``tests/test_resilience.py`` through both
    wrappers: the same batches, error, backoff sleeps (exponential with
    the seeded jitter), counters and events."""
    from fengshen_tpu.resilience import ResilientLoader as JaxLoader
    from fengshen_tpu_torch.resilience import ResilientLoader
    make, kw = LOADER_CASES[case]
    got, want = _drive(ResilientLoader, make, kw), _drive(JaxLoader, make, kw)
    assert got == want
    assert {"retry": got["got"] == [0, 1, 2, 3, 4],
            "exhaust": got["error"] is not None and got["retries"] == 3,
            "skip_budget": got["got"] == [0, 2, 3] and got["skipped"] == 1,
            "fast_forward": got["got"] == [0, 1, 2, 3],
            "no_fake_skips": got["error"] is not None and
            got["skipped"] == 0}[case]


def test_resilient_loader_skips_a_poison_batch_of_the_real_loader():
    """The port's DataLoader on the resumable sampler: a row that always
    fails is retried (the sampler rolls back), then skipped through
    ``skip_next``; the other 12 rows arrive, and the sampler's cursor is
    past all 16."""
    from fengshen_tpu_torch.data.universal_datamodule import DataLoader
    from fengshen_tpu_torch.data.universal_sampler import (
        PretrainingRandomSampler)
    from fengshen_tpu_torch.resilience import ResilientLoader

    class Poison:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if i == 11:
                raise IOError("corrupt row")
            return {"input_ids": [i] * 4}

    sampler = PretrainingRandomSampler(16, 0, 4, 0, 1, epoch_seed=3)
    loader = ResilientLoader(DataLoader(Poison(), sampler,
                                        global_batch_size=4),
                             max_retries=2, backoff_base=0,
                             skip_batch_budget=1, sleep=lambda s: None)
    assert loader.resumable
    got = [i for b in loader for i in b["input_ids"][:, 0].tolist()]
    assert loader.skipped_total == 1 and 11 not in got
    assert len(set(got)) == 12 and sampler.consumed_samples == 16


def test_trainer_retries_a_flaky_loader_and_keeps_the_cursor(tmp_path):
    """``--loader_max_retries`` wraps the train loader: two injected
    faults before batch 1 cost two ``loader_retry`` events and nothing
    else (the losses equal a clean run's bitwise)."""
    from fengshen_tpu_torch.resilience import FaultPlan
    clean, _ = _fit(_args(tmp_path / "clean"))
    args = _args(tmp_path / "flaky", **{"--loader_max_retries": 3,
                                        "--loader_backoff_base": 0})
    trainer = Trainer(args)
    plan = FaultPlan(loader_raise_at={1: 2})
    data = plan.wrap_datamodule(_data(args))
    trainer.fit(_module(args), data)
    retries = [e for e in trainer.history if e.get("event") == "loader_retry"]
    assert len(retries) == 2
    assert [e["loss"] for e in trainer.history if "loss" in e] == \
        [e["loss"] for e in clean.history if "loss" in e]
    assert trainer.consumed_samples == 12


# -- sink, step stats, FLOPs ---------------------------------------------

def test_jsonl_sink_writes_the_jax_sinks_lines_and_echo(tmp_path, capsys):
    from fengshen_tpu.observability import JsonlSink as JaxSink
    from fengshen_tpu_torch.observability import JsonlSink
    entries = [{"event": "fit_start", "n_params": 3},
               {"step": 1, "loss": 2.5, "lr": 0.001, "mfu": 0.123456},
               {"event": "rewind", "from_step": 5, "to_step": 3}]
    for cls, name in ((JaxSink, "jax"), (JsonlSink, "port")):
        sink = cls(path=str(tmp_path / f"{name}.jsonl"), echo=True,
                   echo_prefix="> ")
        for e in entries:
            sink(e)
    echo = capsys.readouterr().out.splitlines()
    assert echo[:3] == echo[3:] and echo[1] == \
        "> step=1 loss=2.5 lr=0.001 mfu=0.1235"
    assert (tmp_path / "jax.jsonl").read_text() == \
        (tmp_path / "port.jsonl").read_text()


def test_step_stats_and_flops_match_jax():
    """The window entries (tokens/s, MFU against the nominal CPU peak,
    goodput through a rewind and guarded steps) and the FLOPs estimate
    of a GQA config equal the JAX ``StepStats`` and
    ``estimate_flops_per_token``."""
    from fengshen_tpu.models.llama import LlamaConfig as JaxConfig
    from fengshen_tpu.observability import StepStats as JaxStats
    from fengshen_tpu.observability import MetricsRegistry as JaxRegistry
    from fengshen_tpu.observability.flops import (
        estimate_flops_per_token as jax_flops)
    from fengshen_tpu_torch.observability import (MetricsRegistry,
                                                  StepStats,
                                                  estimate_flops_per_token)
    cfg = dict(hidden_size=64, num_hidden_layers=3, intermediate_size=96,
               vocab_size=300, num_attention_heads=4,
               num_key_value_heads=2)
    flops = estimate_flops_per_token(LlamaConfig.small_test_config(**cfg))
    assert flops == jax_flops(JaxConfig.small_test_config(**cfg))
    rows = []
    for cls, reg, kind in ((JaxStats, JaxRegistry(), "cpu"),
                           (StepStats, MetricsRegistry(), "cpu")):
        t = iter([0.0, 2.0, 5.0, 6.5])
        stats = cls(flops, 1, device_kind=kind, registry=reg,
                    clock=lambda: next(t))
        out = []
        stats.record_execution(1, 128)
        out.append(stats.window_entry(1))
        stats.record_execution(2, 256)
        stats.record_rewind(3, 1)
        out.append(stats.window_entry(3, bad_step_count=1))
        stats.record_execution(1, 64)
        out.append(stats.window_entry(2, bad_step_count=1))
        rows.append(out)
    assert rows[0] == rows[1]


def test_metrics_server_serves_during_fit_and_closes_after(tmp_path):
    """``--metrics_port 0`` binds a free port for the fit: a scrape in
    the middle shows the step gauge, and after ``fit`` the port is
    closed. ``--profile_steps 1,2`` writes a Chrome trace and logs
    ``profile_start`` / ``profile_stop``."""
    seen = {}

    class Scrape:
        def on_train_step_end(self, trainer, state):
            if trainer.global_step == 2:
                seen["port"] = trainer._metrics_server.port
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{seen['port']}/metrics",
                        timeout=10) as r:
                    seen["text"] = r.read().decode()

    args = _args(tmp_path, **{"--metrics_port": 0,
                              "--profile_steps": "1,2"})
    trainer, _ = _fit(args, callbacks=[Scrape()])
    assert "fstpu_train_step 2" in seen["text"]
    assert "fstpu_train_tokens_per_sec" in seen["text"]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{seen['port']}/metrics",
                               timeout=2)
    events = [e.get("event") for e in trainer.history]
    assert "metrics_server_started" in events
    assert {"profile_start", "profile_stop"} <= set(events)
    assert (tmp_path / "profile" / "trace-1-2.json").exists()


# -- checkpoints ----------------------------------------------------------

class _Stub:
    def __init__(self, step, prev):
        self.global_step, self.prev_global_step = step, prev
        self.consumed_samples = 4 * step


def test_every_n_saves_on_crossing(tmp_path):
    """``on_train_step_end`` saves when the step crossed a multiple of
    ``--every_n_train_steps`` (a jump from 1 to 3 crosses 2), not
    otherwise; ``on_fit_end`` saves only without an interval or with
    ``--save_last``."""
    args = _args(tmp_path, **{"--every_n_train_steps": 2})
    _, state = _fit(_args(tmp_path / "fit"))
    cb = UniversalCheckpoint(args)
    for step, prev in ((1, 0), (3, 1), (4, 3), (5, 4)):
        cb.on_train_step_end(_Stub(step, prev), state)
    assert committed_steps(str(tmp_path / "ckpt")) == [3, 4]
    cb.on_fit_end(_Stub(5, 4), state)
    assert committed_steps(str(tmp_path / "ckpt")) == [3, 4]
    assert committed_steps(str(tmp_path / "fit" / "ckpt")) == [3]


def test_save_is_idempotent_and_its_commit_is_verified(tmp_path,
                                                       monkeypatch):
    """A second save of a committed step writes nothing; ``save_top_k``
    keeps the newest steps; a commit that does not show in the
    directory raises."""
    args = _args(tmp_path, **{"--save_top_k": 2})
    _, state = _fit(_args(tmp_path / "fit"))
    cb = UniversalCheckpoint(args)
    for step in (1, 2, 2, 3):
        cb.save(state, _Stub(step, step - 1))
    assert cb.stats["saves"] == 3
    assert committed_steps(str(tmp_path / "ckpt")) == [2, 3]
    import fengshen_tpu_torch.utils.universal_checkpoint as uc
    monkeypatch.setattr(uc.os, "rename", lambda src, dst: None)
    with pytest.raises(RuntimeError, match="did not commit"):
        cb.save(state, _Stub(4, 3))


def test_truncated_step_falls_back_and_a_wrong_model_raises(tmp_path):
    """A truncated newest step is rejected (logged, and deleted in the
    run's own directory) and the step before it restored; a checkpoint
    of another model raises ``CheckpointStructureMismatch`` at once,
    without rejecting any step."""
    from fengshen_tpu_torch.resilience import truncate_checkpoint_step
    args = _args(tmp_path, **{"--every_n_train_steps": 1})
    _fit(args)
    assert committed_steps(str(tmp_path / "ckpt")) == [1, 2, 3]
    truncate_checkpoint_step(str(tmp_path / "ckpt"), 3)
    trainer, state = _fit(_args(tmp_path, **{"--every_n_train_steps": 1,
                                             "--max_steps": 4}))
    events = [(e.get("event"), e.get("ckpt_step")) for e in trainer.history
              if str(e.get("event", "")).startswith("checkpoint_")]
    assert events == [("checkpoint_restore_rejected", 3),
                      ("checkpoint_rejected_deleted", 3)]
    assert [e["step"] for e in trainer.history if "loss" in e] == [3, 4]
    wrong = Trainer(args)
    wrong.callbacks.append(UniversalCheckpoint(args))
    with pytest.raises(CheckpointStructureMismatch):
        wrong.fit(_module(args, num_hidden_layers=3), _data(args))
    assert not [e for e in wrong.history
                if e.get("event") == "checkpoint_restore_rejected"]


def test_weights_only_checkpoint_loads_into_a_full_run(tmp_path):
    """A ``--save_weights_only`` checkpoint restores the parameters and
    the step into a full run, whose optimizer (and schedule) start
    fresh; ``validate`` restores weights only and logs the sweep."""
    args = _args(tmp_path, **{"--save_weights_only": True,
                              "--max_steps": 2})
    _, saved = _fit(args, val=True)
    meta = json.loads((tmp_path / "ckpt" / "2" / "meta.json").read_text())
    assert "optimizer" not in meta and \
        not (tmp_path / "ckpt" / "2" / "optimizer.safetensors").exists()
    args = _args(tmp_path, **{"--max_steps": 3})
    trainer, state = _fit(args)
    assert [e["step"] for e in trainer.history if "loss" in e] == [3]
    assert trainer.history[-1]["event"] == "fit_end"
    evaluator = Trainer(args)
    evaluator.callbacks.append(UniversalCheckpoint(args))
    module = _module(args)
    eval_state = evaluator.validate(module, _data(args, val=True))
    assert eval_state.optimizer is None and evaluator.global_step == 3
    want = state.model.state_dict()
    for name, t in eval_state.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert [e.get("event") for e in evaluator.history][-2] == \
        "validate_start"
    assert np.isfinite(evaluator.history[-1]["val_loss"])


# -- preemption -------------------------------------------------------------

def test_sigterm_outside_a_fit_still_terminates(tmp_path):
    """A process that holds a Trainer but runs no fit dies on SIGTERM as
    it would without one (the previous disposition is the default):
    the handler re-delivers the signal through it. Run in a child
    process, so no test worker is signalled."""
    import subprocess
    import sys
    code = (
        "import os, signal, sys, time\n"
        "from fengshen_tpu_torch.examples.ziya_llama import "
        "finetune_ziya_llama as ft\n"
        "from fengshen_tpu_torch.trainer import Trainer\n"
        "signal.signal(signal.SIGTERM, signal.SIG_DFL)\n"
        f"t = Trainer(ft.parse_args(['--device', 'cpu', "
        f"'--default_root_dir', {str(tmp_path)!r}]))\n"
        "assert signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(30)\n"
        "sys.exit(3)\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGTERM, proc.stderr[-2000:]


# -- merge CLI, checkpoint directories ------------------------------------

def test_merge_cli_output_serves_as_the_merged_model(tmp_path, capsys):
    """A LoRA fine-tune's checkpoint merged by ``python -m
    fengshen_tpu_torch.ops.lora``: ``Pipeline(model=dir)`` loads
    parameters bitwise equal to the in-memory ``merge_lora`` of the
    trained model, and generates its tokens. Without a config the CLI
    warns."""
    from fengshen_tpu_torch.ops import lora
    from fengshen_tpu_torch.pipelines.text_generation import Pipeline
    from fengshen_tpu_torch.utils.generate import generate
    args = _args(tmp_path, **{"--lora_rank": 4, "--every_n_train_steps": 3})
    _, state = _fit(args)
    config = state.model.config
    config.save_pretrained(str(tmp_path / "model"))
    lora.main(["--input_path", str(tmp_path / "ckpt"), "--output_path",
               str(tmp_path / "merged"), "--config_path",
               str(tmp_path / "model"), "--device", "cpu"])
    merged = lora.merge_lora(state.model)
    pipe = Pipeline(model=str(tmp_path / "merged"), tokenizer=IdTokenizer(),
                    device="cpu")
    got = pipe.module.state_dict()
    want = merged.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    ids = torch.tensor([[5, 9, 17, 33, 65]])
    assert torch.equal(generate(pipe.module, ids, max_new_tokens=6,
                                device="cpu"),
                       generate(merged, ids, max_new_tokens=6,
                                device="cpu"))
    lora.main(["--input_path", str(tmp_path / "ckpt"), "--output_path",
               str(tmp_path / "bare"), "--device", "cpu"])
    assert "no config.json found" in capsys.readouterr().err
    assert not (tmp_path / "bare" / "config.json").exists()


def test_merge_cli_streams_and_runs_on_the_card_by_default(tmp_path,
                                                          monkeypatch):
    """The merge CLI reads the adapters first and then each base tensor
    once, writing it before the next is read: at each read at most one
    earlier base tensor is still alive, so a checkpoint never lies in
    host memory whole. With no ``--device`` it runs on the card, and
    raises where there is none."""
    import weakref

    from fengshen_tpu_torch.models.llama import convert
    from fengshen_tpu_torch.ops import lora
    from fengshen_tpu_torch.utils.universal_checkpoint import PARAMS_FILE
    args = _args(tmp_path, **{"--lora_rank": 4, "--every_n_train_steps": 3})
    _fit(args)
    argv = ["--input_path", str(tmp_path / "ckpt"), "--output_path",
            str(tmp_path / "merged")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lora.main(argv)
    assert not (tmp_path / "merged").exists()

    reads, most_alive = [], []
    real = convert.iter_safetensors

    def counted(path, names=None):
        seen = []
        for name, t in real(path, names):
            most_alive.append(sum(r() is not None for r in seen))
            seen.append(weakref.ref(t))
            reads.append(name)
            yield name, t

    monkeypatch.setattr(convert, "iter_safetensors", counted)
    lora.main(argv + ["--device", "cpu"])
    header = convert.read_safetensors_header(
        str(tmp_path / "ckpt" / "3" / PARAMS_FILE))[0]
    names = [k for k in header if k != "__metadata__"]
    adapters = [k for k in names if k.rsplit(".", 1)[-1] in lora.LORA_LEAVES]
    base = [k for k in names if k not in adapters]
    assert adapters and len(base) > 8
    assert reads == adapters + base
    assert max(most_alive[len(adapters):]) <= 1


def test_main_reads_a_model_path_with_weights_as_jax_does(tmp_path):
    """A ``--model_path`` holding safetensors weights: ``Llama.setup`` and
    ``init_params`` load them (bitwise the JAX package's
    ``load_hf_pretrained``, converted), and ``main`` fine-tunes from them
    with ``--lora_rank``, the base left as loaded."""
    import jax

    from fengshen_tpu.models.llama import LlamaConfig as JaxConfig
    from fengshen_tpu.models.llama.convert import load_hf_pretrained
    from fengshen_tpu_torch.models.llama.convert import write_safetensors
    cfg = LlamaConfig.small_test_config(**CONFIG)
    src = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    model_dir = tmp_path / "model"
    cfg.save_pretrained(str(model_dir))
    write_safetensors(str(model_dir / "model.safetensors"),
                      src.state_dict())
    jcfg = JaxConfig.small_test_config(**CONFIG)
    _, jparams = load_hf_pretrained(str(model_dir), jcfg)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    args = _args(tmp_path, **{"--model_path": model_dir})
    module = ft.Llama(args, device="cpu")
    module.setup("fit")
    model = module.init_params(torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    with open(tmp_path / "sft.jsonl", "w") as f:
        for r in _records(8):
            f.write(json.dumps(r) + "\n")
    trainer = ft.main([str(x) for x in (
        "--model_path", model_dir, "--train_file", tmp_path / "sft.jsonl",
        "--train_batchsize", 4, "--max_seq_length", 32, "--max_steps", 2,
        "--lora_rank", 4, "--device", "cpu", "--default_root_dir",
        tmp_path / "runs", "--save_ckpt_path", tmp_path / "c2",
        "--load_ckpt_path", tmp_path / "c2")], tokenizer=IdTokenizer())
    sd = trainer.state.model.state_dict()
    assert np.isfinite([e["loss"] for e in trainer.history
                        if "loss" in e]).all()
    for name in want:
        assert torch.equal(sd[name], want[name]), name
    assert os.listdir(tmp_path / "c2") == ["2"]


def test_predict_generates_from_the_restored_weights(tmp_path):
    """``restore_for_predict`` builds an eval-only state from the
    checkpoint's weights; ``predict`` runs ``Llama.predict_step`` over a
    loader of left-padded batches and gives ``generate``'s tokens on
    those weights."""
    from fengshen_tpu_torch.utils.generate import generate
    args = _args(tmp_path, **{"--max_steps": 2})
    _, trained = _fit(args)
    trainer = Trainer(args)
    trainer.callbacks.append(UniversalCheckpoint(args))
    module = _module(args)
    state = trainer.restore_for_predict(module)
    assert trainer.global_step == 2 and state.optimizer is None
    batch = {"input_ids": np.array([[0, 5, 6, 7], [9, 8, 7, 6]]),
             "attention_mask": np.array([[0, 1, 1, 1], [1, 1, 1, 1]])}
    out = trainer.predict(module, [batch], state, max_new_tokens=3)
    want = generate(trained.model, torch.from_numpy(batch["input_ids"]),
                    attention_mask=torch.from_numpy(batch["attention_mask"]),
                    max_new_tokens=3, eos_token_id=trained.model.config
                    .eos_token_id, device="cpu")
    assert len(out) == 1 and torch.equal(out[0], want)
    with pytest.raises(ValueError, match="needs a state"):
        trainer.predict(module, [batch])
