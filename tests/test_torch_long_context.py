"""The port's long-context training slice against the JAX package, on
the CPU.

``configs/long_context_32k.json`` (LLaMA-7B-class at a 32768-token
window: ring attention, remat ``dots_no_batch``, the fused LM-head CE
over 16 chunks, bf16) is trained through both packages' ``Trainer.fit``
and ``CausalLMModule`` at the kernel bench's shrunk width
(``KERNEL_BENCH_*``: hidden 64, intermediate 128, 2 layers, 4 heads over
2 KV heads, vocab 512, 64 tokens, fp32), the JAX one on a one-device
mesh, both from the JAX package's initial parameters and over the same
rows (``input_ids`` only, the default collation). Loss per step rtol
1e-5 (fp32 math in another reduction order, ~1e-7 relative); ``acc``
per step exact (a flip would need a near-tie of the argmax).

Also held to the JAX package: the config loader field by field, rotary
at the window's last positions with theta 1e6, and the AdamW update on
bf16 parameters (optax keeps bf16 moments and rounds every step in
bf16; the port's ``AdamW``, which the trainer takes for bf16 models,
matches it bitwise).

Hygiene: the JAX Trainer installs a process-wide SIGTERM handler and a
process-global mesh; the fixture saves both (and the environment) and
restores them; the port's Trainer installs its own handler, put back
after each test; torch runs on one intra-op thread.
"""

import argparse
import dataclasses
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.models.llama import LlamaConfig, params_from_jax
from fengshen_tpu_torch.ops.kernels import bench
from fengshen_tpu_torch.ops.rotary import apply_rotary_pos_emb, rotary_cos_sin

SHRUNK = {"SEQ": 64, "HIDDEN": 64, "INTER": 128, "LAYERS": 2, "HEADS": 4,
          "KV": 2, "VOCAB": 512, "STEPS": 3, "BATCH": 1,
          "DTYPE": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_sigterm_restored():
    """The port's Trainer installs the process-wide SIGTERM handler: put
    the previous handler and the module's state back after each test."""
    from fengshen_tpu_torch.trainer import trainer as port_trainer
    handler = signal.getsignal(signal.SIGTERM)
    state = dict(port_trainer._SIGTERM_STATE)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_trainer._SIGTERM_STATE.clear()
    port_trainer._SIGTERM_STATE.update(state)


@pytest.fixture(scope="module")
def shrunk_env():
    """The bench's KERNEL_BENCH_* knobs at the shrunk width, restored
    after the module."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SHRUNK.items():
            mp.setenv(f"KERNEL_BENCH_{name}", str(value))
        yield


def test_from_pretrained_matches_jax_field_by_field():
    from fengshen_tpu.models.llama import LlamaConfig as JaxConfig
    path = str(bench.CONFIG_PATH)
    want = dataclasses.asdict(JaxConfig.from_pretrained(path))
    got = dataclasses.asdict(LlamaConfig.from_pretrained(path))
    assert got == want
    assert "_comment" not in got
    assert (got["rope_theta"], got["num_key_value_heads"],
            got["param_dtype"], got["scan_layers"], got["remat_policy"],
            got["attention_impl"], got["fused_ce_chunks"]) == \
        (1e6, 8, "bfloat16", True, "dots_no_batch", "ring", 16)


def test_rotary_at_the_end_of_the_window_matches_jax():
    """Positions 32760-32767 at theta 1e6: the angles are fp32 products
    formed in the reference's order, so the tables agree to fp32 rounding
    of cos/sin (an fp64 or reordered product moves the last positions by
    ~1e-3 rad)."""
    import jax.numpy as jnp

    from fengshen_tpu.ops import rotary as jax_rotary
    pos = np.arange(32760, 32768, dtype=np.int32)[None]
    rng = np.random.RandomState(0)
    q, k = (rng.randn(1, 8, 2, 128).astype(np.float32) for _ in range(2))
    want_cos, want_sin = jax_rotary.rotary_cos_sin(jnp.asarray(pos), 128,
                                                   base=1e6)
    got_cos, got_sin = rotary_cos_sin(torch.from_numpy(pos).long(), 128,
                                      base=1e6)
    np.testing.assert_allclose(got_cos.numpy(), np.asarray(want_cos),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_sin.numpy(), np.asarray(want_sin),
                               rtol=0, atol=2e-6)
    wq, wk = jax_rotary.apply_rotary_pos_emb(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), base=1e6)
    gq, gk = apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(pos).long(), base=1e6)
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_matches_optax_on_bf16_and_fp32_params(dtype):
    """Four updates of ``optax.adamw`` (the JAX trainer's optimizer) and
    the port's ``AdamW`` from the same parameters and gradients with a
    changing learning rate: bf16 parameters and moments bitwise equal;
    fp32 within 1e-7 (XLA fuses the fp32 chain)."""
    import jax.numpy as jnp
    import optax

    from fengshen_tpu_torch.models.model_utils import AdamW
    rng = np.random.RandomState(0)
    p0 = (rng.randn(4096) * 0.02).astype(np.float32)
    grads = [(rng.randn(4096) * 1e-3).astype(np.float32) for _ in range(4)]
    lrs = [1e-3 * (1 + 0.1 * i) for i in range(4)]
    tx = optax.adamw(learning_rate=lambda c: jnp.asarray(lrs)[c], b1=0.9,
                     b2=0.999, eps=1e-8, weight_decay=0.1)
    want = jnp.asarray(p0, getattr(jnp, dtype))
    opt_state = tx.init(want)
    param = torch.nn.Parameter(torch.tensor(p0, dtype=getattr(torch,
                                                              dtype)))
    opt = AdamW([param], weight_decay=0.1)
    for lr, g in zip(lrs, grads):
        update, opt_state = tx.update(jnp.asarray(g, want.dtype), opt_state,
                                      want)
        want = optax.apply_updates(want, update)
        param.grad = torch.from_numpy(g).to(param.dtype)
        opt.param_groups[0]["lr"] = lr
        opt.step()
    got = param.detach().float().numpy()
    mu = opt.state[param]["exp_avg"]
    assert mu.dtype == param.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
        np.testing.assert_array_equal(mu.float().numpy(), np.asarray(
            opt_state[0].mu, np.float32))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-7)
    assert np.abs(got - p0).max() > 1e-3          # the updates show


def test_configure_optimizers_rounds_as_optax_for_bf16_params():
    """bf16 parameters (the long-context config's) get the port's
    ``AdamW``, with optax's rounding; all-fp32 models keep
    ``torch.optim.AdamW``."""
    import argparse

    from fengshen_tpu_torch.models import model_utils
    from fengshen_tpu_torch.models.llama import LlamaForCausalLM
    args = argparse.Namespace(learning_rate=1e-3, warmup_steps=0,
                              warmup_ratio=0.0, weight_decay=0.1)
    kinds = {}
    for dtype in ("bfloat16", "float32"):
        model = LlamaForCausalLM(LlamaConfig.small_test_config(
            param_dtype=dtype), device="cpu")
        kinds[dtype] = type(model_utils.configure_optimizers(args, 4,
                                                             model)[0])
    assert kinds == {"bfloat16": model_utils.AdamW,
                     "float32": torch.optim.AdamW}


@pytest.fixture(scope="module")
def jax_run(shrunk_env, tmp_path_factory):
    """The JAX Trainer.fit of the long-context rung at the shrunk width
    (the reference's ``bench_long_context`` set-up on a one-device mesh),
    its initial params and its logged steps, with every process-global
    it touches restored."""
    import jax

    from fengshen_tpu.data import UniversalDataModule
    from fengshen_tpu.models.llama import LlamaConfig as JaxConfig
    from fengshen_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from fengshen_tpu.models.model_utils import add_module_args
    from fengshen_tpu.parallel import MeshConfig, get_mesh, make_mesh, set_mesh
    from fengshen_tpu.trainer import trainer as jax_trainer
    from fengshen_tpu.trainer.modules import CausalLMModule

    root = tmp_path_factory.mktemp("jax_long_context")
    port_cfg = bench.long_context_config()
    cfg = JaxConfig(**dataclasses.asdict(port_cfg))
    parser = argparse.ArgumentParser()
    add_module_args(parser)
    jax_trainer.add_trainer_args(parser)
    UniversalDataModule.add_data_specific_args(parser)
    port_args = bench.long_context_args(str(root), SHRUNK["STEPS"],
                                        SHRUNK["BATCH"], "cpu")
    argv = [a for a in (
        "--max_steps", "--train_batchsize", "--data_parallel_size",
        "--fsdp_parallel_size", "--sequence_parallel_size",
        "--tensor_model_parallel_size", "--log_every_n_steps",
        "--warmup_steps", "--default_root_dir")
        for a in (a, str(getattr(port_args, a[2:])))]
    args = parser.parse_args(argv)
    rows = bench.long_context_rows(cfg.vocab_size, SHRUNK["SEQ"],
                                   SHRUNK["BATCH"] * (SHRUNK["STEPS"] + 1))

    def one_device_mesh(config=None, devices=None):
        return make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])

    saved_handler = signal.getsignal(signal.SIGTERM)
    saved_state = dict(jax_trainer._SIGTERM_STATE)
    saved_mesh, saved_env = get_mesh(), dict(os.environ)
    threads = set(threading.enumerate())
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trainer, "make_mesh", one_device_mesh)
            module = CausalLMModule(args, JaxLlama(cfg), cfg)
            assert module._fused_ce_mode() == "replicated"
            params0 = module.init_params(jax.random.PRNGKey(args.seed))
            data = UniversalDataModule(args=args, datasets={"train": rows})
            jax_trainer.Trainer(args).fit(module, data)
    finally:
        signal.signal(signal.SIGTERM, saved_handler)
        jax_trainer._SIGTERM_STATE.clear()
        jax_trainer._SIGTERM_STATE.update(saved_state)
        set_mesh(saved_mesh)
        os.environ.clear()
        os.environ.update(saved_env)
    assert set(threading.enumerate()) <= threads
    with open(root / "metrics.jsonl") as f:
        steps = [e for e in map(json.loads, f) if "loss" in e]
    return dict(params0=jax.tree_util.tree_map(np.asarray, params0),
                steps=steps, config=port_cfg)


def test_long_context_fit_matches_the_jax_trainer(jax_run, shrunk_env,
                                                  tmp_path):
    """The port's rung (``long_context_fit``: Trainer, CausalLMModule in
    fused-CE mode "replicated", ring attention, ``dots_no_batch``) over 3
    steps against the JAX Trainer, loss and acc per step."""
    cfg = jax_run["config"]
    assert (cfg.attention_impl, cfg.remat_policy, cfg.fused_ce_chunks,
            cfg.num_key_value_heads, cfg.rope_theta) == \
        ("ring", "dots_no_batch", 16, 2, 1e6)
    trainer, state, module, _ = bench.long_context_fit(
        cfg, "cpu", root=str(tmp_path),
        pretrained_state=params_from_jax(jax_run["params0"], cfg))
    got = [e for e in trainer.history if "loss" in e]
    want = jax_run["steps"]
    assert state.step == len(got) == len(want) == SHRUNK["STEPS"]
    assert module._fused_ce_mode() == "replicated"
    np.testing.assert_allclose([e["loss"] for e in got],
                               [e["loss"] for e in want], rtol=1e-5)
    assert [e["acc"] for e in got] == pytest.approx(
        [e["acc"] for e in want], abs=1e-7)
    assert [e["n_tokens"] for e in got] == [e["n_tokens"] for e in want] \
        == [SHRUNK["SEQ"] - 1] * SHRUNK["STEPS"]


def test_bench_long_context_row_has_the_reference_fields(shrunk_env,
                                                         monkeypatch,
                                                         tmp_path):
    """The rung's row on the CPU: the reference's fields, the plain
    dispatch, one device."""
    monkeypatch.setenv("KERNEL_BENCH_STEPS", "2")
    monkeypatch.setattr(bench.tempfile, "mkdtemp",
                        lambda prefix="": str(tmp_path))
    row = bench.bench_long_context("cpu")
    assert set(row) == {"metric", "value", "unit", "vs_baseline", "kernel",
                        "backend", "seq", "attention_impl",
                        "sequence_parallel"}
    assert (row["metric"], row["kernel"], row["backend"], row["seq"],
            row["attention_impl"], row["sequence_parallel"]) == \
        ("long_context_tokens_per_sec", "plain", "cpu", 64, "ring", 1)
    assert row["value"] > 0
    monkeypatch.setenv("KERNEL_BENCH_SP", "2")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        bench.bench_long_context("cpu")


def test_sequence_parallel_attention_on_one_device_is_flash():
    """``dot_product_attention`` with impl ring / ulysses / sequence and
    no mesh (or a sequence axis of 1) is flash attention over the whole
    sequence, causal with segment ids, as the reference falls back to
    it; a bias raises ``ValueError`` as in the reference, and a sequence
    axis above 1 is refused."""
    from fengshen_tpu_torch.ops.attention import dot_product_attention
    from fengshen_tpu_torch.ops.flash_attention import flash_attention
    from fengshen_tpu_torch.ops.ring_attention import sequence_sharded_call
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 12, 4, 16).astype(np.float32))
               for _ in range(3))
    seg = torch.ones(2, 12, dtype=torch.int32)
    seg[1, 9:] = 0
    want = flash_attention(q, k, v, causal=True, segment_ids=seg)
    for impl in ("ring", "ulysses", "sequence"):
        got = dot_product_attention(q, k, v, impl=impl, segment_ids=seg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="causal/segment"):
        dot_product_attention(q, k, v, bias=torch.zeros(1, 1, 12, 12),
                              impl="ring")

    class Mesh:
        def __init__(self, sequence):
            self.shape = {"data": 1, "sequence": sequence}

    torch.testing.assert_close(
        sequence_sharded_call(None, q, k, v, seg, mesh=Mesh(1)), want,
        rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        sequence_sharded_call(None, q, k, v, seg, mesh=Mesh(2))


def test_dots_no_batch_keeps_the_projections():
    """Remat ``dots_no_batch`` keeps every projection's output and
    recomputes the rest of the layer in the backward: the backward's
    matmuls without batch dimensions are its own two per projection (7
    projections a layer), where remat ``nothing`` also recomputes the six
    projections whose outputs the backward reads (not down_proj's: the
    recompute stops once it has what the backward needs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from fengshen_tpu_torch.models.llama import LlamaForCausalLM

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 16))).long()
    counts = {}
    for policy in ("nothing", "dots_no_batch"):
        cfg = LlamaConfig.small_test_config(
            dtype="float32", num_key_value_heads=2, attention_impl="ring",
            gradient_checkpointing=True, remat_policy=policy)
        model = LlamaForCausalLM(cfg, device="cpu")
        loss = model(ids, return_hidden=True).square().mean()
        with CountMM() as mode:
            loss.backward()
        counts[policy] = mode.n
    layers = 2
    assert counts == {"dots_no_batch": 2 * 7 * layers,
                      "nothing": (2 * 7 + 6) * layers}
