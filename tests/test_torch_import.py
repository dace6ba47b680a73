"""The port stands alone: it imports torch, never jax, flax or the JAX
package (``fengshen_tpu``, matched as the exact top-level name: the
port's own name starts with it), nor ``datasets``; ``transformers`` only
inside a function (the tokenizer of a checkpoint directory, loaded on
that path alone), so importing any port module never loads it; and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "fengshen_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "fengshen_tpu", "transformers",
             "datasets"}
#: imported by the port only inside a function body
LAZY_ONLY = {"transformers"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fengshen_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(node))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in LAZY_ONLY and id(node) in in_function:
                continue
            assert top not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, node.lineno) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.lineno


@pytest.mark.parametrize(
    "path", sorted((ROOT / "tests").glob("test_torch_*_gpu.py")),
    ids=lambda p: p.name)
def test_no_gpu_test_file_imports_jax(path):
    """The ``gpu`` tests run on the card's machine, which has no JAX:
    none imports jax, flax or the JAX package, even inside a
    function."""
    for name, line in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN - LAZY_ONLY, \
            f"{path.name}:{line} imports {name}"


def test_entry_points_need_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from fengshen_tpu_torch.api.main import main
    from fengshen_tpu_torch.models.llama import (LlamaConfig,
                                                 LlamaForCausalLM)
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    from fengshen_tpu_torch.serving import (ContinuousBatchingEngine,
                                            EngineConfig)
    from fengshen_tpu_torch.utils.generate import generate

    cfg = LlamaConfig.small_test_config(dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, [[5, 6]], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(model, EngineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(module=model, tokenizer=IdTokenizer())
    cfg.save_pretrained(str(tmp_path / "model"))
    server_cfg = tmp_path / "server.json"
    server_cfg.write_text(json.dumps(
        {"SERVER": {"port": 0},
         "PIPELINE": {"model": str(tmp_path / "model")}}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", str(server_cfg)])
    from fengshen_tpu_torch.examples.ziya_llama.finetune_ziya_llama import \
        main as finetune_main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune_main(["--model_path", str(tmp_path / "model")])
    from fengshen_tpu_torch.examples.classification.finetune_classification \
        import main as classification_main
    from fengshen_tpu_torch.models.megatron_bert import (
        MegatronBertConfig, MegatronBertModel)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classification_main(["--pretrained_model_path",
                             str(tmp_path / "model"), "--model_type",
                             "huggingface-megatron_bert"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MegatronBertModel(MegatronBertConfig.small_test_config())
    from fengshen_tpu_torch.examples.fastdemo.yuyuan_qa import \
        main as yuyuan_main
    from fengshen_tpu_torch.examples.wenzhong_qa.finetune_wenzhong import \
        main as wenzhong_main
    from fengshen_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2LMHeadModel(GPT2Config.small_test_config())
    GPT2Config.small_test_config().save_pretrained(str(tmp_path / "gpt2"))
    for entry in (wenzhong_main, yuyuan_main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(["--model_path", str(tmp_path / "gpt2")])
    from fengshen_tpu_torch.examples.summary.seq2seq_summary import \
        main as summary_main
    from fengshen_tpu_torch.models.t5 import (T5Config,
                                              T5ForConditionalGeneration)
    from fengshen_tpu_torch.utils.generate import seq2seq_generate
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T5ForConditionalGeneration(T5Config.small_test_config())
    t5 = T5ForConditionalGeneration(T5Config.small_test_config(
        dtype="float32"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seq2seq_generate(t5, [[5, 6]], max_new_tokens=2)
    T5Config.small_test_config().save_pretrained(str(tmp_path / "t5"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        summary_main(["--pretrained_model_path", str(tmp_path / "t5")])
    # a model asked for on the CPU runs there
    out = generate(model, [[5, 6]], max_new_tokens=2, device="cpu")
    assert out.shape == (1, 4)
    assert seq2seq_generate(t5, [[5, 6]], max_new_tokens=2,
                            device="cpu").shape == (1, 3)
