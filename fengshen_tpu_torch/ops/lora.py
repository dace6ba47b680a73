"""LoRA: the port of ``fengshen_tpu/ops/lora.py``.

The reference keeps the adapters in a tree beside the frozen base and
merges ``W + scale * A@B`` into every adapted kernel inside the jitted
step (``apply_lora``, :75). The port keeps the base ``nn.Linear``
weights where they are and swaps each adapted projection for a
:class:`LoraLinear`: the same ``weight`` (frozen), plus ``lora_a
[in, r]``, ``lora_b [r, out]`` (the reference's layouts) and the scale
``alpha / r`` as a buffer, so a checkpoint cannot lose it. The model
reads an adapted projection through :meth:`LoraLinear.merged_weight`
inside the layer's forward, so the merged weight is a temporary that a
checkpointed layer recomputes in its backward; the arithmetic is the
reference's: the delta in fp32, added to the fp32 weight, the sum cast
back to the weight's dtype (and then, as every projection, to the
compute dtype).

Parameter paths for the regexes are the port's names with ``/`` for
``.``: an adapted projection is ``model/layers/3/self_attn/q_proj``, a
base leaf ``lm_head/weight``. The reference's paths
(``model/layers/layer/self_attn/q_proj/kernel``) differ in the layer
index and the leaf's name only, so the default targets and the usual
head regexes select the same tensors.

``python -m fengshen_tpu_torch.ops.lora --input_path CKPT --output_path
DIR --config_path MODEL_DIR`` is the merge CLI (:126): it reads the
newest step of a LoRA fine-tune's checkpoint directory, merges on the
card (``--device cpu`` on the host) one tensor at a time, and writes an
HF checkpoint directory (``model.safetensors`` and ``config.json``)
that ``Pipeline(model=DIR)`` serves.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

#: the default adapted projections (the Ziya example's ``--lora_targets``)
DEFAULT_TARGETS = r"(q_proj|k_proj|v_proj|o_proj)"

#: the tensors LoRA adds to each adapted projection
LORA_LEAVES = ("lora_a", "lora_b", "lora_scale")


def param_path(name: str) -> str:
    """A port parameter or module name as a regex path
    (``model.layers.0.self_attn`` -> ``model/layers/0/self_attn``)."""
    return name.replace(".", "/")


def train_path_matches(name: str, train_regex: Optional[str]) -> bool:
    """Does the base parameter ``name`` match the fully-trained
    (``modules_to_save``) regex? The one predicate that decides both
    ``requires_grad`` and the optimizer's parameters (:100)."""
    return bool(train_regex) and bool(re.search(train_regex,
                                                param_path(name)))


def merge_delta(weight: torch.Tensor, lora_a: torch.Tensor,
                lora_b: torch.Tensor, scale) -> torch.Tensor:
    """``W + scale * (A @ B)^T`` with the delta in fp32, added to the fp32
    weight and cast back to the weight's dtype (the reference's
    ``apply_lora``, :75-90). ``weight`` is ``[out, in]``, ``lora_a
    [in, r]``, ``lora_b [r, out]``. The one merge the training forward,
    ``merge_lora`` and the merge CLI all use."""
    delta = (lora_a.float() @ lora_b.float()) * scale
    return (weight.float() + delta.T).to(weight.dtype)


class LoraLinear(nn.Linear):
    """An ``nn.Linear`` with a rank-``r`` adapter. ``weight`` and
    ``bias`` are the base module's parameters themselves (not copied;
    the adapter changes the weight only, as the reference adapts the
    ``kernel`` leaf); ``lora_a [in, r]`` and ``lora_b [r, out]`` are new
    parameters in the weight's dtype; ``lora_scale`` (fp32 scalar) is a
    buffer."""

    def __init__(self, base: nn.Linear, lora_a: torch.Tensor,
                 lora_b: torch.Tensor, scale: float):
        nn.Module.__init__(self)
        self.in_features, self.out_features = base.in_features, \
            base.out_features
        self.weight = base.weight
        self.bias = base.bias
        self.lora_a = nn.Parameter(lora_a)
        self.lora_b = nn.Parameter(lora_b)
        self.register_buffer("lora_scale", torch.tensor(
            float(scale), dtype=torch.float32, device=base.weight.device))

    def merged_weight(self) -> torch.Tensor:
        return merge_delta(self.weight, self.lora_a, self.lora_b,
                           self.lora_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ merged^T (+ bias)`` with the merged weight and the bias
        cast to ``x``'s dtype: the models' projections
        (``modeling_llama._linear``, ``models/layers.dense``) come
        here."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return nn.functional.linear(x, self.merged_weight().to(x.dtype),
                                    bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, rank={self.lora_a.shape[1]}")


def target_modules(model: nn.Module, target_regex: str) -> list:
    """``(name, module)`` of every ``nn.Linear`` whose path matches
    ``target_regex`` (``re.search``), in module order."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, nn.Linear)
            and re.search(target_regex, param_path(name))]


def init_lora(model: nn.Module, generator: torch.Generator, rank: int,
              target_regex: str = DEFAULT_TARGETS,
              alpha: Optional[float] = None,
              init_std: float = 0.02) -> list:
    """Adapt every projection of ``model`` that ``target_regex``
    selects, in place: ``lora_a ~ N(0, init_std)`` drawn from
    ``generator`` on the weight's device, ``lora_b = 0`` (so the merged
    forward equals the base forward until the first update), scale
    ``alpha / rank`` with ``alpha`` defaulting to ``2 * rank`` (:48).
    A projection adapted before gets fresh adapters in place. Returns
    the adapted module names; raises when none matches."""
    if rank < 1:
        raise ValueError(f"init_lora: rank={rank} must be >= 1")
    alpha = float(2 * rank) if alpha is None else float(alpha)
    targets = target_modules(model, target_regex)
    if not targets:
        raise ValueError(f"init_lora: no projection matches "
                         f"{target_regex!r}")
    with torch.no_grad():
        for name, lin in targets:
            w = lin.weight
            a = torch.empty(lin.in_features, rank, dtype=torch.float32,
                            device=w.device)
            a.normal_(0.0, init_std, generator=generator)
            b = torch.zeros(rank, lin.out_features, dtype=w.dtype,
                            device=w.device)
            if isinstance(lin, LoraLinear):     # adapted before: redraw
                lin.lora_a.copy_(a)
                lin.lora_b.zero_()
                lin.lora_scale.fill_(alpha / rank)
            else:
                _replace(model, name, LoraLinear(lin, a.to(w.dtype), b,
                                                 alpha / rank))
    return [name for name, _ in targets]


def _replace(model: nn.Module, name: str, module: nn.Module) -> None:
    parent_name, _, child = name.rpartition(".")
    parent = model.get_submodule(parent_name) if parent_name else model
    setattr(parent, child, module)


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Merge every adapter into its weight, in place, and put the plain
    ``nn.Linear`` back: the merged model has the base model's parameter
    names and serves as any other (the reference's ``merge_lora``)."""
    for name, m in list(model.named_modules()):
        if isinstance(m, LoraLinear):
            merged = m.merged_weight()
            lin = nn.Linear(m.in_features, m.out_features, bias=False,
                            device="meta", dtype=m.weight.dtype)
            lin.weight = nn.Parameter(merged, requires_grad=False)
            lin.bias = m.bias
            _replace(model, name, lin)
    return model


def lora_state(model: nn.Module) -> dict:
    """``{name: tensor}`` of the adapters and their scales."""
    return {k: v for k, v in model.state_dict().items()
            if k.rsplit(".", 1)[-1] in LORA_LEAVES}


def main(argv=None) -> None:
    """The merge CLI: the newest step of ``--input_path`` (a LoRA
    fine-tune's ``--save_ckpt_path``), merged, written to
    ``--output_path`` as ``model.safetensors`` with ``config.json`` from
    ``--config_path`` (a model directory or a config file; default
    ``config.json`` inside ``--input_path``). Without a config it
    warns, as the reference does: the serving loaders need one.

    The merge streams: the adapters are read first (a few MB), then
    each base tensor is read, merged on ``--device`` when it is an
    adapted weight, and written before the next is read, so the
    checkpoint never lies in host memory whole. The merge runs on the
    card unless ``--device cpu`` is passed."""
    import argparse
    import json
    import os
    import sys

    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.models.llama.convert import (
        SAFETENSORS_DTYPES, check_safetensors_complete, iter_safetensors,
        write_safetensors_stream)
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        PARAMS_FILE, latest_step)

    parser = argparse.ArgumentParser(description="merge lora weight")
    parser.add_argument("--input_path", required=True,
                        help="trainer checkpoint dir (save_ckpt_path)")
    parser.add_argument("--output_path", required=True,
                        help="location to write the merged checkpoint")
    parser.add_argument("--config_path", default=None,
                        help="model config dir/json to copy alongside "
                             "(defaults to config.json inside "
                             "--input_path if present)")
    parser.add_argument("--device", default=None,
                        help="where the merge runs (default cuda; "
                             "pass cpu to merge on the host)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    step = latest_step(args.input_path)
    if step is None:
        raise SystemExit(f"no checkpoint steps in {args.input_path}")
    src = os.path.join(args.input_path, str(step), PARAMS_FILE)
    header = check_safetensors_complete(src)
    names = [k for k in header if k != "__metadata__"]
    lora_names = {k for k in names if k.rsplit(".", 1)[-1] in LORA_LEAVES}
    adapters = {k: t.to(device) for k, t in iter_safetensors(src,
                                                             lora_names)}
    adapted = {k.rsplit(".", 1)[0] for k in adapters
               if k.endswith(".lora_a")}
    if not adapted:
        raise SystemExit("checkpoint params hold no LoRA adapters — "
                         "nothing to merge")
    base = [k for k in names if k not in lora_names]
    specs = [(k, SAFETENSORS_DTYPES[header[k]["dtype"]], header[k]["shape"])
             for k in base]

    def merged():
        for name, t in iter_safetensors(src, set(base)):
            prefix, leaf = name.rsplit(".", 1)
            if leaf == "weight" and prefix in adapted:
                t = merge_delta(t.to(device), adapters[prefix + ".lora_a"],
                                adapters[prefix + ".lora_b"],
                                adapters[prefix + ".lora_scale"])
            yield t

    out = os.path.abspath(args.output_path)
    os.makedirs(out, exist_ok=True)
    write_safetensors_stream(os.path.join(out, "model.safetensors"), specs,
                             merged())
    cfg_src = args.config_path or os.path.join(
        os.path.abspath(args.input_path), "config.json")
    if os.path.isdir(cfg_src):
        cfg_src = os.path.join(cfg_src, "config.json")
    if os.path.exists(cfg_src):
        with open(cfg_src) as f, \
                open(os.path.join(out, "config.json"), "w") as g:
            json.dump(json.load(f), g, indent=2)
    else:
        print("WARNING: no config.json found (trainer checkpoints "
              "don't carry one) — pass --config_path <model dir> to "
              "make the merged checkpoint loadable by the serving "
              "paths", file=sys.stderr, flush=True)
    print(f"merged lora -> {out} (step {step})", flush=True)


if __name__ == "__main__":
    main()
