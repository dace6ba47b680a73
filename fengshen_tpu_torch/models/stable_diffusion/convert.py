"""Stable Diffusion checkpoint conversion: the port of
``fengshen_tpu/models/stable_diffusion/convert.py``.

1. :func:`diffusers_to_original` (with :func:`convert_unet_state_dict`
   and :func:`convert_vae_state_dict`): a diffusers pipeline's state
   dicts remapped into the original CompVis single-checkpoint layout
   (the reference's ``convert_diffusers_to_original_stable_diffusion.py``
   :17-235), the VAE mid-attention projections reshaped to 1x1 convs.
2. :func:`unet_to_params` / :func:`vae_to_params` /
   :func:`load_diffusers_pipeline`: released diffusers weights into the
   port's SD-1.x towers. The port's modules carry diffusers' names, so
   the import is the identity but for the old (<0.17) VAE attention
   names (``query`` / ``key`` / ``value`` / ``proj_attn``), which are
   renamed; :func:`unet_params_to_diffusers` and
   :func:`vae_params_to_diffusers` export back under a template's names.
   Weight files are read as the JAX loader picks them:
   ``diffusion_pytorch_model.safetensors`` (the port's own reader), else
   the shards, else ``*.bin`` through ``torch.load(weights_only=True,
   mmap=True)``.
3. :func:`text_encoder_to_params`: the Taiyi text encoder (an HF
   ``BertModel`` state dict) into the port's ``text_encoder``.
4. :func:`params_from_jax`: the JAX package's flax tree of any of the
   three towers (or of the whole ``TaiyiStableDiffusion``) into the
   port's state dict: HWIO conv kernels to OIHW, Dense kernels
   transposed, ``scale`` to ``weight``, and the flax module names
   (``down_blocks_0``, ``to_out_0``) to the port's (``down_blocks.0``,
   ``to_out.0``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Any, Mapping

import numpy as np
import torch

from fengshen_tpu_torch.utils.convert_common import (iter_safetensors,
                                                     tensor)

# -- (stable-diffusion, diffusers) fixed renames (reference :17-29) ---------
_UNET_TOP = [
    ("time_embed.0.", "time_embedding.linear_1."),
    ("time_embed.2.", "time_embedding.linear_2."),
    ("input_blocks.0.0.", "conv_in."),
    ("out.0.", "conv_norm_out."),
    ("out.2.", "conv_out."),
]

_UNET_RESNET = [
    ("in_layers.0.", "norm1."),
    ("in_layers.2.", "conv1."),
    ("out_layers.0.", "norm2."),
    ("out_layers.3.", "conv2."),
    ("emb_layers.1.", "time_emb_proj."),
    ("skip_connection.", "conv_shortcut."),
]


def _unet_layer_map() -> list[tuple[str, str]]:
    """Block-index arithmetic between the two layouts (reference :41-90)."""
    pairs = []
    for i in range(4):
        for j in range(2):
            pairs.append((f"input_blocks.{3 * i + j + 1}.0.",
                          f"down_blocks.{i}.resnets.{j}."))
            if i < 3:
                pairs.append((f"input_blocks.{3 * i + j + 1}.1.",
                              f"down_blocks.{i}.attentions.{j}."))
        for j in range(3):
            pairs.append((f"output_blocks.{3 * i + j}.0.",
                          f"up_blocks.{i}.resnets.{j}."))
            if i > 0:
                pairs.append((f"output_blocks.{3 * i + j}.1.",
                              f"up_blocks.{i}.attentions.{j}."))
        if i < 3:
            pairs.append((f"input_blocks.{3 * (i + 1)}.0.op.",
                          f"down_blocks.{i}.downsamplers.0.conv."))
            pairs.append((f"output_blocks.{3 * i + 2}."
                          f"{1 if i == 0 else 2}.",
                          f"up_blocks.{i}.upsamplers.0."))
    pairs.append(("middle_block.1.", "mid_block.attentions.0."))
    for j in range(2):
        pairs.append((f"middle_block.{2 * j}.", f"mid_block.resnets.{j}."))
    return pairs


def convert_unet_state_dict(unet_state: Mapping[str, Any]) -> dict:
    """diffusers UNet keys -> original SD keys (reference :93-110)."""
    mapping = {k: k for k in unet_state}
    for sd_name, hf_name in _UNET_TOP:
        for k in list(mapping):
            if k.startswith(hf_name):
                mapping[k] = sd_name + k[len(hf_name):]
    for k, v in mapping.items():
        if "resnets" in k:
            for sd_part, hf_part in _UNET_RESNET:
                v = v.replace(hf_part, sd_part)
            mapping[k] = v
    layer_map = _unet_layer_map()
    for k, v in mapping.items():
        for sd_part, hf_part in layer_map:
            v = v.replace(hf_part, sd_part)
        mapping[k] = v
    return {v: unet_state[k] for k, v in mapping.items()}


def _vae_map() -> list[tuple[str, str]]:
    pairs = [
        ("nin_shortcut", "conv_shortcut"),
        ("norm_out", "conv_norm_out"),
        ("mid.attn_1.", "mid_block.attentions.0."),
    ]
    for i in range(4):
        for j in range(2):
            pairs.append((f"encoder.down.{i}.block.{j}.",
                          f"encoder.down_blocks.{i}.resnets.{j}."))
        if i < 3:
            pairs.append((f"down.{i}.downsample.",
                          f"down_blocks.{i}.downsamplers.0."))
            pairs.append((f"up.{3 - i}.upsample.",
                          f"up_blocks.{i}.upsamplers.0."))
        for j in range(3):
            pairs.append((f"decoder.up.{3 - i}.block.{j}.",
                          f"decoder.up_blocks.{i}.resnets.{j}."))
    for i in range(2):
        pairs.append((f"mid.block_{i + 1}.", f"mid_block.resnets.{i}."))
    return pairs


_VAE_ATTN = [
    ("norm.", "group_norm."),
    ("q.", "query."),
    ("k.", "key."),
    ("v.", "value."),
    ("proj_out.", "proj_attn."),
]


def convert_vae_state_dict(vae_state: Mapping[str, Any]) -> dict:
    """diffusers VAE keys -> original SD keys, the mid-attention linear
    weights reshaped to 1x1 convs (reference :167-186)."""
    mapping = {k: k for k in vae_state}
    vae_map = _vae_map()
    for k, v in mapping.items():
        for sd_part, hf_part in vae_map:
            v = v.replace(hf_part, sd_part)
        mapping[k] = v
    for k, v in mapping.items():
        if "attentions" in k:
            for sd_part, hf_part in _VAE_ATTN:
                v = v.replace(hf_part, sd_part)
            mapping[k] = v
    out = {v: vae_state[k] for k, v in mapping.items()}
    patterns = tuple(f"mid.attn_1.{n}.weight" for n in
                     ("q", "k", "v", "proj_out"))
    for key, w in list(out.items()):
        if any(p in key for p in patterns):
            w = torch.as_tensor(np.asarray(w)) if not torch.is_tensor(w) \
                else w.detach().cpu()
            out[key] = w.reshape(*w.shape, 1, 1).clone()
    return out


def diffusers_to_original(unet_state: Mapping[str, Any],
                          vae_state: Mapping[str, Any],
                          text_enc_state: Mapping[str, Any]) -> dict:
    """The single original-format checkpoint dict (reference :212-233;
    the text encoder only gains its prefix)."""
    out = {}
    out.update({"model.diffusion_model." + k: v for k, v in
                convert_unet_state_dict(unet_state).items()})
    out.update({"first_stage_model." + k: v for k, v in
                convert_vae_state_dict(vae_state).items()})
    out.update({"cond_stage_model.transformer." + k: v
                for k, v in text_enc_state.items()})
    return out


# -- diffusers state dicts <-> the port's towers --------------------------

#: old-diffusers (<0.17) VAE attention names -> current ones (the
#: released 2022-era Taiyi-SD weights use the old ones)
_OLD_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
             "proj_attn": "to_out.0"}
_OLD_ATTN_RE = re.compile(r"\.(query|key|value|proj_attn)\.")


def _current_name(key: str) -> str:
    return _OLD_ATTN_RE.sub(lambda m: f".{_OLD_ATTN[m.group(1)]}.", key)


def diffusers_tower_to_params(state_dict: Mapping[str, Any]) -> dict:
    """A diffusers tower's state dict -> the port's (fp32 CPU tensors):
    the same names, the old VAE attention names renamed."""
    return {_current_name(k): tensor(state_dict, k) for k in state_dict}


def unet_to_params(state_dict: Mapping[str, Any], config=None) -> dict:
    """A diffusers ``UNet2DConditionModel`` state dict -> the port's
    ``SDUNet2DConditionModel`` state dict."""
    return diffusers_tower_to_params(state_dict)


def vae_to_params(state_dict: Mapping[str, Any], config=None) -> dict:
    """A diffusers ``AutoencoderKL`` state dict -> the port's
    ``SDAutoencoderKL`` state dict."""
    return diffusers_tower_to_params(state_dict)


def _export(params: Mapping[str, Any], template_state=None) -> dict:
    """The port's tower state dict -> diffusers' (CPU tensors), under
    ``template_state``'s names (old or new attention naming) when one is
    given."""
    names = list(template_state) if template_state is not None \
        else list(params)
    return {k: params[_current_name(k)].detach().cpu().clone()
            for k in names}


def unet_params_to_diffusers(params: Mapping[str, Any],
                             template_state=None, config=None) -> dict:
    return _export(params, template_state)


def vae_params_to_diffusers(params: Mapping[str, Any],
                            template_state=None, config=None) -> dict:
    return _export(params, template_state)


def _config_from(cls, cfg: Mapping[str, Any]):
    keep = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in cfg.items() if k in keep and k != "dtype"})


def sd_unet_config_from_diffusers(cfg: Mapping[str, Any]):
    """diffusers ``unet/config.json`` -> ``SDUNetConfig``."""
    from fengshen_tpu_torch.models.stable_diffusion.unet_sd import \
        SDUNetConfig
    return _config_from(SDUNetConfig, cfg)


def sd_vae_config_from_diffusers(cfg: Mapping[str, Any]):
    """diffusers ``vae/config.json`` -> ``SDVAEConfig``."""
    from fengshen_tpu_torch.models.stable_diffusion.vae_sd import \
        SDVAEConfig
    return _config_from(SDVAEConfig, cfg)


def load_weight_files(tower_dir: str,
                      stem: str = "diffusion_pytorch_model") -> dict:
    """A tower directory's weights, as the JAX loader picks them: the
    exact ``{stem}.safetensors``, else its shards (variants ``.fp16`` /
    ``.non_ema`` only when nothing else exists), else ``{stem}*.bin``
    through ``torch.load(weights_only=True, mmap=True)``."""
    exact = os.path.join(tower_dir, f"{stem}.safetensors")
    every = sorted(glob.glob(os.path.join(tower_dir,
                                          f"{stem}*.safetensors")))
    files = [exact] if os.path.exists(exact) else [
        f for f in every if ".fp16." not in f and ".non_ema." not in f
    ] or every
    state: dict = {}
    if files:
        for f in files:
            state.update(iter_safetensors(f))
        return state
    for f in sorted(glob.glob(os.path.join(tower_dir, f"{stem}*.bin"))):
        state.update(torch.load(f, map_location="cpu", weights_only=True,
                                mmap=True))
    if not state:
        raise FileNotFoundError(
            f"no {stem}*.safetensors or {stem}*.bin in {tower_dir!r}")
    return state


def load_diffusers_pipeline(model_path: str) -> tuple:
    """A released diffusers SD pipeline directory -> ``(unet_config,
    unet_state, vae_config, vae_state)`` (reference ``finetune.py``
    :81-89, ``StableDiffusionPipeline.from_pretrained``)."""
    def load_tower(sub):
        with open(os.path.join(model_path, sub, "config.json")) as f:
            cfg = json.load(f)
        return cfg, load_weight_files(os.path.join(model_path, sub))

    unet_cfg, unet_state = load_tower("unet")
    vae_cfg, vae_state = load_tower("vae")
    return (sd_unet_config_from_diffusers(unet_cfg),
            unet_to_params(unet_state),
            sd_vae_config_from_diffusers(vae_cfg),
            vae_to_params(vae_state))


def resolve_towers(sd_pipeline_path=None, faithful: bool = False,
                   small_test: bool = False) -> tuple:
    """The towers of the SD entry points: ``(unet_config, vae_config,
    pipeline_state)``, the last ``{"unet": ..., "vae": ...}`` when a
    released diffusers directory was given, else None."""
    if sd_pipeline_path:
        unet_cfg, unet_state, vae_cfg, vae_state = \
            load_diffusers_pipeline(sd_pipeline_path)
        return unet_cfg, vae_cfg, {"unet": unet_state, "vae": vae_state}
    if faithful:
        from fengshen_tpu_torch.models.stable_diffusion.unet_sd import \
            SDUNetConfig
        from fengshen_tpu_torch.models.stable_diffusion.vae_sd import \
            SDVAEConfig
        if small_test:
            return (SDUNetConfig.small_test_config(),
                    SDVAEConfig.small_test_config(), None)
        return SDUNetConfig(), SDVAEConfig(), None
    from fengshen_tpu_torch.models.stable_diffusion.autoencoder_kl import \
        VAEConfig
    from fengshen_tpu_torch.models.stable_diffusion.unet import UNetConfig
    if small_test:
        return (UNetConfig.small_test_config(),
                VAEConfig.small_test_config(), None)
    return UNetConfig(), VAEConfig(), None


def text_encoder_to_params(state_dict: Mapping[str, Any],
                           text_config) -> dict:
    """The Taiyi text encoder (an HF ``BertModel`` state dict, with or
    without the ``bert.`` prefix) -> the port's ``text_encoder`` state
    dict."""
    from fengshen_tpu_torch.models.bert.convert import torch_to_params
    if not any(k.startswith("bert.") for k in state_dict):
        state_dict = {f"bert.{k}": v for k, v in state_dict.items()}
    state = torch_to_params(state_dict, text_config)
    return {k[len("bert."):]: tensor(state, k) for k in state
            if k.startswith("bert.")}


#: flax module names that are a ModuleList entry in the port
#: (``down_blocks_0`` -> ``down_blocks.0``)
_LIST_RE = re.compile(r"^(down_blocks|up_blocks|resnets|attentions|"
                      r"downsamplers|upsamplers|transformer_blocks|to_out|"
                      r"net)_(\d+)$")


def _jax_leaf(name: str, value) -> tuple:
    arr = np.array(value, dtype=np.float32)
    if name == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        return "weight", arr
    return ("weight" if name in ("scale", "embedding") else name), arr


def _tower_from_jax(tree: Mapping, prefix: str = "") -> dict:
    out: dict = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            m = _LIST_RE.match(key)
            name = f"{m.group(1)}.{m.group(2)}" if m else key
            out.update(_tower_from_jax(value, f"{prefix}{name}."))
        else:
            leaf, arr = _jax_leaf(key, value)
            out[prefix + leaf] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out


def params_from_jax(params: Mapping, config=None) -> dict:
    """The JAX package's flax params of a ``TaiyiStableDiffusion`` (its
    ``text_encoder`` / ``vae`` / ``unet`` subtrees) or of one tower ->
    the port's state dict of fp32 tensors."""
    from fengshen_tpu_torch.models.bert.convert import params_from_jax \
        as bert_from_jax
    if "text_encoder" in params or "unet" in params or "vae" in params:
        out = {}
        for tower, sub in params.items():
            state = bert_from_jax(sub, None) if tower == "text_encoder" \
                else _tower_from_jax(sub)
            out.update({f"{tower}.{k}": v for k, v in state.items()})
        return out
    return _tower_from_jax(params)


def main(argv=None):
    """The reference CLI (:199-235): a diffusers pipeline directory ->
    one original-format ``.ckpt``."""
    import argparse
    import os.path as osp

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--half", action="store_true")
    args = parser.parse_args(argv)

    def load(*p):
        return torch.load(osp.join(*p), map_location="cpu",
                          weights_only=True)

    state = diffusers_to_original(
        load(args.model_path, "unet", "diffusion_pytorch_model.bin"),
        load(args.model_path, "vae", "diffusion_pytorch_model.bin"),
        load(args.model_path, "text_encoder", "pytorch_model.bin"))
    if args.half:
        state = {k: v.half() for k, v in state.items()}
    torch.save({"state_dict": state}, args.checkpoint_path)


if __name__ == "__main__":
    main()
