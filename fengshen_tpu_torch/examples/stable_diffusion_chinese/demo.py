"""Taiyi Stable Diffusion Chinese txt2img demo: the port of
``fengshen_tpu/examples/stable_diffusion_chinese/demo.py`` (:13-79).

Prompt -> classifier-free-guided DDPM sampling -> an image, written as
a PNG where Pillow is installed (as the JAX demo does) and returned as
``[B, H, W, 3]`` floats in [0, 1] either way. Without ``model=`` the
demo builds the compact towers at test size; without ``tokenizer=`` it
encodes the prompt with the toy character encoding
(``examples/demo_utils.toy_encode``) and guides against all-padding
ids.

Run (on the card; ``--device cpu`` for the CPU):
    python -m fengshen_tpu_torch.examples.stable_diffusion_chinese.demo \\
        --prompt "飞流直下三千尺，油画" --image_size 64 --num_steps 20
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None, model=None, params=None, tokenizer=None,
         image_size=None, num_steps=None, generator=None,
         step_callback=None):
    """``params`` (a state dict) is loaded into ``model`` when given;
    ``generator`` draws the initial latents (default seed 0);
    ``step_callback(i)`` runs after each denoise step."""
    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.models.stable_diffusion.sampling import \
        text_to_image

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--prompt", type=str, default="飞流直下三千尺，油画")
    parser.add_argument("--negative_prompt", type=str, default="")
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--num_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--out", type=str, default="out.png")
    parser.add_argument("--device", type=str, default=None,
                        help="default cuda (raises without a card)")
    args = parser.parse_args(argv)
    if image_size is not None:
        args.image_size = image_size
    if num_steps is not None:
        args.num_steps = num_steps

    if model is None:
        # demo-scale towers when no model is given
        from fengshen_tpu_torch.models.bert import BertConfig
        from fengshen_tpu_torch.models.stable_diffusion.autoencoder_kl \
            import VAEConfig
        from fengshen_tpu_torch.models.stable_diffusion.modeling_taiyi_sd \
            import TaiyiStableDiffusion
        from fengshen_tpu_torch.models.stable_diffusion.unet import \
            UNetConfig
        model = TaiyiStableDiffusion(
            BertConfig.small_test_config(), VAEConfig.small_test_config(),
            UNetConfig.small_test_config(),
            device=resolve_device(args.device))
    if params is not None:
        model.load_state_dict(params)
    device = next(model.parameters()).device

    if tokenizer is not None:
        ids = torch.tensor([tokenizer.encode(args.prompt)])
        neg = torch.tensor([tokenizer.encode(args.negative_prompt or "")])
        if neg.shape[1] != ids.shape[1]:
            pad = tokenizer.pad_token_id or 0
            full = torch.full_like(ids, pad)
            n = min(neg.shape[1], ids.shape[1])
            full[:, :n] = neg[:, :n]
            neg = full
    else:
        from fengshen_tpu_torch.examples.demo_utils import toy_encode
        ids = torch.tensor([toy_encode(args.prompt)])
        neg = torch.zeros_like(ids)

    images = text_to_image(model, ids.to(device), uncond_ids=neg.to(device),
                           image_size=args.image_size,
                           num_steps=args.num_steps,
                           guidance_scale=args.guidance_scale,
                           generator=generator, step_callback=step_callback)
    images = images.float().cpu().numpy()
    try:
        from PIL import Image
    except ImportError:
        return images
    Image.fromarray((images[0] * 255).astype(np.uint8)).save(args.out)
    print(f"saved {args.out}")
    return images


if __name__ == "__main__":
    main()
