"""A DeepSpeed or Lightning ``.ckpt`` -> a bare ``pytorch_model.bin``:
the port of ``fengshen_tpu/examples/pretrain_t5/convert_ckpt_to_bin.py``
(driven by ``convert_ckpt_randeng_t5_char.sh``).

The wrapped state dict (``["module"]`` of a DeepSpeed ``mp_rank`` file,
``["state_dict"]`` of a Lightning one, else the file itself) is saved
with ``--rm_prefix`` stripped from its names, for the families'
converters and HF loaders to read. No device is used.
"""

from __future__ import annotations

import argparse


def strip_prefix(state_dict: dict, prefix) -> dict:
    """Every entry, ``prefix`` removed from the names that start with
    it (:17)."""
    if not prefix:
        return dict(state_dict)
    n = len(prefix)
    return {(k[n:] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}


def main(argv=None) -> int:
    """Convert; return the number of tensors saved."""
    import torch

    parser = argparse.ArgumentParser("Pretrain Unsupervise.")
    parser.add_argument("--ckpt_path", default=None, type=str)
    parser.add_argument("--bin_path", default=None, type=str)
    parser.add_argument("--rm_prefix", default=None, type=str)
    args = parser.parse_args(argv)

    # a DeepSpeed or Lightning checkpoint holds more than tensors
    raw = torch.load(args.ckpt_path, map_location="cpu",
                     weights_only=False)
    state_dict = raw.get("module", raw.get("state_dict", raw)) \
        if isinstance(raw, dict) else raw
    torch.save(strip_prefix(state_dict, args.rm_prefix), args.bin_path)
    print(f"saved {len(state_dict)} tensors -> {args.bin_path}")
    return len(state_dict)


if __name__ == "__main__":
    main()
