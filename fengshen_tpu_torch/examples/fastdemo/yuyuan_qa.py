"""YuyuanQA interactive demo: the port of
``fengshen_tpu/examples/fastdemo/yuyuan_qa.py`` (reference:
``fengshen/examples/FastDemo/YuyuanQA.py``).

:func:`answer` (:14) puts a question in the ``"Question:... Answer:"``
format, decodes greedily through ``utils/generate.generate`` (GPT-2's
KV cache, stopping at the tokenizer's ``eos_token_id``) and returns the
new tokens decoded. :func:`main` (:30) loads ``--model_path`` through
``models/gpt2/convert.load_hf_pretrained`` onto ``--device`` (default
``cuda``, which raises without a card), the tokenizer through
``AutoTokenizer`` unless the caller gives one, and answers the lines of
standard input until an empty one.

Run:
    echo "What is a cold?" | python -m \\
        fengshen_tpu_torch.examples.fastdemo.yuyuan_qa --model_path <dir>
"""

from __future__ import annotations

import argparse
import sys


def answer(model, tokenizer, question: str,
           max_new_tokens: int = 64) -> str:
    from fengshen_tpu_torch.utils.generate import generate

    prompt = f"Question:{question} Answer:"
    ids = tokenizer.encode(prompt, add_special_tokens=False)
    out = generate(model, [ids], max_new_tokens=max_new_tokens,
                   eos_token_id=tokenizer.eos_token_id,
                   device=model.device)
    new_tokens = out[0, len(ids):].tolist()
    return tokenizer.decode(new_tokens, skip_special_tokens=True).strip()


def main(argv=None, tokenizer=None):
    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.models.gpt2.convert import load_hf_pretrained

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", required=True, type=str)
    parser.add_argument("--max_new_tokens", default=64, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="default cuda (raises without a card); "
                             "'cpu' runs on the CPU")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if tokenizer is None:
        from fengshen_tpu_torch.pipelines.text_generation import (
            auto_tokenizer)
        tokenizer = auto_tokenizer(args.model_path)
    _, model = load_hf_pretrained(args.model_path, device=device)

    print("YuyuanQA demo — type a question, empty line to exit")
    for line in sys.stdin:
        q = line.strip()
        if not q:
            break
        print(answer(model, tokenizer, q,
                     max_new_tokens=args.max_new_tokens), flush=True)


if __name__ == "__main__":
    main()
