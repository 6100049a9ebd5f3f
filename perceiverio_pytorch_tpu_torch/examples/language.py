"""Byte-level masked language modelling demo: the published MLM fills a gap.

Counterpart of the JAX package's ``examples/language.py`` (the reference's
``example_language.py``): ``LanguagePerceiver`` at full width over 2,048
bytes; " missing." (bytes 51:60 of the sentence) is masked and the
predictions there are decoded greedily.

    python -m perceiverio_pytorch_tpu_torch.examples.language \\
        [--checkpoint language.pth | --random-init]

``--checkpoint`` is a reference-convention ``.pth``, loaded strictly
(default: the JAX demo's path); ``--random-init`` draws seeded weights
instead.  Runs on the GPU unless asked for the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.bytes_tokenizer import BytesTokenizer, pad_sequence
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device

CKPT_FILE = "./pytorch_checkpoints/language_perceiver_io_bytes.pth"
MAX_SEQ_LEN = 2048


def language_example(random_init: bool = False, checkpoint: str = CKPT_FILE, *,
                     device="cuda", seed: int = 0) -> str:
    """The greedy prediction of the masked bytes, as a string."""
    device = resolve_device(device)
    if not random_init and not os.path.isfile(checkpoint):
        raise ValueError(
            "Please download the converted checkpoint and place it in"
            " ./pytorch_checkpoints (see README), or pass --random-init for"
            " an untrained demo run."
        )
    tokenizer = BytesTokenizer()
    model = LanguagePerceiver(vocab_size=tokenizer.vocab_size, device=device,
                              generator=torch.Generator().manual_seed(seed))
    if not random_init:
        restore_eval_variables(model, torch_checkpoint=checkpoint)
    model.eval()

    input_str = "This is an incomplete sentence where some words are missing."
    input_tokens = tokenizer.to_int(input_str)
    # Mask " missing.". The model performs much better if the masked chunk
    # starts with a space.
    input_tokens[51:60] = tokenizer.mask_token
    print("Tokenized string without masked bytes:")
    print(tokenizer.to_string(input_tokens))

    inputs = input_tokens[None]
    inputs, input_mask = pad_sequence(MAX_SEQ_LEN, inputs, np.ones_like(inputs),
                                      tokenizer.pad_token)
    with torch.inference_mode():
        out = model(torch.as_tensor(inputs, dtype=torch.long, device=device),
                    torch.as_tensor(input_mask, dtype=torch.bool, device=device))

    masked_tokens_predictions = out[0, 51:60].argmax(dim=-1).cpu().numpy()
    print("Greedy predictions:")
    print(masked_tokens_predictions)
    print("Predicted string:")
    print(tokenizer.to_string(masked_tokens_predictions))
    return tokenizer.to_string(masked_tokens_predictions)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--random-init", action="store_true",
                        help="run with seeded untrained weights")
    parser.add_argument("--checkpoint", default=CKPT_FILE, help="reference-convention .pth")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    language_example(random_init=args.random_init, checkpoint=args.checkpoint,
                     device=args.device, seed=args.seed)
