"""Masked-LM evaluation: masked-token accuracy and cross-entropy over text, on one GPU.

Counterpart of the JAX package's ``examples/evaluate_mlm.py``: a UTF-8 text
is chunked into byte sequences, one set of positions a batch (drawn from
``--seed``) is replaced by the mask token, and the model's predictions are
scored at exactly those positions.  By default only the masked rows of the
decode run (``LanguagePerceiver(predict_positions=...)``, the same rows as
the full decode); ``--full-decode`` decodes every position and picks the
masked ones.

    python -m perceiverio_pytorch_tpu_torch.examples.evaluate_mlm [--text-file corpus.txt]
        [--checkpoint CKPT | --torch-checkpoint language_perceiver_io_bytes.pth]
        [--full-scale] [--mask-rate 0.15] [--full-decode]

Without ``--text-file`` it scores a built-in demo text.  ``--checkpoint`` is
a weights directory or a Trainer checkpoint, ``--torch-checkpoint`` a
reference-convention ``.pth``; with neither the weights are random (seed
0).  ``--full-scale`` is the published model in bf16 (``PERFORMANCE``);
the default is the JAX script's small configuration in fp32.  Prints one
JSON line: masked_accuracy, masked_ce, masked_tokens, sequences and
seq_per_sec (after the first batch).  ``--quant dynamic|static`` scores
under int8 projections (``Policy.quant``); ``static`` first calibrates each
projection on one batch of the first sequences, masked at positions drawn
from ``--seed`` (``ops.quant.calibrate``), as the JAX script does.  Runs on
the GPU unless the caller asks for the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import PERFORMANCE, Policy
from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
from perceiverio_pytorch_tpu_torch.ops.quant import calibrate
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.bytes_tokenizer import BytesTokenizer
from perceiverio_pytorch_tpu_torch.utils.compilation_cache import (
    add_cache_arg,
    enable_cache_if_requested,
)
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device

_DEMO_TEXT = (
    "This is an incomplete sentence where some words are missing from the "
    "middle and the model is asked to reconstruct the deleted bytes. "
) * 64

MASK_TOKEN = 3  # the byte tokenizer's reserved mask id, as in the reference

# The JAX script's small configuration (256 bytes).
SMALL = dict(max_seq_len=256, embed_dim=64, num_self_attends_per_block=4, num_latents=64,
             num_latent_channels=256)


def _chunks(text: str, seq_len: int, tokenizer: BytesTokenizer) -> np.ndarray:
    """The text's byte ids as [N, seq_len] rows (the tail dropped)."""
    ids = tokenizer.to_int(text)
    n = (len(ids) // seq_len) * seq_len
    if n == 0:
        raise ValueError(f"text too short: {len(ids)} tokens < seq_len {seq_len}")
    return np.asarray(ids[:n], np.int32).reshape(-1, seq_len)


def main(text_file=None, checkpoint=None, torch_checkpoint=None, full_scale=False,
         batch_size=8, mask_rate=0.15, seed=0, limit=None, partial_decode=True, quant=None,
         *, device="cuda"):
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    policy = PERFORMANCE if full_scale else Policy()
    if quant:
        policy = dataclasses.replace(policy, quant=f"int8_{quant}")
    if full_scale:
        model = LanguagePerceiver(policy=policy, device=device, generator=generator)
        seq_len = 2048
    else:
        model = LanguagePerceiver(**SMALL, policy=policy, device=device, generator=generator)
        seq_len = SMALL["max_seq_len"]
    restore_eval_variables(model, checkpoint, torch_checkpoint).eval()

    if text_file:
        with open(text_file) as f:
            text = f.read()
    else:
        text = _DEMO_TEXT
    seqs = _chunks(text, seq_len, BytesTokenizer())
    n_masked = max(1, int(round(mask_rate * seq_len)))
    if quant == "static":
        # Restored weights carry no useful amax: calibrate on one batch of
        # the first sequences, masked at positions of their own draw.
        calib = seqs[:batch_size].copy()
        calib[:, np.random.RandomState(seed).choice(seq_len, n_masked, replace=False)] = (
            MASK_TOKEN)
        calib = torch.from_numpy(calib).long().to(device)
        calibrate(model, [(calib, torch.ones_like(calib, dtype=torch.bool))])

    def scores(tokens, positions):
        corrupted = tokens.clone()
        corrupted[:, positions] = MASK_TOKEN
        valid = torch.ones_like(corrupted, dtype=torch.bool)
        if partial_decode:
            return model(corrupted, valid, predict_positions=positions)  # [B, P, vocab]
        return model(corrupted, valid)[:, positions]

    rng = np.random.RandomState(seed)
    correct = total = 0
    ce_sum = 0.0
    n_seqs = 0
    t0, timed = None, 0
    with torch.inference_mode():
        for start in range(0, (len(seqs) // batch_size) * batch_size, batch_size):
            gold_rows = seqs[start:start + batch_size]
            # one position set a batch, as the JAX script draws it
            positions = np.sort(rng.choice(seq_len, n_masked, replace=False))
            logits = scores(torch.from_numpy(gold_rows).long().to(device),
                            torch.from_numpy(positions).to(device))
            logits = logits.float().cpu().numpy()
            if t0 is None:
                t0 = time.perf_counter()  # the first batch's warm-up is not timed
            else:
                timed += batch_size
            gold = gold_rows[:, positions]
            correct += int((logits.argmax(-1) == gold).sum())
            total += gold.size
            shifted = logits - logits.max(-1, keepdims=True)
            lse = np.log(np.exp(shifted).sum(-1))
            ce_sum += float((lse - np.take_along_axis(shifted, gold[..., None], -1)[..., 0]).sum())
            n_seqs += batch_size
            if limit and n_seqs >= limit:
                break
    elapsed = time.perf_counter() - t0 if t0 else 0.0
    result = {
        "sequences": n_seqs,
        "masked_tokens": total,
        "masked_accuracy": round(correct / max(total, 1), 4),
        "masked_ce": round(ce_sum / max(total, 1), 4),
        "seq_per_sec": round(timed / elapsed, 1) if timed and elapsed > 0 else None,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--text-file", default=None,
                        help="UTF-8 corpus (default: a built-in demo text)")
    parser.add_argument("--checkpoint", default=None,
                        help="weights directory or Trainer checkpoint")
    parser.add_argument("--torch-checkpoint", default=None,
                        help="reference-convention .pth state dict")
    parser.add_argument("--full-scale", action="store_true",
                        help="the published 2048-byte model, bf16")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--mask-rate", type=float, default=0.15)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit", type=int, default=None,
                        help="stop after this many sequences")
    parser.add_argument("--full-decode", action="store_true",
                        help="decode every position instead of only the masked ones"
                             " (the same numbers, more work)")
    parser.add_argument("--quant", nargs="?", const="dynamic", default=None,
                        choices=["dynamic", "static"],
                        help="int8 projections (static: calibrated on the first batch)")
    parser.add_argument("--device", default="cuda")
    add_cache_arg(parser)
    args = parser.parse_args()
    enable_cache_if_requested(args)
    main(text_file=args.text_file, checkpoint=args.checkpoint,
         torch_checkpoint=args.torch_checkpoint, full_scale=args.full_scale,
         batch_size=args.batch_size, mask_rate=args.mask_rate, seed=args.seed,
         limit=args.limit, partial_decode=not args.full_decode, quant=args.quant,
         device=args.device)
