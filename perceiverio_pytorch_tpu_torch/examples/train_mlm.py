"""Training demo: byte-level masked language modelling, on one GPU.

Counterpart of the JAX package's ``examples/train_mlm.py``: random byte
strings with a learnable regularity (every 8th byte repeats its
predecessor), 15% of the positions replaced by the mask token, and the
cross-entropy taken on exactly those positions against the original bytes.
The corpus, the evaluation set and the batch order come from the same
numpy recipe and seeds as the JAX example's.  The Trainer evaluates on
``synthetic_corpus(2 * batch_size, seed=1)`` every ``steps // 2`` updates.

The default configuration is tiny (256 bytes, 64-channel embedding, 64
latents x 256, 4 self-attends; seconds on a CPU).  ``--full-scale`` trains
the published model (2,048 bytes, 768-channel embedding, 256 latents x 1280,
26 self-attends, the tied token table) under the bf16 ``PERFORMANCE``
policy at batch 8.  Every attention site of the language model takes the
dense path: no flash kernel runs.

    python -m perceiverio_pytorch_tpu_torch.examples.train_mlm --steps 50 [--full-scale]

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).  Not ported: ``--mesh``, ``--fsdp``,
``--checkpoint-dir``, ``--resume``, ``--steps-per-call``, ``--quant``,
``--lora``, ``--text-file`` (with ``--mask-rate``) and
``--async-checkpoint``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import DEFAULT, PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    batch_iterator,
    build_optimizer,
    epoch_batches,
    masked_token_cross_entropy,
)

TINY = dict(embed_dim=64, num_self_attends_per_block=4, num_latents=64,
            num_latent_channels=256)
TINY_SEQ_LEN = 256
FULL_SCALE_SEQ_LEN = 2048
VOCAB = 262


def synthetic_corpus(n: int, seq_len: int, vocab: int, seed: int = 0):
    """Corpus + MLM corruption: 15% of positions are replaced by MASK (=3,
    the byte tokenizer's reserved id) and the loss is computed on exactly
    those positions against the original tokens."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(6, vocab, (n, seq_len)).astype(np.int32)
    # plant a learnable regularity: every 8th token repeats its predecessor
    tokens[:, 7::8] = tokens[:, 6::8]
    mlm_mask = rng.rand(n, seq_len) < 0.15
    corrupted = np.where(mlm_mask, 3, tokens).astype(np.int32)
    return corrupted, tokens, mlm_mask


def loss_fn(model, corrupted, targets, mlm_mask):
    """The masked-token cross-entropy of one batch; every input position is
    valid (no padding), the MLM mask selects the positions that count."""
    logits = model(corrupted, torch.ones_like(corrupted, dtype=torch.bool))
    return masked_token_cross_entropy(logits, targets, mlm_mask)


def setup(steps=50, batch_size=8, full_scale=False, *, device="cuda",
          metrics_path="./mlm_metrics.jsonl", log_every=10):
    """The example's trainer, initial state, batch stream and evaluation
    batches: ``(trainer, state, batches, eval_batches)``, where
    ``batches(start_step)`` yields batches on ``device`` and
    ``eval_batches`` is a list of them.  Weights are drawn from seed 0."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    if full_scale:
        seq_len = FULL_SCALE_SEQ_LEN
        model = LanguagePerceiver(policy=PERFORMANCE, device=device, generator=generator)
    else:
        seq_len = TINY_SEQ_LEN
        model = LanguagePerceiver(max_seq_len=seq_len, **TINY, policy=DEFAULT, device=device,
                                  generator=generator)
    corpus = synthetic_corpus(1024, seq_len, VOCAB)
    held_out = synthetic_corpus(2 * batch_size, seq_len, VOCAB, seed=1)

    def on_device(batch):
        return tuple(torch.from_numpy(a).to(device) for a in batch)

    trainer = Trainer(
        loss_fn,
        build_optimizer(3e-4, schedule="cosine", total_steps=steps,
                        warmup_steps=max(steps // 10, 1), clip_norm=1.0),
        metrics_path=metrics_path,
        log_every=log_every,
        eval_fn=loss_fn,
        eval_every=max(steps // 2, 1),
    )
    eval_batches = [on_device(b) for b in epoch_batches(held_out, batch_size)]

    def batches(start_step=0):
        for batch in batch_iterator(corpus, batch_size, shuffle=True, epochs=None,
                                    start_batch=start_step):
            yield on_device(batch)

    return trainer, trainer.init_state(model), batches, eval_batches


def main(steps=50, batch_size=8, full_scale=False, *, device="cuda",
         metrics_path="./mlm_metrics.jsonl"):
    trainer, state, batches, eval_batches = setup(steps, batch_size, full_scale,
                                                  device=device, metrics_path=metrics_path)
    state = trainer.fit(state, batches, num_steps=steps, eval_batches=eval_batches)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--full-scale", action="store_true",
                        help="published 2048-byte config, bf16")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, full_scale=args.full_scale, device=args.device)
