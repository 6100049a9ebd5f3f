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

``--text-file`` (a path or a glob) trains on byte-token windows of a real
corpus instead (``TextFileDataset`` and ``MLMDataset``: fresh masks each
epoch at ``--mask-rate``); the last ``2 * batch`` windows are held out,
masked with seed 1.  ``--checkpoint-dir`` saves the train state every
``steps // 2`` updates (by a thread with ``--async-checkpoint``) and
``--resume`` goes on from the newest save there.  ``--lora R`` freezes the
model and trains rank-R adapters on its attention and MLP projections
instead (``training.lora``: the ``LoRA`` module is the train state's model,
the loss and the evaluation run the frozen model with the adapters merged).
``--steps-per-call K`` runs K updates per call of the Trainer's step
(``Trainer(steps_per_call=K)``: K eager steps, the same updates).

    python -m perceiverio_pytorch_tpu_torch.examples.train_mlm --steps 50 [--full-scale] \
        [--text-file FILE [--mask-rate R]] [--checkpoint-dir DIR [--resume]] [--lora R] \
        [--steps-per-call K]

``--quant dynamic|static`` is quantization-aware training: the forward runs
the int8 projections a deployment runs (``Policy.quant``), the backward the
exact products' gradients.  ``static`` calibrates every projection's
``amax`` first on the first batch of the training data, the batch the JAX
example initialises (and so calibrates) with, and keeps it through training.

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).  Not ported: ``--mesh`` and ``--fsdp``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import DEFAULT, PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
from perceiverio_pytorch_tpu_torch.ops.quant import calibrate
from perceiverio_pytorch_tpu_torch.training import (
    MLMDataset,
    Subset,
    TextFileDataset,
    Trainer,
    batch_iterator,
    build_optimizer,
    dataset_iterator,
    epoch_batches,
    init_lora,
    masked_token_cross_entropy,
    wrap_loss,
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


def text_datasets(text_file, seq_len, batch_size, mask_rate=0.15):
    """The masked training windows of a corpus and the held-out batch
    fields: the last ``2 * batch_size`` windows (fewer when the corpus is
    small), masked with seed 1."""
    windows = TextFileDataset(text_file, seq_len=seq_len)
    n_eval = min(2 * batch_size, max(len(windows) - batch_size, 0))
    train = MLMDataset(Subset(windows, range(len(windows) - n_eval)), mask_rate=mask_rate)
    print(f"{len(windows)} windows of {seq_len} tokens from {text_file}"
          f" ({len(train)} train / {n_eval} eval)")
    if not n_eval:
        return train, next(dataset_iterator(train, batch_size, num_workers=0))
    held = MLMDataset(Subset(windows, range(len(windows) - n_eval, len(windows))),
                      mask_rate=mask_rate, seed=1)
    return train, tuple(np.stack(f) for f in zip(*[held[i] for i in range(n_eval)]))


def setup(steps=50, batch_size=8, full_scale=False, *, device="cuda",
          metrics_path="./mlm_metrics.jsonl", log_every=10, text_file=None, mask_rate=0.15,
          checkpoint_dir=None, checkpoint_every=None, checkpoint_async=False, prefetch=0, seed=0,
          lora_rank=0, steps_per_call=1, quant=None):
    """The example's trainer, initial state, batch stream and evaluation
    batches: ``(trainer, state, batches, eval_batches)``, where
    ``batches(start_step)`` yields batches on ``device`` (with ``prefetch``
    > 0, host batches that the Trainer copies there ahead of the step) and
    ``eval_batches`` is a list of batches on ``device``.
    ``checkpoint_every`` defaults to ``steps // 2`` when ``checkpoint_dir``
    is given.  Weights are drawn from ``seed``.  With ``lora_rank`` the
    state's model is the ``LoRA`` adapters of the frozen language model
    (their ``a`` drawn from ``seed + 1``), which the loss and evaluation
    functions take.  ``steps_per_call`` goes to the Trainer.  ``quant``
    ("dynamic" or "static") trains the int8 model (static: calibrated on
    the first training batch)."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    policy = PERFORMANCE if full_scale else DEFAULT
    if quant:
        policy = dataclasses.replace(policy, quant=f"int8_{quant}")
    if full_scale:
        seq_len = FULL_SCALE_SEQ_LEN
        model = LanguagePerceiver(policy=policy, device=device, generator=generator)
    else:
        seq_len = TINY_SEQ_LEN
        model = LanguagePerceiver(max_seq_len=seq_len, **TINY, policy=policy, device=device,
                                  generator=generator)
    dataset = None
    if text_file is not None:
        dataset, held_out = text_datasets(text_file, seq_len, batch_size, mask_rate)
    else:
        corpus = synthetic_corpus(1024, seq_len, VOCAB)
        held_out = synthetic_corpus(2 * batch_size, seq_len, VOCAB, seed=1)

    def on_device(batch):
        return tuple(torch.from_numpy(a).to(device) for a in batch)

    if quant == "static":
        first = (next(dataset_iterator(dataset, batch_size, num_workers=0)) if dataset
                 is not None else tuple(a[:batch_size] for a in corpus))
        corrupted = on_device(first)[0]
        calibrate(model.eval(), [(corrupted, torch.ones_like(corrupted, dtype=torch.bool))])
        model.train()

    if checkpoint_every is None:
        checkpoint_every = 0 if checkpoint_dir is None else max(steps // 2, 1)
    train_fn = eval_fn = loss_fn
    trained = model
    if lora_rank:
        trained = init_lora(model.state_dict(), lora_rank,
                            generator=torch.Generator().manual_seed(seed + 1))
        train_fn = eval_fn = wrap_loss(loss_fn, model)
        n = sum(p.numel() for p in trained.parameters())
        n_base = sum(p.numel() for p in model.parameters())
        print(f"LoRA rank {lora_rank}: training {n:,} adapter params"
              f" ({100.0 * n / n_base:.2f}% of {n_base:,})")
    trainer = Trainer(
        train_fn,
        build_optimizer(3e-4, schedule="cosine", total_steps=steps,
                        warmup_steps=max(steps // 10, 1), clip_norm=1.0),
        metrics_path=metrics_path,
        log_every=log_every,
        eval_fn=eval_fn,
        eval_every=max(steps // 2, 1),
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        checkpoint_async=checkpoint_async,
        prefetch=prefetch,
        steps_per_call=steps_per_call,
    )
    eval_batches = [on_device(b) for b in epoch_batches(held_out, batch_size)]

    # epochs=None reshuffles every epoch; start_batch puts a resumed run at
    # the data position of an uninterrupted one
    def batches(start_step=0):
        if dataset is not None:
            source = dataset_iterator(dataset, batch_size, shuffle=True, epochs=None,
                                      start_batch=start_step, num_workers=4)
        else:
            source = batch_iterator(corpus, batch_size, shuffle=True, epochs=None,
                                    start_batch=start_step)
        for batch in source:
            yield batch if prefetch else on_device(batch)

    return trainer, trainer.init_state(trained), batches, eval_batches


def main(steps=50, batch_size=8, full_scale=False, *, device="cuda",
         metrics_path="./mlm_metrics.jsonl", text_file=None, mask_rate=0.15,
         checkpoint_dir=None, resume=False, async_checkpoint=False, lora_rank=0,
         steps_per_call=1, quant=None):
    trainer, state, batches, eval_batches = setup(
        steps, batch_size, full_scale, device=device, metrics_path=metrics_path,
        text_file=text_file, mask_rate=mask_rate, checkpoint_dir=checkpoint_dir,
        checkpoint_async=async_checkpoint, prefetch=2, lora_rank=lora_rank,
        steps_per_call=steps_per_call, quant=quant)
    state = trainer.fit(state, batches, num_steps=steps, eval_batches=eval_batches,
                        resume=resume)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--full-scale", action="store_true",
                        help="published 2048-byte config, bf16")
    parser.add_argument("--text-file", default=None,
                        help="corpus path or glob; default: the synthetic corpus")
    parser.add_argument("--mask-rate", type=float, default=0.15,
                        help="--text-file MLM corruption rate")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest checkpoint in --checkpoint-dir")
    parser.add_argument("--async-checkpoint", action="store_true",
                        help="write checkpoints by a thread (Trainer(checkpoint_async=True))")
    parser.add_argument("--lora", type=int, default=0, metavar="RANK",
                        help="freeze the model; train rank-R LoRA adapters on the attention"
                             " and MLP projections instead")
    parser.add_argument("--steps-per-call", type=int, default=1,
                        help="updates per call of the Trainer's step")
    parser.add_argument("--quant", nargs="?", const="dynamic", default=None,
                        choices=["dynamic", "static"],
                        help="quantization-aware training: int8 forward, exact backward")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, full_scale=args.full_scale, device=args.device,
         text_file=args.text_file, mask_rate=args.mask_rate,
         checkpoint_dir=args.checkpoint_dir, resume=args.resume,
         async_checkpoint=args.async_checkpoint, lora_rank=args.lora,
         steps_per_call=args.steps_per_call, quant=args.quant)
