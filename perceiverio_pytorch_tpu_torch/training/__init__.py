"""Training stack of the PyTorch/CUDA port: the losses of the four task
models, optax's optimizer chain (AdamW, Adafactor, Lion, SGD; schedules,
clip, weight-decay and trainable masks, accumulation, skipping non-finite
updates), the train step with its EMA and its multi-step form, the Trainer
with its evaluation, checkpoints, resume and ``steps_per_call``, LoRA
adapters, the file-backed datasets, and the host-side batching with device
prefetch."""

from perceiverio_pytorch_tpu_torch.training.checkpoint import (  # noqa: F401
    AsyncCheckpointWriter,
    latest_checkpoint,
    prune_checkpoints,
    restore_eval_variables,
    restore_train_state,
    restore_variables,
    save_train_state,
    save_variables,
)
from perceiverio_pytorch_tpu_torch.training.data import (  # noqa: F401
    batch_iterator,
    epoch_batches,
    prefetch_to_device,
)
from perceiverio_pytorch_tpu_torch.training.datasets import (  # noqa: F401
    FlowPairDataset,
    ImageFolderDataset,
    MLMDataset,
    Subset,
    TextFileDataset,
    VideoClipDataset,
    dataset_iterator,
)
from perceiverio_pytorch_tpu_torch.training.lora import (  # noqa: F401
    DEFAULT_TARGETS,
    LoRA,
    default_match,
    init_lora,
    lora_paths,
    merge_lora,
    wrap_loss,
)
from perceiverio_pytorch_tpu_torch.training.loop import (  # noqa: F401
    MetricsLogger,
    Trainer,
)
from perceiverio_pytorch_tpu_torch.training.losses import (  # noqa: F401
    classification_cross_entropy,
    flow_endpoint_error,
    masked_token_cross_entropy,
    multimodal_autoencode_loss,
)
from perceiverio_pytorch_tpu_torch.training.optim import (  # noqa: F401
    OptaxChain,
    Optimizer,
    build_optimizer,
    build_schedule,
    global_norm,
    non_1d_weight_decay_mask,
)
from perceiverio_pytorch_tpu_torch.training.trainer import (  # noqa: F401
    TrainState,
    create_train_state,
    make_multi_step,
    make_train_step,
)
