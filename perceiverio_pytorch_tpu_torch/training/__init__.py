"""Training stack of the PyTorch/CUDA port: the losses of the four task
models, AdamW with its schedules and clip, the train step, the Trainer with
its evaluation, and the host-side batching."""

from perceiverio_pytorch_tpu_torch.training.data import (  # noqa: F401
    batch_iterator,
    epoch_batches,
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
    Optimizer,
    build_optimizer,
    build_schedule,
    global_norm,
)
from perceiverio_pytorch_tpu_torch.training.trainer import (  # noqa: F401
    TrainState,
    create_train_state,
    make_train_step,
)
