"""Training stack of the PyTorch/CUDA port (the flow and multimodal slices'
part of it)."""

from perceiverio_pytorch_tpu_torch.training.data import batch_iterator  # noqa: F401
from perceiverio_pytorch_tpu_torch.training.loop import (  # noqa: F401
    MetricsLogger,
    Trainer,
)
from perceiverio_pytorch_tpu_torch.training.losses import (  # noqa: F401
    flow_endpoint_error,
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
