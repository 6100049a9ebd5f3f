"""Task models of the PyTorch/CUDA port."""

from perceiverio_pytorch_tpu_torch.models.flow import (  # noqa: F401
    FlowInference,
    FlowPerceiver,
    compute_grid_indices,
)
from perceiverio_pytorch_tpu_torch.models.multimodal import (  # noqa: F401
    MultiModalPerceiver,
)
