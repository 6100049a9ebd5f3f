"""Task models of the PyTorch/CUDA port."""

from perceiverio_pytorch_tpu_torch.models.classification import (  # noqa: F401
    ClassificationPerceiver,
    PrepType,
)
from perceiverio_pytorch_tpu_torch.models.flow import (  # noqa: F401
    FlowInference,
    FlowPerceiver,
    compute_grid_indices,
)
from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver  # noqa: F401
from perceiverio_pytorch_tpu_torch.models.multimodal import (  # noqa: F401
    MultiModalPerceiver,
)
