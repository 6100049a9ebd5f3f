"""Input preprocessors, output postprocessors and their tensor utilities
(the JAX package's ``io_processors`` names)."""

from perceiverio_pytorch_tpu_torch.io_processors.preprocessors import (  # noqa: F401
    AudioPreprocessor,
    EmbeddingPreprocessor,
    ImagePreprocessor,
    OneHotPreprocessor,
)
from perceiverio_pytorch_tpu_torch.io_processors.postprocessors import (  # noqa: F401
    AudioPostprocessor,
    ClassificationPostprocessor,
    EmbeddingPostprocessor,
    FlowPostprocessor,
    IdentityPostprocessor,
    ImagePostprocessor,
    ProjectionPostprocessor,
)
from perceiverio_pytorch_tpu_torch.io_processors.processor_utils import (  # noqa: F401
    Conv2DDownsample,
    Conv2DUpsample,
    Conv3DUpsample,
    extract_patches,
    patches_for_flow,
    reverse_space_to_depth,
    space_to_depth,
)
