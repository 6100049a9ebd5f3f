"""perceiverio_pytorch_tpu_torch: the PyTorch/CUDA port of perceiverio_pytorch_tpu.

A package beside the JAX one, module for module, that runs on an NVIDIA
Hopper GPU.  Its torch modules carry the reference's state_dict names, so
the JAX package's weights (``utils.weights.state_dict_from_flax``) and the
converted DeepMind checkpoints load with ``load_state_dict(strict=True)``.
Every Pallas kernel of the JAX package on a ported path is a hand-written
CUDA kernel here (``csrc/``), with a plain PyTorch version beside it.  The
training stack is ``perceiverio_pytorch_tpu_torch.training`` (optax's
optimizer chain, file-backed datasets, device prefetch, train-state
checkpoints and exact resume, ``steps_per_call``, an EMA of the parameters
and LoRA adapters; dropout, stochastic input masking and selective remat,
``Policy.remat_policy``, live in the models); the examples
``perceiverio_pytorch_tpu_torch.examples.train_flow``, ``.train_multimodal``,
``.train_mlm`` (``--lora``) and ``.train_classification`` train from
synthetic data or files, ``.evaluate_flow``, ``.evaluate_classification``,
``.evaluate_mlm`` and ``.evaluate_multimodal`` score a checkpoint, and
``perceiverio_pytorch_tpu_torch.convert`` converts between a reference
``.pth`` and a weights directory.  Task models, each serving and training:
``FlowPerceiver`` (with ``FlowInference``), ``MultiModalPerceiver``,
``LanguagePerceiver`` (with the byte tokenizer, ``BytesTokenizer``) and
``ClassificationPerceiver`` (its three ``PrepType``s).  The serving stack:
``export_apply``/``load_exported`` (``torch.export`` artifacts),
``BatchingServer`` (bucketed, pipelined micro-batching) and
``HttpFrontend`` (JSON and npz over HTTP); the demo is
``perceiverio_pytorch_tpu_torch.examples.serve``.
"""

__version__ = "0.1.0"

from perceiverio_pytorch_tpu_torch.config import (  # noqa: F401
    DEFAULT,
    PARITY,
    PERFORMANCE,
    Policy,
)
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
from perceiverio_pytorch_tpu_torch.serving import export_apply, load_exported  # noqa: F401
from perceiverio_pytorch_tpu_torch.serving_http import HttpFrontend  # noqa: F401
from perceiverio_pytorch_tpu_torch.serving_server import BatchingServer  # noqa: F401
from perceiverio_pytorch_tpu_torch.utils.bytes_tokenizer import BytesTokenizer  # noqa: F401
