"""perceiverio_pytorch_tpu_torch: the PyTorch/CUDA port of perceiverio_pytorch_tpu.

A package beside the JAX one, module for module, that runs on an NVIDIA
Hopper GPU.  Its torch modules carry the reference's state_dict names, so
the JAX package's weights (``utils.weights.state_dict_from_flax``) and the
converted DeepMind checkpoints load with ``load_state_dict(strict=True)``.
Every Pallas kernel of the JAX package on a ported path is a hand-written
CUDA kernel here (``csrc/``), with a plain PyTorch version beside it.

The top level exports what the JAX package's does:
  * the building blocks, for models of one's own (``docs/EXTENDING.md``):
    ``Attention``, ``CrossAttention``, ``SelfAttention``, ``MLP``,
    ``make_cross_attention_mask``, the position encodings, the queries,
    ``PerceiverEncoder``, ``PerceiverDecoder``, ``PerceiverIO``,
    ``MultimodalPreprocessor`` and ``restructure``; the pre- and
    postprocessors are in ``io_processors``;
  * the numerical ``Policy`` and its presets;
  * the serving stack: ``export_apply``/``load_exported`` (``torch.export``
    artifacts), ``BatchingServer`` (bucketed, pipelined micro-batching) and
    ``HttpFrontend`` (JSON and npz over HTTP);
and beside them the task models, each of which serves and trains:
``FlowPerceiver`` (with ``FlowInference``), ``MultiModalPerceiver``,
``LanguagePerceiver`` (with the byte tokenizer, ``BytesTokenizer``) and
``ClassificationPerceiver`` (its three ``PrepType``s).

The training stack is ``perceiverio_pytorch_tpu_torch.training`` (optax's
optimizer chain, file-backed datasets, device prefetch, train-state
checkpoints and exact resume, ``steps_per_call``, an EMA of the parameters
and LoRA adapters; dropout, stochastic input masking and selective remat,
``Policy.remat_policy``, live in the models).  int8 inference and
quantization-aware training: ``Policy.quant`` (``PERFORMANCE_INT8``,
``PERFORMANCE_INT8_STATIC``) and ``ops.quant``.  ``utils.profiling``,
``utils.memory`` and ``utils.compilation_cache`` are the tools around a
run.  The examples (``perceiverio_pytorch_tpu_torch.examples``): the four
reference demos ``opt_flow``, ``img_classify``, ``language`` and
``multimodal``; ``train_flow``, ``train_multimodal``, ``train_mlm``
(``--lora``) and ``train_classification``; ``evaluate_flow``,
``evaluate_classification``, ``evaluate_mlm`` and ``evaluate_multimodal``;
``serve``.  ``perceiverio_pytorch_tpu_torch.convert`` converts between a
reference ``.pth`` and a weights directory.
"""

__version__ = "0.1.0"

from perceiverio_pytorch_tpu_torch.config import (  # noqa: F401
    DEFAULT,
    PARITY,
    PERFORMANCE,
    PERFORMANCE_INT8,
    PERFORMANCE_INT8_STATIC,
    Policy,
)
from perceiverio_pytorch_tpu_torch.core.attention import (  # noqa: F401
    MLP,
    Attention,
    CrossAttention,
    SelfAttention,
)
from perceiverio_pytorch_tpu_torch.core.perceiver import (  # noqa: F401
    MultimodalPreprocessor,
    PerceiverDecoder,
    PerceiverEncoder,
    PerceiverIO,
    restructure,
)
from perceiverio_pytorch_tpu_torch.core.position_encoding import (  # noqa: F401
    FourierPositionEncoding,
    PosEncodingType,
    PositionEncodingProjector,
    TrainablePositionEncoding,
    build_linear_positions,
    build_position_encoding,
    generate_fourier_features,
)
from perceiverio_pytorch_tpu_torch.core.queries import (  # noqa: F401
    BasicQuery,
    FlowQuery,
    FourierQuery,
    TrainableQuery,
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
from perceiverio_pytorch_tpu_torch.ops.attention_dense import (  # noqa: F401
    make_cross_attention_mask,
)
from perceiverio_pytorch_tpu_torch.serving import export_apply, load_exported  # noqa: F401
from perceiverio_pytorch_tpu_torch.serving_http import HttpFrontend  # noqa: F401
from perceiverio_pytorch_tpu_torch.serving_server import BatchingServer  # noqa: F401
from perceiverio_pytorch_tpu_torch.utils.bytes_tokenizer import BytesTokenizer  # noqa: F401
