"""Parallel layouts of the PyTorch/CUDA port on ``torch.distributed``: the
(data, model) mesh, the partition rules with FSDP, data-parallel inference
and serving, sequence-parallel attention, the pipelines (GPipe and
circular schedules over a (data, pipe) mesh) and the multi-process helpers
(one process per device).  Counterpart of
``perceiverio_pytorch_tpu/parallel``."""

from perceiverio_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    default_mesh_shape,
    make_mesh,
    mesh_device,
)
from perceiverio_pytorch_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    batch_sharding,
    fsdp_param_partition_spec,
    layout_of,
    param_partition_spec,
    replicated,
    shard_module,
    shard_variables,
    variables_shardings,
)
from perceiverio_pytorch_tpu_torch.parallel.api import (  # noqa: F401
    make_data_parallel_apply,
    pad_batch_to_multiple,
    serve_on_mesh,
)
from perceiverio_pytorch_tpu_torch.parallel.sequence_parallel import (  # noqa: F401
    sequence_parallel_attention,
)
from perceiverio_pytorch_tpu_torch.parallel.pipeline import (  # noqa: F401
    PIPE_AXIS,
    make_pipeline_mesh,
    pipeline_spmd,
    pipelined_self_attends,
    pp_param_shardings,
    stack_layer_params,
    unstack_layer_params,
    unstack_layer_params_circular,
)
from perceiverio_pytorch_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_distributed,
    is_multihost,
    local_batch_size,
    shard_host_batch,
    sync_hosts,
)
