"""TF-style SAME padding and conv output-shape arithmetic.

Counterpart of ``perceiverio_pytorch_tpu/utils/conv_shapes.py`` (a
pure-Python copy).  TF SAME semantics pad the right and bottom one pixel
more when the total padding is odd; the converted checkpoints'
``Conv2DDownsample`` stack depends on that asymmetry.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Union


def _as_list(v: Union[int, Sequence[int]], dims: int) -> List[int]:
    if isinstance(v, int):
        return [v] * dims
    return list(v)


def same_padding(
    input_size: Sequence[int],
    kernel_size: Union[int, Sequence[int]],
    stride: Union[int, Sequence[int]] = 1,
    dims: int = 2,
) -> List[int]:
    """Padding for a SAME conv, in ``F.pad`` order (last dim first).

    Returns [d_last_left, d_last_right, d_prev_left, d_prev_right, ...].
    If the padding isn't divisible by two, right/bottom get the extra pixel.
    """
    kernel_size = _as_list(kernel_size, dims)
    stride = _as_list(stride, dims)
    skip_dims = len(input_size) - dims

    padding = []
    for d in range(dims - 1, -1, -1):
        if input_size[d + skip_dims] % stride[d] == 0:
            total_padding = kernel_size[d] - stride[d]
        else:
            total_padding = kernel_size[d] - (input_size[d + skip_dims] % stride[d])
        total_padding = max(total_padding, 0)
        padding.append(math.floor(total_padding / 2))
        padding.append(math.ceil(total_padding / 2))
    return padding


def conv_output_shape(
    input_size: Sequence[int],
    kernel_size: Union[int, Sequence[int]],
    stride: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    dilation: Union[int, Sequence[int]] = 1,
    dims: int = 2,
) -> List[int]:
    """Output spatial shape of a convolution (floor formula); leading dims
    beyond the last ``dims`` are passed through."""
    skip_dims = len(input_size) - dims
    kernel_size = _as_list(kernel_size, dims)
    stride = _as_list(stride, dims)
    padding = _as_list(padding, dims)
    dilation = _as_list(dilation, dims)

    output_size = list(input_size[:skip_dims])
    for i in range(dims):
        out = math.floor(
            (input_size[skip_dims + i] + 2 * padding[i]
             - dilation[i] * (kernel_size[i] - 1) - 1) / stride[i] + 1
        )
        output_size.append(out)
    return output_size
