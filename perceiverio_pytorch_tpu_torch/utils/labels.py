"""Class-name tables (ImageNet-1k, Kinetics-700).

Counterpart of ``perceiverio_pytorch_tpu/utils/labels.py``, reading the
port's own copies of the JSON tables in ``perceiverio_pytorch_tpu_torch/data/``.
"""

from __future__ import annotations

import functools
import json
import os
from typing import List

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


@functools.lru_cache(maxsize=None)
def imagenet_labels() -> List[str]:
    with open(os.path.join(_DATA_DIR, "imagenet_labels.json")) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def kinetics700_labels() -> List[str]:
    with open(os.path.join(_DATA_DIR, "kinetics700_labels.json")) as f:
        return json.load(f)
