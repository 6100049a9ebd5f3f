"""Checkpoint conversion CLI: reference ``.pth`` <-> the port's weights directory.

Counterpart of ``perceiverio_pytorch_tpu/convert.py``.  The reference
distributes its converted checkpoints as ``.pth`` files read with
``torch.load(path)["model_state_dict"]``; the port's evaluation and serving
read a ``save_variables`` directory (``training/checkpoint.py``)::

    # .pth -> a weights directory
    python -m perceiverio_pytorch_tpu_torch.convert language_perceiver_io_bytes.pth \\
        /ckpt/mlm --family language

    # a weights directory -> a .pth the reference's example code can load
    python -m perceiverio_pytorch_tpu_torch.convert /ckpt/mlm back.pth --family language

The direction comes from the arguments: a ``.pth`` source is written to a
directory, a directory source to a ``.pth``; both or neither ending in
``.pth`` is refused.  The family picks the published full-width model
(``build_family_template``), built on the ``meta`` device: no weight is
drawn, only its names and shapes are read.  Both directions are strict: a
missing, extra or reshaped entry (a checkpoint of another family) fails,
naming the first bad key and its shapes.  A ``.pth`` written from JAX
variables lacks BatchNorm's ``num_batches_tracked``, which flax has no
counterpart of: it is written as 0, as ``restore_eval_variables`` reads it.

Conversion is a file-to-file host job with no arithmetic: tensors go from
one file to the other on the CPU and none is moved to the card, by design
(the JAX CLI pins itself to the CPU the same way).  The JAX package's Orbax
format is out of reach: the port imports no JAX, so it reads and writes its
own ``save_variables`` directories only.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.models.classification import ClassificationPerceiver, PrepType
from perceiverio_pytorch_tpu_torch.models.flow import FlowPerceiver
from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
from perceiverio_pytorch_tpu_torch.models.multimodal import MultiModalPerceiver
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_variables, save_variables

__all__ = ["FAMILIES", "build_family_template", "convert", "main"]

FAMILIES = ("language", "classification", "flow", "multimodal")


def build_family_template(family: str, prep_type: str = "FOURIER_POS_CONVNET") -> nn.Module:
    """The published full-width model of ``family`` on the ``meta`` device
    (``prep_type``: the classifier's ``PrepType`` name, any case)."""
    builders = {
        "language": lambda: LanguagePerceiver(device="meta"),
        "classification": lambda: ClassificationPerceiver(
            prep_type=PrepType[prep_type.upper()], device="meta"),
        "flow": lambda: FlowPerceiver(device="meta"),
        "multimodal": lambda: MultiModalPerceiver(device="meta"),
    }
    if family not in builders:
        raise ValueError(f"unknown family {family!r}; pick one of {FAMILIES}")
    with torch.device("meta"):
        return builders[family]()


def _checked(state_dict: Dict[str, torch.Tensor], template: nn.Module,
             where: str) -> Dict[str, torch.Tensor]:
    """``state_dict`` with the template's exact names and shapes, or
    ValueError naming the first key that differs."""
    want: Dict[str, Tuple[int, ...]] = {k: tuple(v.shape)
                                        for k, v in template.state_dict().items()}
    state_dict = dict(state_dict)
    for name in want:
        if name.endswith("num_batches_tracked") and name not in state_dict:
            state_dict[name] = torch.tensor(0)
    for name in sorted(set(want) | set(state_dict)):
        got = tuple(state_dict[name].shape) if name in state_dict else None
        if name not in want or got != want[name]:
            raise ValueError(
                f"{where} does not match the family's model at {name!r}: checkpoint shape "
                f"{got}, model shape {want.get(name)}")
    return state_dict


def convert(src: str, dst: str, template: nn.Module, overwrite: bool = False) -> int:
    """Convert between a reference ``.pth`` and a weights directory
    (``save_variables``), checked strictly against ``template``; returns the
    number of tensors written."""
    to_dir = src.endswith(".pth")
    if to_dir == dst.endswith(".pth"):
        raise ValueError("exactly one of src/dst must be a .pth file (the reference side);"
                         f" got src={src!r} dst={dst!r}")
    if to_dir:
        state_dict = torch.load(src, map_location="cpu", weights_only=True)
        if "model_state_dict" in state_dict:
            state_dict = state_dict["model_state_dict"]
        state_dict = _checked(state_dict, template, src)
        save_variables(dst, state_dict, overwrite=overwrite)
    else:
        state_dict = _checked(restore_variables(src, device="cpu"), template, src)
        torch.save({"model_state_dict": state_dict}, dst)
    return len(state_dict)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m perceiverio_pytorch_tpu_torch.convert", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help=".pth file or weights directory")
    ap.add_argument("dst", help="weights directory or .pth file")
    ap.add_argument("--family", required=True, choices=FAMILIES)
    ap.add_argument("--prep-type", default="FOURIER_POS_CONVNET",
                    help="classification variant: FOURIER_POS_CONVNET, LEARNED_POS_1X1CONV"
                         " or FOURIER_POS_PIXEL")
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)
    n = convert(args.src, args.dst, build_family_template(args.family, args.prep_type),
                overwrite=args.overwrite)
    print(f"converted {args.family}: {n} tensors -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
