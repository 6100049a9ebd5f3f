"""The port's public surface against the JAX package's: every public name of
JAX's top-level ``__init__``, of its ``io_processors/__init__`` and of its
``parallel/__init__`` is importable from the port's counterpart, and names
the same kind of object (a class, a function, an enum, a constant)."""

import inspect

import pytest
import torch

import perceiverio_pytorch_tpu as jax_pkg
import perceiverio_pytorch_tpu.io_processors as jax_io
import perceiverio_pytorch_tpu.parallel as jax_parallel
import perceiverio_pytorch_tpu_torch as port_pkg
import perceiverio_pytorch_tpu_torch.io_processors as port_io
import perceiverio_pytorch_tpu_torch.parallel as port_parallel

torch.set_num_threads(1)


def _public(module):
    return sorted(name for name, value in vars(module).items()
                  if not name.startswith("_") and not inspect.ismodule(value))


def _kind(value):
    if inspect.isclass(value):
        return "class"
    if callable(value):
        return "callable"
    return type(value).__name__


@pytest.mark.parametrize("jax_module,port_module", [(jax_pkg, port_pkg), (jax_io, port_io)],
                         ids=["package", "io_processors"])
def test_every_jax_public_name_is_exported(jax_module, port_module):
    missing = [n for n in _public(jax_module) if not hasattr(port_module, n)]
    assert not missing, f"{port_module.__name__} lacks {missing}"


@pytest.mark.parametrize("name", _public(jax_pkg) + [f"io_processors.{n}"
                                                     for n in _public(jax_io)])
def test_each_exported_name_is_the_same_kind(name):
    jax_module, port_module = (jax_io, port_io) if "." in name else (jax_pkg, port_pkg)
    name = name.rsplit(".", 1)[-1]
    want, got = getattr(jax_module, name), getattr(port_module, name)
    if name in ("TrainableQuery", "FourierQuery", "FlowQuery"):
        # Factories of BasicQuery in the port (flax: subclasses of it).
        assert callable(got) and callable(want)
        return
    if name == "Policy" or _kind(want) == "class":
        assert inspect.isclass(got), name
        return
    assert _kind(got) == _kind(want), name


@pytest.mark.parametrize("name", _public(jax_parallel))
def test_each_parallel_name_is_exported_as_the_same_kind(name):
    assert hasattr(port_parallel, name), name
    want, got = getattr(jax_parallel, name), getattr(port_parallel, name)
    assert _kind(got) == _kind(want), name
    if isinstance(want, str):
        assert got == want


def test_port_exports_its_own_extras():
    """Beside JAX's names the port keeps its task models and tokenizer."""
    for name in ("FlowPerceiver", "FlowInference", "MultiModalPerceiver", "LanguagePerceiver",
                 "ClassificationPerceiver", "PrepType", "BytesTokenizer",
                 "compute_grid_indices"):
        assert hasattr(port_pkg, name), name
