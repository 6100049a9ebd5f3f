"""Import hygiene and device rules of the PyTorch/CUDA port.

The port and chip_smoke.py import neither JAX/flax/optax nor the JAX package
(nor torchvision/timm), and its entry points never fall back to the CPU
quietly.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "perceiverio_pytorch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "perceiverio_pytorch_tpu", "torchvision",
             "timm")


def _port_files():
    files = []
    for dirpath, _, names in os.walk(os.path.join(ROOT, PACKAGE)):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


def _module_name(path):
    rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    return rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_statements(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = [_module_name(p) for p in _port_files()]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["train_mlm", "train_classification"])
def test_training_examples_load_no_jax(module):
    """Each language and classification training example, imported alone in
    a fresh interpreter, is among the files checked above and loads no JAX,
    flax or JAX package module."""
    name = f"{PACKAGE}.examples.{module}"
    assert name in [_module_name(p) for p in _port_files()]
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["serving", "serving_server", "serving_http",
                                    "examples.serve", "training.checkpoint", "utils.params",
                                    "utils.device"])
def test_serving_modules_load_no_jax(module):
    """Each module of the serving stack, imported alone in a fresh
    interpreter, is among the files checked above and loads no JAX, flax or
    JAX package module."""
    name = f"{PACKAGE}.{module}"
    assert name in [_module_name(p) for p in _port_files()]
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["training.data", "training.datasets", "training.loop",
                                    "utils.flow_io", "utils.image", "utils.labels",
                                    "tools.make_synthetic_data", "examples.evaluate_flow",
                                    "examples.evaluate_classification"])
def test_data_and_checkpoint_modules_load_no_jax(module):
    """Each module of the file-backed data, checkpoint and evaluation path,
    imported alone in a fresh interpreter, is among the files checked above
    and loads no JAX, flax or JAX package module, nor PIL or OpenCV (they are
    imported where a file is read or written)."""
    name = f"{PACKAGE}.{module}"
    assert name in [_module_name(p) for p in _port_files()]
    forbidden = FORBIDDEN + ("PIL", "cv2")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


SMALL = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
             num_self_attends_per_block=1)


def test_flow_perceiver_defaults_to_cuda(no_cuda):
    from perceiverio_pytorch_tpu_torch import FlowPerceiver

    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlowPerceiver(**SMALL)


def test_flow_inference_defaults_to_cuda(no_cuda):
    from perceiverio_pytorch_tpu_torch import FlowInference, FlowPerceiver

    model = FlowPerceiver(**SMALL, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlowInference(model, min_overlap=8)
    assert next(model.parameters()).device.type == "cpu"


def test_flow_inference_runs_on_cpu_when_asked():
    from perceiverio_pytorch_tpu_torch import FlowInference, FlowPerceiver

    model = FlowPerceiver(**SMALL, device="cpu")
    infer = FlowInference(model, min_overlap=8, device="cpu")
    out = infer(torch.zeros(1, 3, 20, 30), torch.zeros(1, 3, 20, 30))
    assert out.device.type == "cpu" and out.shape == (1, 2, 20, 30)


def test_language_perceiver_defaults_to_cuda(no_cuda):
    from perceiverio_pytorch_tpu_torch import LanguagePerceiver

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LanguagePerceiver(max_seq_len=16, embed_dim=8, num_self_attends_per_block=1,
                          num_latents=4, num_latent_channels=16)


@pytest.mark.parametrize("prep", ["FOURIER_POS_CONVNET", "LEARNED_POS_1X1CONV",
                                  "FOURIER_POS_PIXEL"])
def test_classification_perceiver_defaults_to_cuda(no_cuda, prep):
    from perceiverio_pytorch_tpu_torch import ClassificationPerceiver, PrepType

    kw = dict(num_classes=5, img_size=(16, 16), prep_type=PrepType[prep],
              num_self_attends_per_block=1, num_blocks=1, num_latents=4,
              num_latent_channels=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassificationPerceiver(**kw)
    model = ClassificationPerceiver(**kw, device="cpu").eval()
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 16, 16))
    assert out.device.type == "cpu" and out.shape == (1, 5)


def test_serving_stack_defaults_to_cuda(no_cuda, tmp_path):
    """The BatchingServer, restore_variables and the serving example's
    entry points refuse a missing GPU unless asked for the CPU."""
    from perceiverio_pytorch_tpu_torch import BatchingServer
    from perceiverio_pytorch_tpu_torch.examples import serve
    from perceiverio_pytorch_tpu_torch.training.checkpoint import (
        restore_variables,
        save_variables,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchingServer(lambda x: x)
    save_variables(str(tmp_path / "w"), {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_variables(str(tmp_path / "w"))
    assert restore_variables(str(tmp_path / "w"), device="cpu")["w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(str(tmp_path))
    rec = serve.build(str(tmp_path), device="cpu", quant="dynamic")  # int8 exports
    assert rec["quant"] == "dynamic" and os.path.exists(tmp_path / serve.ARTIFACT)


def test_data_path_entry_points_default_to_cuda(no_cuda, tmp_path):
    """Device prefetch, the evaluation scripts and the examples' file-backed
    setup refuse a missing GPU unless asked for the CPU."""
    from perceiverio_pytorch_tpu_torch.examples import evaluate_classification, evaluate_flow
    from perceiverio_pytorch_tpu_torch.examples import train_flow
    from perceiverio_pytorch_tpu_torch.training import prefetch_to_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter([(np.zeros(2),)]), 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_flow.main(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_classification.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_flow.setup(2, data_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="--mesh"):
        evaluate_classification.main(mesh_devices=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_classification.main(quant="dynamic")
    assert evaluate_classification.main(quant="dynamic", device="cpu", limit=16)["images"] == 16


@pytest.mark.parametrize("module", ["convert", "training.lora", "training.trainer",
                                    "utils.data", "utils.flow_viz", "utils.weights",
                                    "examples.evaluate_mlm", "examples.evaluate_multimodal",
                                    "examples.train_mlm"])
def test_train_evaluate_loop_modules_load_no_jax(module):
    """Each module of the train -> evaluate loop (the evaluation scripts,
    convert.py, LoRA, the EMA's train step, the data shim, flow_viz),
    imported alone in a fresh interpreter, is among the files checked above
    and loads no JAX, flax or JAX package module, nor PIL, OpenCV or
    matplotlib (imported where an image is read, written or shown)."""
    name = f"{PACKAGE}.{module}"
    assert name in [_module_name(p) for p in _port_files()]
    forbidden = FORBIDDEN + ("PIL", "cv2", "matplotlib")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_evaluation_scripts_default_to_cuda(no_cuda, tmp_path):
    """evaluate_mlm and evaluate_multimodal refuse a missing GPU unless asked
    for the CPU; convert.py needs no device (a host job)."""
    from perceiverio_pytorch_tpu_torch import convert
    from perceiverio_pytorch_tpu_torch.examples import evaluate_mlm, evaluate_multimodal

    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_mlm.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_multimodal.main(str(tmp_path))
    template = convert.build_family_template("multimodal")
    assert {t.device.type for t in template.state_dict().values()} == {"meta"}


@pytest.mark.parametrize("module", ["examples.opt_flow", "examples.img_classify",
                                    "examples.language", "examples.multimodal",
                                    "utils.profiling", "utils.memory",
                                    "utils.compilation_cache", "io_processors",
                                    "io_processors.postprocessors"])
def test_single_card_surface_modules_load_no_jax(module):
    """Each module of the rest of the single-card surface (the four reference
    demos, the profiling, memory and compilation-cache utilities, the
    ImagePostprocessor), imported alone in a fresh interpreter, is among the
    files checked above and loads no JAX, flax or JAX package module, nor
    PIL, OpenCV, matplotlib or scipy (imported where a file is read or
    written)."""
    name = f"{PACKAGE}.{module}"
    assert name in [_module_name(p) for p in _port_files()]
    forbidden = FORBIDDEN + ("PIL", "cv2", "matplotlib", "scipy")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
