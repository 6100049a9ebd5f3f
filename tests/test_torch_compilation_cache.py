"""utils/compilation_cache.py of the port: the kernel build directory.

The port's compiled artifacts are its nvcc-built flash attention kernels;
``enable_compilation_cache`` points their build directory elsewhere, with
the JAX package's default rule ($PERCEIVER_CACHE_DIR, then ~/.cache), and
refuses once the kernels are loaded from another directory.  ``--cache-dir``
does it from the command line of the evaluation scripts and serve.py.  On
the CPU nothing is built.
"""

import os
import runpy
import sys

import pytest
import torch

from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.utils import compilation_cache as cc

torch.set_num_threads(1)
SCRIPTS = ("evaluate_flow", "evaluate_classification", "evaluate_mlm", "evaluate_multimodal",
           "serve")


@pytest.fixture(autouse=True)
def restore_build_dir(monkeypatch):
    monkeypatch.setattr(fa, "_BUILD_DIR", fa._BUILD_DIR)
    monkeypatch.delenv("PERCEIVER_CACHE_DIR", raising=False)


def test_default_build_dir_is_under_the_repository():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert fa.build_dir() == os.path.join(root, "build", "kernels")


def test_enable_moves_the_build_dir(tmp_path):
    target = str(tmp_path / "kernels")
    assert cc.enable_compilation_cache(target, min_compile_time_secs=0.0) == target
    assert os.path.isdir(target) and fa.build_dir() == target
    assert {os.path.dirname(p) for p in fa.library_paths().values()} == {target}


def test_default_rule_env_then_home(tmp_path, monkeypatch):
    monkeypatch.setenv("PERCEIVER_CACHE_DIR", str(tmp_path / "env"))
    assert cc.enable_compilation_cache() == str(tmp_path / "env")
    monkeypatch.delenv("PERCEIVER_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    want = str(tmp_path / "home" / ".cache" / "perceiverio_pytorch_tpu_torch" / "kernels")
    assert cc.enable_compilation_cache() == want and fa.build_dir() == want


def test_refuses_once_the_kernels_are_loaded(tmp_path, monkeypatch):
    monkeypatch.setattr(fa, "_libs", {"fwd": object()})
    with pytest.raises(RuntimeError, match="already loaded"):
        cc.enable_compilation_cache(str(tmp_path / "other"))
    # The directory they were loaded from is accepted again.
    assert fa.set_build_dir(fa.build_dir()) == fa.build_dir()


def test_cache_arg_helpers_match_jax():
    import argparse

    parser = argparse.ArgumentParser()
    cc.add_cache_arg(parser)
    assert cc.enable_cache_if_requested(parser.parse_args([])) is None
    assert parser.parse_args(["--cache-dir", "x"]).cache_dir == "x"


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_take_cache_dir(script, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [script, "--help"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(f"perceiverio_pytorch_tpu_torch.examples.{script}", run_name="__main__")
    assert done.value.code == 0 and "--cache-dir" in capsys.readouterr().out


def test_cache_dir_moves_the_build_dir_and_the_cpu_builds_nothing(tmp_path, monkeypatch,
                                                                  capsys):
    target = str(tmp_path / "cache")
    monkeypatch.setattr(sys, "argv", ["evaluate_mlm", "--cache-dir", target, "--device", "cpu",
                                      "--limit", "2", "--batch-size", "2"])
    runpy.run_module("perceiverio_pytorch_tpu_torch.examples.evaluate_mlm", run_name="__main__")
    assert '"sequences": 2' in capsys.readouterr().out
    assert fa.build_dir() == target and os.listdir(target) == []
