"""The port's parallel layouts: the partition rules against the JAX
package's, the mesh and multi-process helpers, and the harness the
multi-process tests share.

Rules (no processes): ``param_partition_spec`` and
``fsdp_param_partition_spec`` of every parameter of the tiny flow, MLM,
three classifiers and multimodal models equal JAX's ``parallel/sharding.py``
specs of the same parameters, transposed to the torch layout;
``default_mesh_shape``, ``pad_batch_to_multiple``, ``make_mesh``'s errors
and ``initialize_distributed``'s no-op cases (JAX
``tests/test_multihost.py:25-58``).

Harness: ``run_ranks(fn, world, tmp_path, *args)`` spawns ``world``
processes, each joining a gloo group through a file store under
``tmp_path`` (no ports) with a 60 s collective timeout and one torch
thread, runs ``fn(rank, world, *args)`` and returns each rank's result; a
rank that fails fails the test with its traceback, and ranks that do not
finish within the deadline are killed.  The rank functions live in
``test_torch_parallel*`` modules that import only torch, numpy and pytest
at the top, so that the spawned processes never import JAX; the JAX oracles
are computed in the test process.
"""

import os
import pickle
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 150


def _rank_entry(fn, rank, world, tmp, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(fn, world, tmp_path, *args, deadline_s=DEADLINE_S):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its own
    spawned process of a gloo group (see the module docstring)."""
    import multiprocessing as mp

    tmp = str(tmp_path / f"group{world}_{os.urandom(4).hex()}")
    os.makedirs(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, tmp, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    import time

    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(end - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    results, errors = [], []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            results.append(None)
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            errors.append(f"rank {r}:\n{value}")
            value = None
        results.append(value)
    if hung:
        pytest.fail(f"ranks {hung} did not finish within {deadline_s} s (killed)"
                    + "".join("\n" + e for e in errors))
    if errors:
        pytest.fail("\n".join(errors))
    return results


# --- rules, against the JAX package ---------------------------------------

def _tiny_models():
    """(name, JAX module, port module, init args, init keywords) of the tiny
    configurations."""
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu.models import (
        ClassificationPerceiver as JaxCls,
        FlowPerceiver as JaxFlow,
        LanguagePerceiver as JaxLM,
        MultiModalPerceiver as JaxMM,
        PrepType as JaxPrep,
    )
    from perceiverio_pytorch_tpu_torch import (
        ClassificationPerceiver,
        FlowPerceiver,
        LanguagePerceiver,
        MultiModalPerceiver,
        PrepType,
    )
    from perceiverio_pytorch_tpu_torch.examples import train_multimodal

    flow = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
                num_self_attends_per_block=2)
    lm = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=2,
              num_latents=8, num_latent_channels=64)
    cls = dict(num_classes=7, img_size=(32, 32), num_self_attends_per_block=2, num_blocks=2,
               num_latents=8, num_latent_channels=32)
    mm = dict(train_multimodal.TINY)
    out = [("flow", JaxFlow(**flow), FlowPerceiver(**flow, device="cpu"),
            (jnp.zeros((1, 3, 16, 24)), jnp.zeros((1, 3, 16, 24))), {}),
           ("mlm", JaxLM(**lm), LanguagePerceiver(**lm, device="cpu"),
            (jnp.zeros((1, 32), jnp.int32), jnp.ones((1, 32), bool)), {})]
    for prep in ("FOURIER_POS_CONVNET", "LEARNED_POS_1X1CONV", "FOURIER_POS_PIXEL"):
        out.append((f"cls_{prep.lower()}", JaxCls(prep_type=JaxPrep[prep], **cls),
                    ClassificationPerceiver(prep_type=PrepType[prep], **cls, device="cpu"),
                    (jnp.zeros((1, 3, 32, 32)),), {}))
    t, hw, spf = mm["num_frames"], mm["img_size"], mm["audio_samples_per_frame"]
    out.append(("multimodal", JaxMM(**mm), MultiModalPerceiver(**mm, device="cpu"),
                (jnp.zeros((1, t, 3) + tuple(hw)), jnp.zeros((1, t * spf, 1))),
                dict(n_chunks=4)))
    return out


@pytest.mark.parametrize("fsdp_size", [0, 2, 4])
def test_partition_rules_match_jax(fsdp_size):
    """Every parameter of six tiny models: the port's spec equals JAX's rule
    on the same parameter, in the torch layout (TP alone, and with FSDP over
    data axes of 2 and 4; the 2-D kernels transposed, so a square kernel's
    FSDP dim is torch's dim 1)."""
    import jax
    from flax.traverse_util import flatten_dict

    from perceiverio_pytorch_tpu.parallel import sharding as jax_sharding
    from perceiverio_pytorch_tpu_torch.parallel import (
        fsdp_param_partition_spec,
        param_partition_spec,
    )
    from perceiverio_pytorch_tpu_torch.utils.weights import translate_path, LANGUAGE_OVERRIDES

    checked = square = 0
    for name, jm, pm, args, kwargs in _tiny_models():
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kwargs))
        port = dict(pm.named_parameters())
        flat = flatten_dict(shapes["params"])
        for path, value in flat.items():
            torch_name = LANGUAGE_OVERRIDES.get("/".join(path)) or translate_path(path, "params")
            tensor = port[torch_name]
            want = jax_sharding.param_partition_spec(path, value)
            got = param_partition_spec(torch_name, tensor)
            if fsdp_size:
                want = jax_sharding.fsdp_param_partition_spec(path, value, fsdp_size, base=want)
                got = fsdp_param_partition_spec(torch_name, tensor, fsdp_size)
            entries = list(want) + [None] * (value.ndim - len(want))
            if value.ndim == 2 and path[-1] == "kernel":
                square += value.shape[0] == value.shape[1] and "data" in entries
                want_t = tuple(entries[::-1])
            elif value.ndim == 4:
                want_t = tuple(entries[i] for i in (3, 2, 0, 1))
            else:
                want_t = tuple(entries)
            assert got == want_t, (name, torch_name, want, got)
            checked += 1
        assert len(flat) == len(port) or name == "mlm", name
    assert checked > 300
    if fsdp_size:
        assert square > 0  # the tie rule was exercised


def test_default_mesh_shape_and_padding():
    from perceiverio_pytorch_tpu.parallel import default_mesh_shape as jax_default
    from perceiverio_pytorch_tpu.parallel import pad_batch_to_multiple as jax_pad
    from perceiverio_pytorch_tpu_torch.parallel import default_mesh_shape, pad_batch_to_multiple

    for n in (1, 2, 3, 4, 6, 8):
        assert default_mesh_shape(n) == jax_default(n)
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    for multiple, axis in ((2, 0), (4, 0), (5, 0), (4, 1)):
        got, size = pad_batch_to_multiple(x, multiple, axis)
        want, want_size = jax_pad(x, multiple, axis)
        assert size == want_size and isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture
def no_group(monkeypatch):
    """No process group before the test and none after it; no launch
    variables in the environment."""
    import torch.distributed as dist

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_and_initialize_distributed_one_process(no_group):
    """A plain process: ``initialize_distributed()`` is a no-op (False);
    ``make_mesh`` makes a one-rank gloo group on a HashStore and a (1, 1)
    mesh; a shape that is not the device count raises JAX's ValueError;
    with a group present ``initialize_distributed`` is a no-op again."""
    import torch.distributed as dist

    from perceiverio_pytorch_tpu_torch.parallel import (
        initialize_distributed,
        is_multihost,
        local_batch_size,
        make_mesh,
        sync_hosts,
    )

    assert initialize_distributed(device="cpu") is False and not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    for shape in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="device count"):
            make_mesh(shape, device="cpu")
    assert initialize_distributed("localhost:1", 2, 0, device="cpu") is False
    assert not is_multihost() and local_batch_size(8, mesh) == 8
    sync_hosts()
