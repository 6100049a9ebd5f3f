"""The Trainer, the data path and serving on a mesh, over gloo groups of 2
and 4 processes (``test_torch_parallel.run_ranks``).

Two ranks, (2, 1):
  * ``Trainer(mesh, fsdp=True, ema_decay=...)`` fits the tiny flow model
    4 steps with checkpoints every 2; its losses equal the single-process
    Trainer's (rtol 2e-4 / atol 2e-5); the checkpoint (written once, by rank
    0, in the single-device format) restores on one process and onto the
    (2, 1) mesh to the same tensors, bit for bit (JAX
    ``tests/test_training_loop.py:308``, :646);
  * SIGTERM delivered to rank 1 alone during step 3: both ranks stop after
    step 3 and one checkpoint (step 3) is written;
  * ``FlowInference(mesh)`` with 3 tiles (padded to 4) and with
    ``wave_size=1`` (rounded up to 2) gives the single-process flow at
    rtol 1e-5 / atol 1e-5 (JAX ``tests/test_sharding_training.py:387``);
  * ``evaluate_classification --mesh 2`` gives the run without a mesh.
Four ranks, (2, 2): the ranks of one model group get the same rows of each
global batch and the two data groups JAX's contiguous halves, through
``process_slice``, ``batch_iterator``/``dataset_iterator(shard_by_process)``,
``local_batch_size``, ``data_rows`` and ``prefetch_to_device(sharding=
batch_sharding(mesh))``; ``shard_host_batch`` assembles the halves into the
global batch.
"""

import json
import os
import signal

import numpy as np
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
FLOW = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
            num_self_attends_per_block=2)


def _flow_model(seed=0):
    from perceiverio_pytorch_tpu_torch import PARITY, FlowPerceiver

    return FlowPerceiver(**FLOW, policy=PARITY, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def _flow_batches(n):
    rng = np.random.default_rng(1)
    hw = FLOW["img_size"]
    return [tuple(torch.from_numpy(a) for a in (
        rng.uniform(-1, 1, (2, 3) + hw).astype(np.float32),
        rng.uniform(-1, 1, (2, 3) + hw).astype(np.float32),
        rng.uniform(-2, 2, (2, 2) + hw).astype(np.float32))) for _ in range(n)]


def _trainer(mesh, ckpt_dir, metrics, every=2):
    from perceiverio_pytorch_tpu_torch.examples import train_flow
    from perceiverio_pytorch_tpu_torch.training import Trainer, build_optimizer

    return Trainer(train_flow.loss_fn, build_optimizer(1e-3, clip_norm=1.0), mesh,
                   fsdp=mesh is not None, metrics_path=metrics, log_every=1,
                   checkpoint_dir=ckpt_dir, checkpoint_every=every, ema_decay=0.9)


def _flat(state):
    from perceiverio_pytorch_tpu_torch.training.checkpoint import _train_state_tree

    tree = _train_state_tree(state)
    out = {f"model/{k}": v for k, v in tree["model"].items()}
    out.update({f"ema/{k}": v for k, v in tree["ema"].items()})
    for index, entries in tree["optimizer"]["state"].items():
        out.update({f"opt/{index}/{k}": v for k, v in entries.items()})
    return {k: v.detach().clone() for k, v in out.items()}, tree["step"]


def _two_rank(rank, world, tmp, flow_args, eval_args):
    from perceiverio_pytorch_tpu_torch.examples import evaluate_classification
    from perceiverio_pytorch_tpu_torch.models.flow import FlowInference
    from perceiverio_pytorch_tpu_torch.parallel import make_mesh
    from perceiverio_pytorch_tpu_torch.training.checkpoint import (
        latest_checkpoint,
        restore_train_state,
    )

    out = {}
    mesh = make_mesh((2, 1), device="cpu")
    # fit under FSDP with an EMA; the checkpoint restored onto the mesh
    ckpt = os.path.join(tmp, "fit")
    trainer = _trainer(mesh, ckpt, os.path.join(tmp, "fit.jsonl"))
    state = trainer.fit(trainer.init_state(_flow_model()), _flow_batches(4), num_steps=4)
    out["fit"], out["fit_step"] = _flat(state)
    if rank == 0:
        with open(os.path.join(tmp, "fit.jsonl")) as f:
            out["losses"] = [json.loads(line)["loss"] for line in f]
    fresh = _trainer(mesh, None, None)
    restored = restore_train_state(latest_checkpoint(ckpt), fresh.init_state(_flow_model(1)))
    out["restored"], _ = _flat(restored)
    # SIGTERM to rank 1 alone, during step 3
    stop = os.path.join(tmp, "stop")
    trainer = _trainer(mesh, stop, None, every=0)

    def batches():
        for n, batch in enumerate(_flow_batches(6), start=1):
            if n == 3 and rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    state = trainer.fit(trainer.init_state(_flow_model()), batches(), num_steps=6)
    out["stopped_at"] = state.step
    out["stop_dirs"] = sorted(os.listdir(stop))
    # FlowInference on the mesh: 3 tiles (padded to 4), then waves of 1 -> 2
    model = _flow_model(2)
    out["flow"] = FlowInference(model, min_overlap=8, mesh=mesh)(*flow_args).numpy()
    waved = FlowInference(model, min_overlap=8, mesh=mesh, wave_size=1)
    out["wave_size"] = waved.wave_size
    out["flow_waves"] = waved(*flow_args).numpy()
    out["eval"] = evaluate_classification.main(mesh_devices=2, **eval_args)
    return out


def _flow_images():
    rng = np.random.default_rng(3)
    shape = (1, 3, 16, 48)  # 3 tiles of 16x24 at overlap 8
    return (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)))


def test_trainer_checkpoints_sigterm_and_serving_on_two_ranks(tmp_path):
    from perceiverio_pytorch_tpu_torch.examples import evaluate_classification
    from perceiverio_pytorch_tpu_torch.models.flow import FlowInference
    from perceiverio_pytorch_tpu_torch.training.checkpoint import (
        latest_checkpoint,
        restore_train_state,
    )

    eval_args = dict(device="cpu", limit=16, batch_size=8)
    flow_args = _flow_images()
    results = run_ranks(_two_rank, 2, tmp_path, str(tmp_path), flow_args, eval_args)
    # the single-process Trainer's losses
    trainer = _trainer(None, None, str(tmp_path / "single.jsonl"))
    trainer.fit(trainer.init_state(_flow_model()), _flow_batches(4), num_steps=4)
    with open(tmp_path / "single.jsonl") as f:
        want_losses = [json.loads(line)["loss"] for line in f]
    np.testing.assert_allclose(results[0]["losses"], want_losses, **TOL)
    # one process restores the FSDP checkpoint to the same tensors
    assert sorted(os.listdir(tmp_path / "fit")) == ["step_00000002", "step_00000004"]
    single = trainer.init_state(_flow_model(1))
    single = restore_train_state(latest_checkpoint(str(tmp_path / "fit")), single)
    got, step = _flat(single)
    assert step == results[0]["fit_step"] == 4
    for r in results:
        assert set(r["fit"]) == set(got) == set(r["restored"])
        for key, value in got.items():
            assert torch.equal(value, r["fit"][key]), key
            assert torch.equal(value, r["restored"][key]), key
    # SIGTERM on rank 1: every rank stopped after step 3, one save
    assert [r["stopped_at"] for r in results] == [3, 3]
    assert results[0]["stop_dirs"] == ["step_00000003"]
    # FlowInference(mesh) against one process
    want = FlowInference(_flow_model(2), min_overlap=8, device="cpu")(*flow_args).numpy()
    for r in results:
        assert r["wave_size"] == 2
        np.testing.assert_allclose(r["flow"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["flow_waves"], want, rtol=1e-5, atol=1e-5)
    # evaluate_classification --mesh 2 against no mesh
    single_eval = evaluate_classification.main(**eval_args)
    for r in results:
        assert {k: r["eval"][k] for k in ("images", "top1", "top5")} == \
            {k: single_eval[k] for k in ("images", "top1", "top5")}


def _data_rank(rank, world, tmp):
    from perceiverio_pytorch_tpu_torch.parallel import (
        batch_sharding,
        local_batch_size,
        make_mesh,
        shard_host_batch,
    )
    from perceiverio_pytorch_tpu_torch.parallel.multihost import data_rows
    from perceiverio_pytorch_tpu_torch.training import (
        batch_iterator,
        dataset_iterator,
        prefetch_to_device,
    )
    from perceiverio_pytorch_tpu_torch.training.data import process_slice

    mesh = make_mesh((2, 2), device="cpu")
    arrays = (np.arange(48, dtype=np.int64).reshape(24, 2), np.arange(24, dtype=np.int64))

    class Items:
        def __len__(self):
            return 24

        def __getitem__(self, i):
            return arrays[0][i], arrays[1][i]

    rows = [b[1].tolist() for b in batch_iterator(arrays, 8, shuffle=True, seed=3,
                                                  shard_by_process=True)]
    items = [b[1].tolist() for b in dataset_iterator(Items(), 8, shuffle=True, seed=3,
                                                     shard_by_process=True, num_workers=0)]
    local = next(batch_iterator(arrays, 8, shuffle=True, seed=3, shard_by_process=True))
    assembled = shard_host_batch(tuple(torch.from_numpy(a) for a in local), mesh)
    prefetched = next(prefetch_to_device(iter([arrays]), 1, device="cpu",
                                         sharding=batch_sharding(mesh)))
    return dict(rows=rows, items=items, slice=process_slice(8, True),
                data_rows=data_rows(8), local=local_batch_size(8),
                assembled=[a.tolist() for a in assembled], coord=mesh.get_coordinate(),
                prefetched=prefetched[1].tolist())


def test_batches_slice_by_the_data_coordinate(tmp_path):
    """On a (2, 2) mesh: ranks 0 and 1 (data coordinate 0) get rows 0-3 of
    each global batch of 8, ranks 2 and 3 rows 4-7, as the JAX package's
    processes get their contiguous pieces (``data.py:116-129``)."""
    from perceiverio_pytorch_tpu.training import batch_iterator as jax_batch_iterator

    results = run_ranks(_data_rank, 4, tmp_path, str(tmp_path))
    arrays = (np.arange(48, dtype=np.int64).reshape(24, 2), np.arange(24, dtype=np.int64))
    whole = [b[1].tolist() for b in jax_batch_iterator(arrays, 8, shuffle=True, seed=3)]
    for rank, r in enumerate(results):
        data = rank // 2
        assert list(r["coord"]) == [data, rank % 2]
        assert r["slice"] == r["data_rows"] == (4 * data, 4 * data + 4)
        assert r["local"] == 4
        assert r["rows"] == r["items"] == [b[4 * data:4 * data + 4] for b in whole]
        assert r["assembled"][1] == whole[0]
        assert r["prefetched"] == list(range(12 * data, 12 * data + 12))
    assert results[0]["rows"] == results[1]["rows"] != results[2]["rows"] == results[3]["rows"]
