"""The gradients of every parameter under sequence parallelism, against the
same port model without it, on 2 gloo ranks (a (1, 2) mesh).

A rank's loss is replicated over the mesh axis, so each collective of the
sequence-parallel path has to send its gradient the other way: a mistake
scales a gradient by the axis size or keeps only a rank's share of it,
which no forward check sees.  One spawned group
(``test_torch_parallel.run_ranks``) runs, from the same weights and inputs
(61 tokens with a mask, so that the last shard is padded):

  * ``PerceiverIO(input_token_sharding=...)``: each rank keeps its half of
    the tokens; the key-side LayerNorm and K/V projections see only those,
    so their gradients are summed over the axis, and the input's padding
    embedding (before the split) gets the whole gradient back;
  * ``Policy(sp_mesh, sp_min_kv=32)`` with ``sp_impl`` "dense" and "flash"
    (the ring, plain K1/K2/K3 on the CPU tensors).

Each run's output and every parameter's gradient of one loss, on every
rank, equal the unsharded model's at the JAX tests' tolerances (rtol 1e-5
/ atol 1e-6 forward, rtol 1e-4 / atol 1e-5 gradients).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
WORLD = 2
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(num_blocks=1, num_self_attends_per_block=1, num_latents=4, num_latent_channels=32,
             final_project=True, final_project_out_channels=8, input_channels=16,
             input_padding_channels=2)
RUNS = ("input_sharded", "sp_dense", "sp_flash")


def _inputs():
    x = np.random.RandomState(5).randn(2, 61, 16).astype(np.float32)
    mask = np.random.RandomState(6).rand(2, 61) > 0.2
    return x, mask


def _model(state=None, **kw):
    from perceiverio_pytorch_tpu_torch import PerceiverIO, TrainableQuery

    gen = torch.Generator().manual_seed(0)
    model = PerceiverIO(**MODEL, output_queries=TrainableQuery(output_index_dims=3,
                                                               num_channels=16), generator=gen,
                        **kw)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


def _grads(model):
    """The output and every parameter's gradient of one loss, as numpy."""
    x, mask = (torch.from_numpy(a) for a in _inputs())
    model.zero_grad(set_to_none=True)
    out = model(x, input_mask=mask)
    (out ** 2).mean().backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None}
    return out.detach().numpy(), grads


def _ranks(rank, world, state):
    from perceiverio_pytorch_tpu_torch import Policy
    from perceiverio_pytorch_tpu_torch.parallel import MODEL_AXIS, NamedSharding, make_mesh

    mesh = make_mesh((1, world), device="cpu")
    runs = dict(
        input_sharded=dict(input_token_sharding=NamedSharding(mesh, (None, MODEL_AXIS))),
        sp_dense=dict(policy=Policy(sp_mesh=mesh, sp_min_kv=32, sp_impl="dense")),
        sp_flash=dict(policy=Policy(sp_mesh=mesh, sp_min_kv=32, sp_impl="flash")))
    return {name: _grads(_model(state, **kw)) for name, kw in runs.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    model = _model()
    want = _grads(model)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return want, run_ranks(_ranks, WORLD, tmp_path_factory.mktemp("sp_grads"), state)


@pytest.mark.parametrize("run", RUNS)
def test_sharded_outputs_and_gradients_equal_the_unsharded_model(results, run):
    (want_out, want_grads), ranks = results
    assert len(want_grads) > 20 and all(np.abs(g).max() > 0 for g in want_grads.values()
                                        if g.size > 1)
    for result in ranks:
        out, grads = result[run]
        np.testing.assert_allclose(out, want_out, **FWD_TOL, err_msg=run)
        assert set(grads) == set(want_grads)
        for name, want in want_grads.items():
            np.testing.assert_allclose(grads[name], want, **GRAD_TOL, err_msg=f"{run} {name}")
