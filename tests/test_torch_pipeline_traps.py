"""Each trap of the pipeline's gradient plumbing, reintroduced, fails.

The pipeline runs one autograd graph a rank whose hops must meet in the
backward, and its loss is replicated over the ranks (``parallel/pipeline``).
Four one-line mutations, each in its own spawned gloo group of 2
(``test_torch_parallel.run_ranks``), patched inside the ranks:

  * the hop's backward skips its send (``collectives._RingHop``): the
    peers' receives wait and the ranks fail;
  * stage 0 drops what it received instead of keeping it in the graph at a
    zero gradient (``pipeline._Join``): the hop's backward runs on one side
    only, and the ranks fail;
  * the last stage's outputs reach the ranks through ``all_reduce_sum`` in
    place of ``reduce_from``: every gradient is scaled by the 2 stages;
  * the replicated layers' gradients are not summed over the pipe axis
    (``copy_to_many`` without its groups): each rank keeps its stage's
    only, and the replicas drift apart in a train step.

The hops wait at most 10 s in these runs (``exchange`` bounded), so that a
receive nothing will meet fails fast instead of at the group's timeout.
The unmutated run in the same code path holds the gradients and the
replicas (``test_torch_pipeline_grads.py``, ``test_torch_pipeline_policy.py``
hold them against JAX).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
B, N, D = 4, 8, 16
WAIT_S = 10


def _bounded_exchange(t, send_to, recv_from, group):
    from datetime import timedelta

    import torch.distributed as dist

    out = torch.empty_like(t)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t.contiguous(), send_to, group),
                                    dist.P2POp(dist.irecv, out, recv_from, group)])
    for work in works:
        work.wait(timedelta(seconds=WAIT_S))
    return out


def _receive_only(ctx, g):
    from datetime import timedelta

    import torch.distributed as dist

    out = torch.empty_like(g)
    dist.irecv(out, ctx.next, ctx.group).wait(timedelta(seconds=WAIT_S))
    return out, None


def _encoder(policy):
    from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverEncoder

    return PerceiverEncoder(num_input_channels=D, num_self_attends_per_block=4, num_blocks=1,
                            num_latents=N, num_latent_channels=D, num_self_attend_heads=2,
                            num_cross_attend_heads=1, policy=policy,
                            generator=torch.Generator().manual_seed(0))


def _ranks(rank, world, mutation):
    from perceiverio_pytorch_tpu_torch import Policy
    from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
    from perceiverio_pytorch_tpu_torch.parallel import make_pipeline_mesh
    from perceiverio_pytorch_tpu_torch.parallel import pipeline as pp
    from perceiverio_pytorch_tpu_torch.training import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    mesh = make_pipeline_mesh(world, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens, latents = torch.randn(B, 6, D, generator=gen), torch.randn(B, N, D, generator=gen)
    patches = [mock.patch.object(cc, "exchange", _bounded_exchange)]
    if mutation == "hop_skips_send":
        patches.append(mock.patch.object(cc._RingHop, "backward", staticmethod(_receive_only)))
    elif mutation == "stage0_drops_received":
        join = pp._Join.apply  # stage 0's join is the one of two tensors shaped alike
        patches.append(mock.patch.object(pp._Join, "apply", lambda first, second: (
            first if first.shape == second.shape else join(first, second))))
    elif mutation == "broadcast_scaled":
        patches.append(mock.patch.object(cc, "reduce_from", cc.all_reduce_sum))
    elif mutation == "grads_unsummed":
        many = cc.copy_to_many
        patches.append(mock.patch.object(
            cc, "copy_to_many", lambda ts, groups: many(ts, [groups[0]] + [()] * len(ts[1:]))))
    seq = _encoder(Policy())
    piped = _encoder(Policy(pp_mesh=mesh, pp_microbatches=2))
    for p in patches:
        p.start()
    try:
        out = {}
        for name, model in (("seq", seq), ("piped", piped)):
            (model(tokens, latents) ** 2).sum().backward()
            out[name] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                         if p.grad is not None}
        tx = build_optimizer(1e-2, optimizer="sgd", momentum=None)
        state = create_train_state(piped, tx)
        step = make_train_step(lambda m, t, lat: (m(t, lat) ** 2).mean(), tx)
        for _ in range(2):
            state, _ = step(state, tokens, latents)
        out["trained"] = {n: p.detach().numpy().copy() for n, p in piped.named_parameters()}
    finally:
        for p in patches:
            p.stop()
    return out


def _grads_match(got):
    return all(np.allclose(got["piped"][k], v, rtol=2e-4, atol=1e-3)
               for k, v in got["seq"].items() if not k.endswith("proj_k.bias"))


def test_control_run_holds(tmp_path):
    """The unmutated run under the same bounded hops: every gradient the
    sequential encoder's, the replicas equal after two steps."""
    results = run_ranks(_ranks, 2, tmp_path, None)
    assert all(_grads_match(r) for r in results)
    for k, v in results[0]["trained"].items():
        np.testing.assert_array_equal(results[1]["trained"][k], v, err_msg=k)


@pytest.mark.parametrize("mutation", ["hop_skips_send", "stage0_drops_received"])
def test_unmatched_hop_backward_fails(tmp_path, mutation):
    """A receive that no send meets times out (the bounded wait)."""
    with pytest.raises(pytest.fail.Exception, match="Timed out waiting"):
        run_ranks(_ranks, 2, tmp_path, mutation, deadline_s=60)


def test_scaled_broadcast_fails(tmp_path):
    results = run_ranks(_ranks, 2, tmp_path, "broadcast_scaled")
    assert not any(_grads_match(r) for r in results)
    stack = [k for k in results[0]["seq"] if k.startswith("self_attends.")]
    for k in stack:  # every stack gradient doubled: one copy a stage
        if not k.endswith("proj_k.bias"):
            np.testing.assert_allclose(results[0]["piped"][k], 2 * results[0]["seq"][k],
                                       rtol=2e-4, atol=1e-3, err_msg=k)


def test_unsummed_replicated_gradients_fail(tmp_path):
    results = run_ranks(_ranks, 2, tmp_path, "grads_unsummed")
    assert not any(_grads_match(r) for r in results)
    drift = [k for k, v in results[0]["trained"].items()
             if not np.array_equal(results[1]["trained"][k], v)]
    assert drift and all(k.startswith("self_attends.") for k in drift), drift
