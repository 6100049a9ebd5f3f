"""``Policy(pp_mesh=...)`` in the flow model and with the options it
composes with, on 4 gloo ranks (``tests/test_pipeline.py``): int8 static,
dropout, sequence parallelism beside it and a pipe axis of one stage.

One spawned group of 4 (``test_torch_parallel.run_ranks``) builds
``make_pipeline_mesh(4)`` and a (2 data, 2 pipe) mesh, on JAX's weights of
the 4-layer encoder of ``test_torch_pipeline_policy.py``
(``state_dict_from_flax``):

  * the tiny flow model, its decoder projection drawn at random so that
    the flow is not 0, against JAX's (JAX :630);
  * int8 static: the calibration pass runs the sequential stack (the same
    amax as the model without the pipeline), then piped == sequential at 1
    and 2 blocks and v = 2 (rtol 2e-4 / atol 2e-5; JAX :698);
  * dropout: reproducible, seed-dependent, dropping, finite gradients in
    every stack parameter, 2 SGD steps moving every parameter alike on
    every rank (JAX :378, :404, :766);
  * sequence parallelism beside it (sp_mesh (2, 2), 131 tokens: the
    encoder's cross-attend over the keys, the stack over the pipe; JAX
    :803 with (2, 4) and (2 data, 4 pipe)): forward and every gradient
    against JAX's sequential encoder (gradients atol 1e-3);
  * a pipe axis of one stage (a (4 data, 1 pipe) mesh) runs the
    sequential stack, dropout included, bit for bit (JAX :836).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks
from test_torch_pipeline_policy import (
    TOL,
    B,
    D,
    N,
    _close,
    _close_grads,
    _encoder,
    _grads,
    _jax_encoder,
    _load,
)

torch.set_num_threads(1)
FLOW = dict(img_size=(16, 16), num_latents=8, num_latent_channels=32,
            num_self_attends_per_block=4, num_blocks=1)
# name -> (mesh (stages, data), blocks, circ_repeats)
INT8 = {"int8_b1": ((4, 1), 1, 1), "int8_b2": ((4, 1), 2, 1), "int8_circular": ((2, 2), 1, 2)}


def _ranks(rank, world, cases):
    from perceiverio_pytorch_tpu_torch import FlowPerceiver, Policy
    from perceiverio_pytorch_tpu_torch.ops.quant import calibrate
    from perceiverio_pytorch_tpu_torch.parallel import make_mesh, make_pipeline_mesh
    from perceiverio_pytorch_tpu_torch.training import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    meshes = {(4, 1): make_pipeline_mesh(4, device="cpu"),
              (2, 2): make_pipeline_mesh(2, data=2, device="cpu")}
    out = {}
    tokens, latents, sd = cases["flow"]
    policy = Policy(pp_mesh=meshes[(4, 1)], pp_microbatches=2)
    flow = FlowPerceiver(**FLOW, policy=policy, device="cpu")
    flow.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out["flow"] = flow(torch.from_numpy(tokens), torch.from_numpy(latents)).numpy()

    tokens, latents, sd = cases["int8"]
    x = (torch.from_numpy(tokens), torch.from_numpy(latents))
    for name, (mesh, blocks, circ) in INT8.items():
        seq = _load(_encoder(Policy(quant="int8_static"), num_blocks=blocks), sd)
        piped = _load(_encoder(Policy(quant="int8_static", pp_mesh=meshes[mesh],
                                      pp_microbatches=2, pp_circ_repeats=circ),
                               num_blocks=blocks), sd)
        calibrate(seq, [x])
        calibrate(piped, [x])  # the sequential stack under the pipeline's policy
        amax = {k: (v.item(), seq.state_dict()[k].item())
                for k, v in piped.state_dict().items() if k.endswith("amax")}
        with torch.no_grad():
            out[name] = dict(piped=piped(*x).numpy(), seq=seq(*x).numpy(), amax=amax)

    tokens, latents, sd = cases["dropout"]
    x = (torch.from_numpy(tokens), torch.from_numpy(latents))
    policy = Policy(pp_mesh=meshes[(4, 1)], pp_microbatches=2)
    drop = _load(_encoder(policy, dropout_prob=0.3), sd).train()

    def run(seed):
        with torch.no_grad():
            return drop(*x, generator=torch.Generator().manual_seed(seed)).numpy()

    out["dropout"] = dict(a1=run(1), a2=run(1), b=run(2))
    with torch.no_grad():
        out["dropout"]["det"] = drop.eval()(*x).numpy()
    drop = _load(_encoder(policy, dropout_prob=0.2), sd).train()
    (drop(*x, generator=torch.Generator().manual_seed(3)) ** 2).sum().backward()
    out["dropout_grads"] = _grads(drop)

    drop = _load(_encoder(policy, dropout_prob=0.1), sd)
    initial = {n: p.detach().clone() for n, p in drop.named_parameters()}
    tx = build_optimizer(1e-2, optimizer="sgd", momentum=None)
    state = create_train_state(drop, tx)
    step = make_train_step(lambda m, t, lat, g: (m(t, lat, generator=g) ** 2).mean(), tx)
    losses = []
    for i in range(2):
        state, loss = step(state, *x, torch.Generator().manual_seed(7 + i))
        losses.append(loss.item())
    out["dropout_train_step"] = dict(
        losses=losses, params={n: p.detach().numpy() for n, p in drop.named_parameters()},
        moved={n: bool((p.detach() != initial[n]).any()) for n, p in drop.named_parameters()
               if n != "latent_pos_enc.pos_embs"})

    tokens, latents, sd = cases["sp"]
    sp_mesh = make_mesh((2, 2), device="cpu")
    both = _load(_encoder(Policy(sp_mesh=sp_mesh, sp_axis="model", sp_min_kv=32,
                                 pp_mesh=meshes[(2, 2)], pp_microbatches=2)), sd)
    got = both(torch.from_numpy(tokens), torch.from_numpy(latents))
    (got ** 2).sum().backward()
    out["sp"] = dict(out=got.detach().numpy(), grads=_grads(both))

    tokens, latents, sd = cases["single_stage"]
    one = make_pipeline_mesh(1, data=4, device="cpu")
    x = (torch.from_numpy(tokens), torch.from_numpy(latents))
    got = []
    for policy in (Policy(pp_mesh=one, pp_microbatches=2), Policy()):
        model = _load(_encoder(policy, dropout_prob=0.1), sd).train()
        with torch.no_grad():
            got.append(model(*x, generator=torch.Generator().manual_seed(1)).numpy())
    out["single_stage"] = got
    return out


def _jax_oracle():
    """The cases each rank runs (inputs and the port's state_dict of JAX's
    weights) and JAX's sequential encoder on the 131 tokens."""
    import jax
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu.config import Policy
    from perceiverio_pytorch_tpu.models import FlowPerceiver
    from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

    def numpy_sd(variables):
        return {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}

    latents = np.random.default_rng(0).standard_normal((B, N, D)).astype(np.float32)
    tokens = np.random.default_rng(4).standard_normal((B, 10, D)).astype(np.float32)
    model = _jax_encoder(Policy())
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), tokens, latents))
    sd4 = numpy_sd(variables)
    cases, want = {}, {}
    for name, seed in (("int8", 10), ("dropout", 7)):
        x = np.random.default_rng(seed).standard_normal((B, 10, D)).astype(np.float32)
        cases[name] = (x, latents, sd4)
    # 131 keys: the sequence-parallel split pads them to the axis
    x = np.random.default_rng(11).standard_normal((B, 131, D)).astype(np.float32)

    def loss(params):
        out = model.apply({"params": params}, x, latents)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    want["sp"], want["sp_grads"] = np.asarray(out), numpy_sd({"params": g})
    cases["sp"] = (x, latents, sd4)
    cases["single_stage"] = tuple(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        for seed, shape in ((12, (2, 10, D)), (13, (2, N, D)))) + (sd4,)

    rng = np.random.default_rng(8)
    im1, im2 = (rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32) for _ in range(2))
    flow = FlowPerceiver(policy=Policy(), **FLOW)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(flow.init)(
        jax.random.PRNGKey(0), im1, im2))
    final = variables["params"]["perceiver"]["decoder"]["final_layer"]
    # zero-initialised by design, which would make the flow exactly 0
    final["kernel"] = rng.standard_normal(final["kernel"].shape).astype(np.float32) * 0.1
    cases["flow"] = (im1, im2, numpy_sd(variables))
    want["flow"] = np.asarray(jax.jit(flow.apply)(variables, im1, im2))
    return cases, want


@pytest.fixture(scope="module")
def oracle():
    return _jax_oracle()


@pytest.fixture(scope="module")
def ranks(oracle, tmp_path_factory):
    return run_ranks(_ranks, 4, tmp_path_factory.mktemp("pp_options"), oracle[0])


def test_policy_pp_mesh_flow_model(oracle, ranks):
    _close(ranks, "flow", oracle[1]["flow"])


@pytest.mark.parametrize("name", list(INT8))
def test_policy_pp_mesh_with_int8_static(ranks, name):
    """Calibration runs the sequential stack (the same amax as the model
    without the pipeline); then each layer streams its own amax through its
    stage: the sequential int8 model's outputs."""
    for got in ranks:
        got = got[name]
        assert got["amax"] and all(a == b > 0 for a, b in got["amax"].values()), got["amax"]
        np.testing.assert_allclose(got["piped"], got["seq"], **TOL)
    for got in ranks[1:]:
        np.testing.assert_array_equal(got[name]["piped"], ranks[0][name]["piped"])


def test_policy_pp_mesh_dropout_training(ranks):
    """Dropout through the pipeline: reproducible for a seed, another for
    another, dropping, finite; the same on every rank."""
    for got in ranks:
        got = got["dropout"]
        np.testing.assert_array_equal(got["a1"], got["a2"])
        assert not np.allclose(got["a1"], got["b"])
        assert not np.allclose(got["a1"], got["det"])
        assert np.all(np.isfinite(got["a1"]))
        np.testing.assert_array_equal(got["a1"], ranks[0]["dropout"]["a1"])


def test_policy_pp_mesh_dropout_gradients(ranks):
    for got in ranks:
        grads = got["dropout_grads"]
        assert grads and all(np.all(np.isfinite(g)) for g in grads.values())
        stack = [g for k, g in grads.items() if k.startswith("self_attends.")]
        assert len(stack) == 4 * 16 and all(np.any(g != 0) for g in stack)


def test_policy_pp_mesh_dropout_train_step(ranks):
    """Two SGD steps, a seed a step: finite losses, every parameter moved,
    and the replicas equal on every rank."""
    first = ranks[0]["dropout_train_step"]
    for got in ranks:
        got = got["dropout_train_step"]
        assert all(np.isfinite(got["losses"])) and all(got["moved"].values())
        assert got["losses"] == first["losses"]
        for key, value in first["params"].items():
            np.testing.assert_array_equal(got["params"][key], value, err_msg=key)


def test_policy_pp_mesh_composes_with_sequence_parallel(oracle, ranks):
    """The cross-attend's 131 keys split over sp_mesh's model axis while the
    stack pipelines over the pp mesh: outputs and gradients sequential."""
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["sp"]["out"], oracle[1]["sp"], **TOL)
        _close_grads(got["sp"]["grads"], oracle[1]["sp_grads"], f"sp rank {rank}")


def test_policy_pp_mesh_single_stage_falls_back_sequential(ranks):
    """A pipe axis of one: the sequential stack runs, dropout included, bit
    for bit the model without the mesh."""
    for got in ranks:
        piped, plain = got["single_stage"]
        assert np.isfinite(piped).all()
        np.testing.assert_array_equal(piped, plain)
