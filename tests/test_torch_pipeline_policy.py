"""``Policy(pp_mesh=...)``: the encoder's self-attend stack as a pipeline,
on 4 gloo ranks, against the JAX package's sequential models
(``tests/test_pipeline.py``).

One spawned group of 4 (``test_torch_parallel.run_ranks``) builds
``make_pipeline_mesh(4)`` (JAX's) and a (2 data, 2 pipe) mesh (JAX: 2
stages on 8 devices); every rank holds every layer (JAX's ``_pipelined``
stacks the module's variables at apply time) and runs its stage's.  On
JAX's weights (``state_dict_from_flax``), each rank's results are held
against JAX's sequential apply at rtol 2e-4 / atol 2e-5, gradients at
atol 1e-3:

  * the encoder at 1 and 2 blocks, the circular schedule (8 layers, v = 2,
    4 microbatches), every parameter's gradient (JAX :320, :272, :338);
  * remat at v = 1 and 2: forward and every gradient (JAX :661);
  * the refusals with JAX's messages (JAX :365).

The flow model, int8, dropout, sequence parallelism beside it and the
one-stage fallback run in ``test_torch_pipeline_options.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-3)
B, N, D = 8, 16, 32
# name -> (mesh (stages, data), layers, blocks, microbatches, circ_repeats, remat)
FORWARD = {
    "encoder_b1": ((4, 1), 4, 1, 2, 1, False),
    "encoder_b2": ((4, 1), 4, 2, 2, 1, False),
    "encoder_circular": ((2, 2), 8, 1, 4, 2, False),
    "remat_v1": ((4, 1), 4, 2, 2, 1, True),
    "remat_v2": ((2, 2), 4, 2, 2, 2, True),
}
GRADS = ("encoder_b1", "remat_v1", "remat_v2")


def _encoder(policy, n_layers=4, num_blocks=1, dropout_prob=0.0, remat=False):
    from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverEncoder

    return PerceiverEncoder(
        num_input_channels=D, num_self_attends_per_block=n_layers, num_blocks=num_blocks,
        num_latents=N, num_latent_channels=D, num_self_attend_heads=4,
        num_cross_attend_heads=1, dropout_prob=dropout_prob, policy=policy, remat=remat,
        generator=torch.Generator().manual_seed(0))


def _load(model, state_dict):
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=False)
    assert not unexpected and all(k.endswith(("amax", "latent_pos_enc.pos_embs"))
                                  for k in missing), (missing, unexpected)
    return model


def _grads(model):
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


def _ranks(rank, world, cases):
    from perceiverio_pytorch_tpu_torch import Policy
    from perceiverio_pytorch_tpu_torch.parallel import make_pipeline_mesh

    meshes = {(4, 1): make_pipeline_mesh(4, device="cpu"),
              (2, 2): make_pipeline_mesh(2, data=2, device="cpu")}
    out = {}
    for name, (mesh, n_layers, blocks, num_mb, circ, remat) in FORWARD.items():
        tokens, latents, sd = cases[name]
        policy = Policy(pp_mesh=meshes[mesh], pp_microbatches=num_mb, pp_circ_repeats=circ)
        model = _load(_encoder(policy, n_layers, blocks, remat=remat), sd)
        got = model(torch.from_numpy(tokens), torch.from_numpy(latents))
        out[name] = got.detach().numpy()
        if name in GRADS:
            (got ** 2).sum().backward()
            out[name + "_grads"] = _grads(model)

    tokens, latents, sd = cases["guard"]
    errors = {}
    try:
        _load(_encoder(Policy(pp_mesh=meshes[(4, 1)]), n_layers=3), sd)(
            torch.from_numpy(tokens), torch.from_numpy(latents))
    except ValueError as exc:
        errors["layers"] = str(exc)
    for field, value in (("pp_axis", "model"), ("pp_circ_repeats", 0)):
        try:
            Policy(pp_mesh=meshes[(4, 1)], **{field: value})
        except ValueError as exc:
            errors[field] = str(exc)
    out["errors"] = errors
    return out


def _jax_encoder(policy, n_layers=4, num_blocks=1, remat=False):
    from perceiverio_pytorch_tpu.core.perceiver import PerceiverEncoder

    return PerceiverEncoder(
        num_input_channels=D, num_self_attends_per_block=n_layers, num_blocks=num_blocks,
        num_latents=N, num_latent_channels=D, num_self_attend_heads=4,
        num_cross_attend_heads=1, policy=policy, remat=remat)


def _jax_oracle():
    """The cases each rank runs (inputs and the port's state_dicts of JAX's
    weights) and JAX's sequential outputs, gradients and messages."""
    import jax
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu.config import Policy
    from perceiverio_pytorch_tpu.parallel import make_pipeline_mesh
    from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

    def numpy_sd(variables):
        return {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}

    latents = np.random.default_rng(0).standard_normal((B, N, D)).astype(np.float32)
    tokens = np.random.default_rng(4).standard_normal((B, 10, D)).astype(np.float32)
    cases, want = {}, {}

    def run(model, variables, x, lat, grads=True):
        """JAX's output (and every gradient of sum(out ** 2))."""
        def loss(params):
            out = model.apply({"params": params}, x, lat)
            return jnp.sum(out ** 2), out

        if not grads:
            return np.asarray(jax.jit(model.apply)(variables, x, lat)), None
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
        return np.asarray(out), numpy_sd({"params": g})

    # One init a layer count: the blocks share their weights, and the
    # parameters' shapes do not depend on the token count.
    init = {n: jax.tree_util.tree_map(np.asarray, jax.jit(_jax_encoder(Policy(), n).init)(
        jax.random.PRNGKey(0), tokens, latents)) for n in (4, 8)}
    sd4 = numpy_sd(init[4])
    want["encoder_b1"], want["encoder_b1_grads"] = run(_jax_encoder(Policy()), init[4],
                                                       tokens, latents)
    # The remat runs are held against the 2-block encoder without remat:
    # jax.checkpoint changes no value.
    want["encoder_b2"], want["encoder_b2_grads"] = run(_jax_encoder(Policy(), num_blocks=2),
                                                       init[4], tokens, latents)
    for name in ("remat_v1", "remat_v2"):
        want[name], want[name + "_grads"] = want["encoder_b2"], want["encoder_b2_grads"]
    want["encoder_circular"], _ = run(_jax_encoder(Policy(), 8), init[8], tokens, latents,
                                      grads=False)
    for name in FORWARD:
        cases[name] = (tokens, latents, numpy_sd(init[8]) if name == "encoder_circular"
                       else sd4)
    three = {"params": dict(init[4]["params"], self_attends={
        k: v for k, v in init[4]["params"]["self_attends"].items() if k != "3"})}
    cases["guard"] = (tokens, latents, numpy_sd(three))
    errors = {}
    mesh = make_pipeline_mesh(4)
    for key, policy in (("layers", Policy(pp_mesh=mesh)),
                        ("pp_axis", Policy(pp_mesh=mesh, pp_axis="model")),
                        ("pp_circ_repeats", Policy(pp_mesh=mesh, pp_circ_repeats=0))):
        with pytest.raises(ValueError) as raised:
            _jax_encoder(policy, n_layers=3).apply(three, tokens, latents)
        errors[key] = str(raised.value)
    want["errors"] = errors

    return cases, want


@pytest.fixture(scope="module")
def oracle():
    return _jax_oracle()


@pytest.fixture(scope="module")
def ranks(oracle, tmp_path_factory):
    return run_ranks(_ranks, 4, tmp_path_factory.mktemp("pp_policy"), oracle[0])


def _close(results, name, want, tol=TOL):
    for rank, got in enumerate(results):
        np.testing.assert_allclose(got[name], want, err_msg=f"{name} rank {rank}", **tol)


def _close_grads(got, want, label):
    assert set(got) == set(want), label
    for key, value in want.items():
        if key.endswith("proj_k.bias"):
            # its exact gradient is 0 (a shift shared by a row's logits): both
            # hold rounding noise, small against the projection's weight's
            weight = np.abs(want[key[:-len("bias")] + "weight"]).max()
            assert max(np.abs(got[key]).max(), np.abs(value).max()) <= 1e-4 * weight, label
            continue
        np.testing.assert_allclose(got[key], value, err_msg=f"{label} {key}", **GRAD_TOL)


@pytest.mark.parametrize("name", ["encoder_b1", "encoder_b2"])
def test_policy_pp_mesh_encoder_matches_sequential(oracle, ranks, name):
    _close(ranks, name, oracle[1][name])


def test_policy_pp_circ_repeats_encoder_matches_sequential(oracle, ranks):
    _close(ranks, "encoder_circular", oracle[1]["encoder_circular"])


def test_policy_pp_mesh_encoder_gradients(oracle, ranks):
    """Every parameter's gradient on every rank: the stack's summed over
    the pipe, the cross-attend's from the whole latents' gradient."""
    for rank, got in enumerate(ranks):
        _close_grads(got["encoder_b1_grads"], oracle[1]["encoder_b1_grads"], f"rank {rank}")


def test_policy_pp_mesh_guards(oracle, ranks):
    """A layer count the stages do not divide, an axis the mesh lacks and a
    repeat count below 1 raise JAX's ValueErrors."""
    for got in ranks:
        assert got["errors"] == oracle[1]["errors"]


@pytest.mark.parametrize("name", ["remat_v1", "remat_v2"])
def test_policy_pp_mesh_composes_with_remat(oracle, ranks, name):
    """Each (tick, stage) body rematerialised on its own: the outputs and
    every gradient are the sequential encoder's."""
    _close(ranks, name, oracle[1][name])
    for rank, got in enumerate(ranks):
        _close_grads(got[name + "_grads"], oracle[1][name + "_grads"], f"{name} rank {rank}")
