"""The pipeline over gloo ranks, one stage a rank: outputs, every gradient
and the memory-scaling training route, against the JAX package's
sequential stack (``tests/test_pipeline.py``).

One spawned group of 4 (``test_torch_parallel.run_ranks``) and one of 2
run ``pipelined_self_attends`` on 8 ``SelfAttention`` layers with JAX's
weights (``state_dict_from_flax``): GPipe at S = 4 and 2, circular at (4,
v = 2) and (2, v = 2), a (2 data, 2 pipe) mesh (JAX: (2, 4)), the stacked
form, two weight-shared blocks and a generic stage body.  Each returns the
output and the gradients of sum(out ** 2) (scaled by 2^-6 for two blocks)
in every layer and in the latents on every rank, held against JAX's sequential apply and its
``jax.grad`` at rtol 2e-4 / atol 2e-5 (gradients atol 1e-3, JAX's).  The
hop's backward sends each gradient back a stage and the parameters'
gradients are summed over the pipe axis, so every rank must hold every
layer's whole gradient.

The memory-scaling route (JAX :476, :567): ``stack_layer_params`` pieces
placed by ``pp_param_shardings`` ([1, per, ...] a rank) and SGD with
momentum 0.9 (``torch.optim.SGD``, optax's ``sgd`` rule), 3 GPipe steps on
4 ranks and 2 circular ones on 2: each loss and the gathered, unstacked
parameters against JAX's sequential training, each rank's moments its
stage's only.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-3)  # sum-of-squares gradients are O(100)
B, N, D = 8, 16, 32
N_LAYERS = 8
LR, MOMENTUM = 1e-2, 0.9
# Scales of the loss sum(out ** 2) by the number of blocks (powers of two:
# exact), so that its gradients are O(100) as JAX's atol assumes.
LOSS_SCALE = {1: 1.0, 2: 2.0 ** -6}
# name -> (world, n_stages, data, num_microbatches, circ_repeats, extra keywords)
RUNS = {
    "gpipe_s4": (4, 4, 1, 4, 1, {}),
    "circular_s4": (4, 4, 1, 4, 2, {}),
    "data2_pipe2": (4, 2, 2, 2, 1, {}),
    "blocks2_s4": (4, 4, 1, 4, 1, dict(num_blocks=2)),
    "gpipe_s2": (2, 2, 1, 8, 1, {}),
    "circular_s2": (2, 2, 1, 4, 2, {}),
}
# name -> (world, n_stages, num_microbatches, circ_repeats, steps)
TRAIN = {"sharded_gpipe": (4, 4, 4, 1, 3), "sharded_circular": (2, 2, 4, 2, 2)}


def _layers(state_dicts):
    from perceiverio_pytorch_tpu_torch.core.attention import SelfAttention

    layers = []
    for sd in state_dicts:
        layer = SelfAttention(in_channels=D, num_heads=4, widening_factor=1)
        layer.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        layers.append(layer)
    return layers


def _grads(layers, x):
    return dict(latents=x.grad.numpy().copy(),
                **{f"{i}.{n}": p.grad.numpy().copy() for i, layer in enumerate(layers)
                   for n, p in layer.named_parameters()})


def _ranks(rank, world, state_dicts, latents, generic):
    from perceiverio_pytorch_tpu_torch.parallel import (
        make_pipeline_mesh,
        pipeline_spmd,
        pipelined_self_attends,
        pp_param_shardings,
        stack_layer_params,
        unstack_layer_params,
    )
    from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
    from perceiverio_pytorch_tpu_torch.parallel.mesh import axis

    out = {}
    meshes = {}
    for name, (w, n_stages, data, num_mb, circ, kw) in RUNS.items():
        if w != world:
            continue
        mesh = meshes.setdefault((n_stages, data), make_pipeline_mesh(n_stages, data=data,
                                                                      device="cpu"))
        layers = _layers(state_dicts)
        by_layer = {str(i): dict(layer.named_parameters()) for i, layer in enumerate(layers)}
        x = torch.from_numpy(latents).requires_grad_()
        got = pipelined_self_attends(layers[0], by_layer, x, mesh, num_microbatches=num_mb,
                                     circ_repeats=circ, **kw)
        ((got ** 2).sum() * LOSS_SCALE[kw.get("num_blocks", 1)]).backward()
        out[name] = dict(out=got.detach().numpy(), grads=_grads(layers, x))
    if world == 4:
        mesh = meshes[(4, 1)]
        layers = _layers(state_dicts)
        stacked = stack_layer_params(
            {str(i): dict(layer.named_parameters()) for i, layer in enumerate(layers)}, 4)
        with torch.no_grad():
            out["stacked_s4"] = pipelined_self_attends(
                layers[0], stacked, torch.from_numpy(latents), mesh, num_microbatches=4,
                stacked=True).numpy()

        def stage_fn(local_w, h):
            for wi in local_w:
                h = torch.tanh(h @ wi)
            return h

        w, x = (torch.from_numpy(a) for a in generic)
        with torch.no_grad():
            out["generic_s4"] = pipeline_spmd(stage_fn, w, x, mesh, num_microbatches=4).numpy()

    for name, (w, n_stages, num_mb, circ, steps) in TRAIN.items():
        if w != world:
            continue
        mesh = meshes.setdefault((n_stages, 1), make_pipeline_mesh(n_stages, device="cpu"))
        layers = _layers(state_dicts)
        stacked = stack_layer_params(
            {str(i): {n: p.detach() for n, p in layer.named_parameters()}
             for i, layer in enumerate(layers)}, n_stages, circ_repeats=circ)
        shardings = pp_param_shardings(stacked, mesh)
        pieces = {k: shardings[k].shard(v).clone().requires_grad_() for k, v in stacked.items()}
        opt = torch.optim.SGD(list(pieces.values()), lr=LR, momentum=MOMENTUM)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            got = pipelined_self_attends(layers[0], pieces, torch.from_numpy(latents), mesh,
                                         num_microbatches=num_mb, stacked=True,
                                         circ_repeats=circ)
            loss = (got ** 2).mean()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        pipe = axis(mesh, "pipe").group
        whole = {k: cc.all_gather_dim(p.detach(), 0, pipe) for k, p in pieces.items()}
        out[name] = dict(
            losses=losses,
            local={k: tuple(p.shape) for k, p in pieces.items()},
            moments={k: tuple(opt.state[p]["momentum_buffer"].shape) for k, p in pieces.items()},
            final={f"{i}.{n}": t.numpy() for i, tree in unstack_layer_params(
                whole, circ_repeats=circ).items() for n, t in tree.items()})
    return out


def _jax_oracle():
    """JAX's layer params (numpy), the port's per-layer state_dicts of them,
    the latents, the generic stage's weights and input, and JAX's
    sequential outputs, gradients and training runs."""
    import jax
    import jax.numpy as jnp
    import optax

    from perceiverio_pytorch_tpu.core.attention import SelfAttention
    from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

    layer = SelfAttention(in_channels=D, num_heads=4, widening_factor=1)
    zeros = jnp.zeros((1, N, D), jnp.float32)
    params = {str(i): jax.tree_util.tree_map(np.asarray, jax.jit(layer.init)(
        jax.random.PRNGKey(i), zeros)["params"]) for i in range(N_LAYERS)}
    latents = np.random.default_rng(0).standard_normal((B, N, D)).astype(np.float32)

    # The sequential stack as a scan over the layers stacked [L, ...] (one
    # layer body to compile; JAX's scan is exact against its unrolled loop).
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                     *[params[str(i)] for i in range(N_LAYERS)])

    def seq(stacked, x, num_blocks=1):
        for _ in range(num_blocks):
            x, _ = jax.lax.scan(
                lambda h, p: (layer.apply({"params": p}, h, deterministic=True), None),
                x, stacked)
        return x

    def port_names(tree):
        out = {}
        for i in range(N_LAYERS):
            layer_tree = jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]), tree)
            sd = state_dict_from_flax({"params": layer_tree})
            out.update({f"{i}.{k}": v.numpy() for k, v in sd.items()})
        return out

    want = {}
    for blocks in (1, 2):
        def loss(p, x, nb=blocks):
            out = seq(p, x, nb)
            return jnp.sum(out ** 2) * LOSS_SCALE[nb], out

        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            stacked, latents)
        want[blocks] = dict(out=np.asarray(out),
                            grads=dict(latents=np.asarray(gx), **port_names(gp)))
    tx = optax.sgd(LR, momentum=MOMENTUM)

    @jax.jit
    def step(p, opt):
        loss, g = jax.value_and_grad(lambda p: jnp.mean(seq(p, latents) ** 2))(p)
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt, loss

    p, opt, losses, finals = stacked, tx.init(stacked), [], []
    for _ in range(3):
        p, opt, loss = step(p, opt)
        losses.append(float(loss))
        finals.append(port_names(p))
    w = np.random.default_rng(2).standard_normal((4, 1, D, D)).astype(np.float32)
    x = np.random.default_rng(3).standard_normal((B, D)).astype(np.float32)
    h = jnp.asarray(x)
    for i in range(4):
        h = jnp.tanh(h @ w[i, 0])
    state_dicts = [{k: v.numpy() for k, v in state_dict_from_flax(
        {"params": params[str(i)]}).items()} for i in range(N_LAYERS)]
    return dict(state_dicts=state_dicts, latents=latents, want=want, losses=losses,
                finals=finals, generic=(w, x), generic_out=np.asarray(h))


@pytest.fixture(scope="module")
def oracle():
    return _jax_oracle()


@pytest.fixture(scope="module")
def group4(oracle, tmp_path_factory):
    return run_ranks(_ranks, 4, tmp_path_factory.mktemp("pp4"), oracle["state_dicts"],
                     oracle["latents"], oracle["generic"])


@pytest.fixture(scope="module")
def group2(oracle, tmp_path_factory):
    return run_ranks(_ranks, 2, tmp_path_factory.mktemp("pp2"), oracle["state_dicts"],
                     oracle["latents"], oracle["generic"])


def _check_run(results, name, want):
    for rank, got in enumerate(results):
        got = got[name]
        np.testing.assert_allclose(got["out"], want["out"], err_msg=f"{name} rank {rank}",
                                   **TOL)
        assert set(got["grads"]) == set(want["grads"])
        for key, value in want["grads"].items():
            np.testing.assert_allclose(got["grads"][key], value,
                                       err_msg=f"{name} rank {rank} {key}", **GRAD_TOL)


@pytest.mark.parametrize("name", ["gpipe_s4", "circular_s4", "gpipe_s2", "circular_s2"])
def test_pipeline_gradients_match_sequential(oracle, group4, group2, name):
    """Every rank's output and every layer's and the latents' gradient:
    JAX's sequential stack's (JAX :109, :213)."""
    _check_run(group4 if RUNS[name][0] == 4 else group2, name, oracle["want"][1])


def test_pipeline_composes_with_data_parallel(oracle, group4):
    """A (2 data, 2 pipe) mesh: each microbatch's rows split over the data
    axis, the outputs gathered back; gradients summed over both axes."""
    _check_run(group4, "data2_pipe2", oracle["want"][1])


def test_pipeline_weight_shared_blocks(oracle, group4):
    """num_blocks = 2 re-enters the schedule with the same weights; their
    gradients add up over the blocks."""
    _check_run(group4, "blocks2_s4", oracle["want"][2])


def test_pipeline_from_stacked(oracle, group4):
    """The train-step form: the params stacked beforehand (stacked=True)."""
    for got in group4:
        np.testing.assert_allclose(got["stacked_s4"], oracle["want"][1]["out"], **TOL)


def test_generic_pipeline_spmd_stage_fn(oracle, group4):
    for got in group4:
        np.testing.assert_allclose(got["generic_s4"], oracle["generic_out"], **TOL)


@pytest.mark.parametrize("name", list(TRAIN))
def test_pp_sharded_training_parity(oracle, group4, group2, name):
    """Each rank holds its stage's [1, per, ...] pieces and their momentum
    only; the losses and the trained, gathered and unstacked parameters are
    JAX's sequential training's."""
    world, _, _, circ, steps = TRAIN[name]
    for rank, got in enumerate((group4 if world == 4 else group2)):
        got = got[name]
        np.testing.assert_allclose(got["losses"], oracle["losses"][:steps], rtol=2e-4,
                                   atol=1e-6, err_msg=f"{name} rank {rank}")
        for key, shape in got["local"].items():
            assert shape[0] == 1 and got["moments"][key] == shape, (name, key, shape)
        assert len(got["local"]["attention.proj_q.weight"]) == 4 + (circ > 1)
        want = oracle["finals"][steps - 1]
        assert set(got["final"]) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got["final"][key], value, err_msg=f"{name} {key}", **TOL)
