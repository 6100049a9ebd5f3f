"""The pipeline's schedules and layouts in one process, against the JAX
package's sequential stack (``tests/test_pipeline.py``).

Given an int S in place of a mesh, ``parallel.pipeline``'s tick loop runs
S stages' ticks (the stage's ``_Stage.tick``, the one a rank runs) in this
process, each stage's output handed to the next in place of the ring's
send: ``pipeline_layers`` (the ``Policy.pp_mesh`` route's stage body, on
the stack's own layers) and ``pipeline_spmd`` (a stage function over
stacked parameters) through the same loop.  The GPipe
schedule at S = 8 and at JAX's (4, 4), (2, 8), (8, 2), the circular one at
JAX's four cases, weight-shared blocks, dropout and a generic stage body.
The layers are ``SelfAttention``s on JAX's weights (``state_dict_from_flax``
of each layer's ``init``), and each output is held against JAX's
sequential apply of the same layers at rtol 2e-4 / atol 2e-5, gradients at
JAX's atol 1e-3.  The layouts of ``stack_layer_params`` are held against
JAX's own stacking, and the refusals against its messages.  The hop, the
gradient plumbing and the Policy route run over gloo ranks in
``test_torch_pipeline_*.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu.core.attention import SelfAttention as JaxSelfAttention
from perceiverio_pytorch_tpu.parallel import pipeline as jax_pipeline
from perceiverio_pytorch_tpu_torch import Policy
from perceiverio_pytorch_tpu_torch.core.attention import SelfAttention
from perceiverio_pytorch_tpu_torch.parallel import pipeline as pp
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
B, N, D = 8, 16, 32
N_LAYERS = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stack():
    """JAX's layer and per-layer params, the latents, and JAX's sequential
    outputs (one and two passes) and gradients of sum(out ** 2)."""
    layer = JaxSelfAttention(in_channels=D, num_heads=4, widening_factor=1)
    x = jnp.zeros((1, N, D), jnp.float32)
    params = {str(i): _np(jax.jit(layer.init)(jax.random.PRNGKey(i), x)["params"])
              for i in range(N_LAYERS)}
    latents = np.random.default_rng(0).standard_normal((B, N, D)).astype(np.float32)

    def seq(params, x, num_blocks=1):
        for _ in range(num_blocks):
            for i in range(N_LAYERS):
                x = layer.apply({"params": params[str(i)]}, x, deterministic=True)
        return x

    grads = jax.jit(jax.grad(lambda p: jnp.sum(seq(p, latents) ** 2)))(params)
    return dict(layer=layer, params=params, latents=latents,
                want=np.asarray(jax.jit(seq)(params, latents)),
                want2=np.asarray(jax.jit(lambda p, x: seq(p, x, 2))(params, latents)),
                grads=_np(grads))


def _layers(params, **kwargs):
    layers = []
    for i in range(len(params)):
        layer = SelfAttention(in_channels=D, num_heads=4, widening_factor=1, **kwargs)
        layer.load_state_dict(state_dict_from_flax({"params": params[str(i)]}), strict=True)
        layers.append(layer)
    return layers


def _by_layer(layers):
    return {str(i): dict(layer.named_parameters()) for i, layer in enumerate(layers)}


def _run(stack, n_stages, num_microbatches, circ_repeats=1, num_blocks=1, layers=None,
         x=None, rng=None):
    """One block through ``pipeline_layers`` (the Policy route's body),
    weight-shared blocks through ``pipeline_spmd`` with ``layer_stage_fn``."""
    layers = layers or _layers(stack["params"])
    x = torch.from_numpy(stack["latents"] if x is None else x)
    if num_blocks == 1:
        policy = Policy(pp_microbatches=num_microbatches, pp_circ_repeats=circ_repeats)
        return pp.pipeline_layers(layers, x, policy, dropout_seed=rng, stages=n_stages)
    stacked = pp.stack_layer_params(_by_layer(layers), n_stages, circ_repeats=circ_repeats)
    return pp.pipeline_spmd(
        pp.layer_stage_fn(layers[0]), stacked, x, n_stages,
        num_microbatches=num_microbatches, circ_repeats=circ_repeats, num_blocks=num_blocks,
        rng=rng)


@pytest.mark.parametrize("n_stages,num_microbatches", [(4, 4), (2, 8), (8, 2), (8, 8)])
def test_pipeline_matches_sequential(stack, n_stages, num_microbatches):
    with torch.no_grad():
        got = _run(stack, n_stages, num_microbatches)
    np.testing.assert_allclose(got.numpy(), stack["want"], **TOL)


def test_pipeline_weight_shared_blocks(stack):
    """num_blocks > 1 re-enters the schedule with the same weights."""
    with torch.no_grad():
        got = _run(stack, 4, 4, num_blocks=2)
    np.testing.assert_allclose(got.numpy(), stack["want2"], **TOL)


@pytest.mark.parametrize("n_stages,circ,num_mb", [(8, 1, 2), (4, 2, 4)])
def test_pipeline_gradients_match_sequential(stack, n_stages, circ, num_mb):
    """Gradients of every layer through the schedule (S = 8 GPipe and the
    circular one; the local hop passes them back as it is)."""
    layers = _layers(stack["params"])
    out = _run(stack, n_stages, num_mb, circ_repeats=circ, layers=layers)
    (out ** 2).sum().backward()
    for i, layer in enumerate(layers):
        want = state_dict_from_flax({"params": stack["grads"][str(i)]})
        for name, p in layer.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-4,
                                       atol=1e-3, err_msg=f"{i}.{name}")


def test_schedule_computes_no_bubble():
    """A stage body runs once per (microbatch, repeat, stage): the bubble's
    ticks hand on what arrived and compute nothing; the tick counts are
    JAX's (M + S - 1, v * M + S - 1)."""
    for n_stages, circ, num_mb in ((4, 1, 3), (8, 1, 6), (4, 2, 6), (2, 4, 2)):
        calls = []

        def stage_fn(local, h):
            calls.append(h.shape[0])
            return h + local.sum()

        w = torch.ones((n_stages, circ, 1) if circ > 1 else (n_stages, 1))
        with torch.no_grad():
            out = pp.pipeline_spmd(stage_fn, w, torch.zeros(6, 2), n_stages,
                                   num_microbatches=num_mb, circ_repeats=circ)
        assert len(calls) == n_stages * circ * num_mb
        assert pp._Schedule(n_stages, num_mb, circ).n_ticks == circ * num_mb + n_stages - 1
        np.testing.assert_array_equal(out.numpy(), np.full((6, 2), n_stages * circ))


def test_stack_unstack_roundtrip(stack):
    """GPipe layout [S, per, ...] slice by slice equal to JAX's stacking of
    the same layers, and back."""
    layers = _layers(stack["params"])
    by_layer = _by_layer(layers)
    stacked = pp.stack_layer_params(by_layer, 4)
    want = jax_pipeline.stack_layer_params(stack["params"], 4)
    for s in range(4):
        for j in range(2):
            ref = state_dict_from_flax({"params": jax.tree_util.tree_map(
                lambda a: np.asarray(a[s, j]), want)})
            for name, value in stacked.items():
                np.testing.assert_array_equal(value[s, j].detach().numpy(), ref[name].numpy())
    back = pp.unstack_layer_params(stacked)
    assert set(back) == set(by_layer)
    for i, tree in back.items():
        for name, value in tree.items():
            assert torch.equal(value, by_layer[i][name]), (i, name)


def test_circular_stack_unstack_roundtrip(stack):
    layers = _layers(stack["params"])
    by_layer = _by_layer(layers)
    stacked = pp.stack_layer_params(by_layer, 2, circ_repeats=2)
    assert next(iter(stacked.values())).shape[:3] == (2, 2, 2)  # [stages, repeats, per]
    want = jax_pipeline.stack_layer_params(stack["params"], 2, circ_repeats=2)
    for s in range(2):
        for g in range(2):
            for j in range(2):
                ref = state_dict_from_flax({"params": jax.tree_util.tree_map(
                    lambda a: np.asarray(a[s, g, j]), want)})
                for name, value in stacked.items():
                    np.testing.assert_array_equal(value[s, g, j].detach().numpy(),
                                                  ref[name].numpy())
    for back in (pp.unstack_layer_params_circular(stacked),
                 pp.unstack_layer_params(stacked, circ_repeats=2)):
        assert sorted(back) == sorted(by_layer)
        for i, tree in back.items():
            for name, value in tree.items():
                assert torch.equal(value, by_layer[i][name]), (i, name)


def test_pipeline_from_encoder_params(stack):
    """The port encoder's ``self_attends`` children, loaded from JAX's
    encoder tree, run through a standalone SelfAttention."""
    from perceiverio_pytorch_tpu.core.perceiver import PerceiverEncoder as JaxEncoder
    from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverEncoder

    kw = dict(num_input_channels=D, num_self_attends_per_block=4, num_blocks=1,
              num_latents=N, num_latent_channels=D, num_self_attend_heads=4,
              num_cross_attend_heads=1)
    tokens = np.random.default_rng(1).standard_normal((B, 10, D)).astype(np.float32)
    variables = _np(jax.jit(JaxEncoder(**kw).init)(
        jax.random.PRNGKey(0), tokens, jnp.zeros((B, N, D), jnp.float32)))
    layer_params = variables["params"]["self_attends"]
    jlayer = stack["layer"]
    want = stack["latents"]
    for i in range(4):
        want = jlayer.apply({"params": layer_params[str(i)]}, want, deterministic=True)
    enc = PerceiverEncoder(**kw, generator=torch.Generator().manual_seed(0))
    # JAX's encoder makes no latent position table when given the latents
    missing, unexpected = enc.load_state_dict(state_dict_from_flax(variables), strict=False)
    assert (missing, unexpected) == (["latent_pos_enc.pos_embs"], [])
    layer_sd = {str(i): dict(layer.named_parameters()) for i, layer in
                enumerate(enc.self_attends)}
    template = SelfAttention(in_channels=D, num_heads=4, widening_factor=1)
    with torch.no_grad():
        got = pp.pipeline_spmd(pp.layer_stage_fn(template),
                               pp.stack_layer_params(layer_sd, 4),
                               torch.from_numpy(stack["latents"]), 4, num_microbatches=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_stages,circ,num_mb", [(4, 2, 4), (2, 2, 4), (2, 4, 2), (4, 2, 8)])
def test_circular_pipeline_matches_sequential(stack, n_stages, circ, num_mb):
    """Round-robin layer groups, v ring cycles a microbatch, stage 0's
    recirculation slots: the sequential stack's outputs."""
    with torch.no_grad():
        got = _run(stack, n_stages, num_mb, circ_repeats=circ)
    np.testing.assert_allclose(got.numpy(), stack["want"], **TOL)


def test_circular_pipeline_dropout_reproducible(stack):
    dropped = [layer.train() for layer in _layers(stack["params"], dropout_prob=0.3)]

    def run(seed):
        with torch.no_grad():
            return _run(stack, 4, 4, circ_repeats=2, layers=dropped, rng=seed).numpy()

    a1, a2, b = run(1), run(1), run(2)
    with torch.no_grad():
        det = _run(stack, 4, 4, circ_repeats=2).numpy()
    np.testing.assert_array_equal(a1, a2)
    assert not np.allclose(a1, b)
    assert not np.allclose(a1, det)
    assert np.all(np.isfinite(a1))


def test_circular_pipeline_rejects_short_ring(stack):
    """A parked microbatch re-enters stage 0 exactly M ticks after leaving
    it; M < S would need it before it arrives."""
    with pytest.raises(ValueError, match="circular") as got:
        _run(stack, 4, 2, circ_repeats=2)
    with pytest.raises(ValueError) as want:
        jax_pipeline.pipelined_self_attends(
            stack["layer"], stack["params"], stack["latents"],
            jax_pipeline.make_pipeline_mesh(4), num_microbatches=2, circ_repeats=2)
    assert str(got.value) == str(want.value)


def test_pipeline_rejects_bad_partitions(stack):
    layers = _layers(stack["params"])
    with pytest.raises(ValueError, match="stages") as got:
        pp.stack_layer_params(_by_layer(layers), 3)
    with pytest.raises(ValueError) as want:
        jax_pipeline.stack_layer_params(stack["params"], 3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="microbatches"):
        _run(stack, 4, 3)
    with pytest.raises(ValueError, match="circ_repeats must be >= 1"):
        pp.stack_layer_params(_by_layer(layers), 4, circ_repeats=0)
    with pytest.raises(ValueError, match="expects the"):
        pp.pipelined_self_attends(layers[0], pp.stack_layer_params(_by_layer(layers), 2),
                                  torch.zeros(B, N, D), object(), num_microbatches=4,
                                  stacked=True, circ_repeats=2)


def test_pipeline_dropout_masks_independent_per_microbatch(stack):
    """Two equal rows in different microbatches draw different masks (the
    tick's seed); without dropout they map alike."""
    row = np.random.default_rng(9).standard_normal((1, N, D))
    x = np.tile(row, (B, 1, 1)).astype(np.float32)
    with torch.no_grad():
        det = _run(stack, 4, 4, x=x).numpy()
    np.testing.assert_allclose(det[0], det[-1], rtol=1e-6, atol=1e-6)
    dropped = [layer.train() for layer in _layers(stack["params"], dropout_prob=0.4)]
    with torch.no_grad():
        got = _run(stack, 4, 4, layers=dropped, x=x, rng=0).numpy()
    assert not np.allclose(got[0], got[-1])  # microbatches 0 and 3
    assert np.all(np.isfinite(got))


def test_generic_pipeline_spmd_stage_fn():
    """Any shape-preserving stage body: tanh(h @ w) per local layer."""
    w = np.random.default_rng(2).standard_normal((4, 1, D, D)).astype(np.float32)
    x = np.random.default_rng(3).standard_normal((B, D)).astype(np.float32)
    want = jnp.asarray(x)
    for i in range(4):
        want = jnp.tanh(want @ w[i, 0])

    def stage_fn(local_w, h):
        for wi in local_w:
            h = torch.tanh(h @ wi)
        return h

    with torch.no_grad():
        got = pp.pipeline_spmd(stage_fn, torch.from_numpy(w), torch.from_numpy(x), 4,
                               num_microbatches=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
