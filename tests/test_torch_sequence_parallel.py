"""Sequence-parallel attention, ``Policy(sp_mesh)`` and
``PerceiverIO(input_token_sharding)`` of the port on 4 gloo ranks, against
the JAX package (``tests/test_sharding_training.py``).

One spawned group of 4 (``test_torch_parallel.run_ranks``) runs every case
on a (1, 4) mesh, the keys split 4 ways (the JAX tests split them 4 or 8
ways), and the input-sharded model on a (2, 2) one (JAX: (2, 4)); each
rank returns its results, and each test holds every rank's against the JAX
oracle computed here, from the same numpy inputs, at rtol 2e-4 / atol 2e-5:

  * ``sequence_parallel_attention`` on both routes against ``attend_xla``,
    masked and not, at 64 keys, at 62 and 61 (padded to the axis with
    masked keys), at the multimodal and flow token counts (53,187 and
    182,528), all-masked rows exactly 0, and the gradients of q, k and v
    (JAX :416, :448, :490, :546, :844, ``TestRingFlash`` :606-:684); the
    "flash" route runs the plain K1/K2/K3 on these CPU tensors;
  * a ``PerceiverIO`` under ``Policy(sp_mesh, sp_min_kv=32)`` on both
    routes and under ``input_token_sharding`` against the JAX model on the
    same weights (``state_dict_from_flax``; JAX :269, :462, :567, :686);
  * ``sp_route``'s choice (JAX :868) and the refusals, in this process.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
WORLD = 4
MODEL = dict(num_blocks=1, num_self_attends_per_block=1, num_latents=4, num_latent_channels=32,
             final_project=True, final_project_out_channels=8, input_channels=16)
QUERY = dict(output_index_dims=3, num_channels=16)


def _cases():
    """name -> (route, q, k, v, kv_mask): the attention cases."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 16, 2, 32).astype(np.float32), rng.randn(2, 64, 2, 32).astype(
        np.float32), rng.randn(2, 64, 2, 32).astype(np.float32))
    mask = rng.rand(2, 64) > 0.3
    p = np.random.RandomState(3)
    pq, pk, pv = (p.randn(2, 8, 2, 16).astype(np.float32),
                  p.randn(2, 62, 2, 16).astype(np.float32),
                  p.randn(2, 62, 2, 16).astype(np.float32))
    pmask = p.rand(2, 62) > 0.3
    r = np.random.RandomState(8)
    rq, rk, rv = (r.randn(1, 8, 2, 16).astype(np.float32), r.randn(1, 61, 2, 16).astype(
        np.float32), r.randn(1, 61, 2, 16).astype(np.float32))
    z = np.random.RandomState(1)
    zq, zk, zv = (z.randn(1, 8, 1, 32).astype(np.float32), z.randn(1, 32, 1, 32).astype(
        np.float32), z.randn(1, 32, 1, 32).astype(np.float32))
    out = {}
    for route in ("dense", "flash"):
        out[f"{route}_masked"] = (route, q, k, v, mask)
        out[f"{route}_unmasked"] = (route, q, k, v, None)
        out[f"{route}_pad62_masked"] = (route, pq, pk, pv, pmask)
        out[f"{route}_pad62"] = (route, pq, pk, pv, None)
        out[f"{route}_pad61"] = (route, rq, rk, rv, None)
        out[f"{route}_all_masked"] = (route, zq, zk, zv, np.zeros((1, 32), bool))
    for tk in (53187, 182528):
        t = np.random.RandomState(4)
        out[f"dense_tokens{tk}"] = ("dense", t.randn(1, 8, 1, 32).astype(np.float32),
                                    t.randn(1, tk, 1, 32).astype(np.float32),
                                    t.randn(1, tk, 1, 32).astype(np.float32), None)
    return out


# Cases whose gradients of sum(out ** 2) in q, k and v are held too.
GRAD_CASES = ("dense_pad62", "flash_masked", "dense_unmasked", "flash_pad61")


def _model_inputs():
    x = np.random.RandomState(0).randn(2, 64, 16).astype(np.float32)
    mask = np.random.RandomState(1).rand(2, 64) > 0.2
    x61 = np.random.RandomState(5).randn(2, 61, 16).astype(np.float32)
    mask61 = np.random.RandomState(6).rand(2, 61) > 0.2
    x_in = np.random.RandomState(0).randn(4, 64, 16).astype(np.float32)
    return dict(sp_dense=(x, mask), sp_dense_61=(x61, mask61), sp_flash_61=(x61, mask61),
                input_sharded=(x_in, None))


def _ranks(rank, world, cases, variables):
    """Every case on this rank; returns {name: numpy result}."""
    from perceiverio_pytorch_tpu_torch import PerceiverIO, Policy, TrainableQuery
    from perceiverio_pytorch_tpu_torch.parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        NamedSharding,
        batch_sharding,
        make_mesh,
        sequence_parallel_attention,
    )
    from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
    from perceiverio_pytorch_tpu_torch.parallel.mesh import axis
    from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

    mesh = make_mesh((1, world), device="cpu")
    out = {}
    for name, (route, q, k, v, mask) in cases.items():
        q, k, v = (torch.from_numpy(a).requires_grad_(name in GRAD_CASES) for a in (q, k, v))
        kv_mask = None if mask is None else torch.from_numpy(mask)
        got = sequence_parallel_attention(q, k, v, mesh, kv_mask=kv_mask, impl=route)
        out[name] = got.detach().numpy()
        if name in GRAD_CASES:
            (got ** 2).sum().backward()
            out[name + "_grads"] = [t.grad.numpy() for t in (q, k, v)]

    state = state_dict_from_flax(variables)
    inputs = _model_inputs()
    for name, impl in (("sp_dense", "dense"), ("sp_dense_61", "dense"),
                       ("sp_flash_61", "flash")):
        policy = Policy(sp_mesh=mesh, sp_min_kv=32, sp_impl=impl)
        model = PerceiverIO(**MODEL, output_queries=TrainableQuery(**QUERY), policy=policy)
        model.load_state_dict(state, strict=True)
        x, mask = inputs[name]
        with torch.no_grad():
            out[name] = model(torch.from_numpy(x), input_mask=torch.from_numpy(mask)).numpy()
    grid = make_mesh((2, world // 2), device="cpu")
    model = PerceiverIO(**MODEL, output_queries=TrainableQuery(**QUERY),
                        input_token_sharding=NamedSharding(grid, (DATA_AXIS, MODEL_AXIS)))
    model.load_state_dict(state, strict=True)
    x, _ = inputs["input_sharded"]
    with torch.no_grad():
        rows = model(batch_sharding(grid).piece(x))
        out["input_sharded"] = cc.all_gather_dim(rows, 0, axis(grid, DATA_AXIS).group).numpy()
    return out


@pytest.fixture(scope="module")
def oracle():
    """JAX's results on every case, and the JAX model's weights."""
    import jax
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu import PerceiverIO, TrainableQuery
    from perceiverio_pytorch_tpu.ops.attention_xla import attend_xla

    want = {}
    grads = {name.split("_", 1)[1] for name in GRAD_CASES}
    for name, (_, q, k, v, mask) in _cases().items():
        key = name.split("_", 1)[1]
        if key in want:
            continue

        def attend(q, k, v, mask=mask):
            m = None if mask is None else jnp.asarray(mask)[:, None, :] & jnp.ones(
                (q.shape[0], q.shape[1], 1), bool)
            return attend_xla(q, k, v, attention_mask=m)

        want[key] = np.asarray(jax.jit(attend)(q, k, v))
        if key in grads:
            want[key + "_grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
                lambda q, k, v: jnp.sum(attend(q, k, v) ** 2), argnums=(0, 1, 2)))(q, k, v)]
    model = PerceiverIO(**MODEL, output_queries=TrainableQuery(**QUERY))
    inputs = _model_inputs()
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), inputs["sp_dense"][0])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for name, (x, mask) in inputs.items():
        kw = {} if mask is None else dict(input_mask=jnp.asarray(mask))
        want[name] = np.asarray(jax.jit(lambda p, x, kw=kw: model.apply(p, x, **kw))(
            variables, jnp.asarray(x)))
    return want, variables


@pytest.fixture(scope="module")
def ranks(oracle, tmp_path_factory):
    _, variables = oracle
    return run_ranks(_ranks, WORLD, tmp_path_factory.mktemp("sp"), _cases(), variables)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_sequence_parallel_attention_matches_jax(oracle, ranks, name):
    """Both routes, every rank, against attend_xla (all-masked rows: exact
    zeros; padded token counts; the multimodal and flow key counts)."""
    want = oracle[0][name.split("_", 1)[1]]
    for result in ranks:
        got = result[name]
        assert got.shape == want.shape
        if name.endswith("all_masked"):
            assert np.all(got == 0.0)
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_sequence_parallel_gradients_match_jax(oracle, ranks, name):
    """dq (summed over the axis), dk and dv (each rank's shard, gathered
    back whole) against JAX's gradients of the same loss."""
    want = oracle[0][name.split("_", 1)[1] + "_grads"]
    for result in ranks:
        for got, ref, what in zip(result[name + "_grads"], want, "qkv"):
            np.testing.assert_allclose(got, ref, **TOL, err_msg=f"{name} d{what}")


@pytest.mark.parametrize("name", sorted(_model_inputs()))
def test_sequence_parallel_model_matches_jax(oracle, ranks, name):
    """PerceiverIO under Policy(sp_mesh) (dense and flash routes, 64 and 61
    tokens, masked) and under input_token_sharding on (2, 2): the JAX
    model's output on the same weights, on every rank."""
    want = oracle[0][name]
    for result in ranks:
        np.testing.assert_allclose(result[name], want, **TOL, err_msg=name)


def test_sp_route_is_a_pure_function_of_its_inputs():
    """"auto" takes the ring (flash) on a CUDA tensor whose local shard holds
    at least flash_min_shard keys, the dense route otherwise (a CPU tensor
    always); "flash" and "dense" are taken as asked; JAX's "xla" raises."""
    from perceiverio_pytorch_tpu_torch.parallel.sequence_parallel import sp_route

    assert sp_route("auto", local_kv=8192, on_cuda=True) == "flash"
    assert sp_route("auto", local_kv=8191, on_cuda=True) == "dense"
    assert sp_route("auto", local_kv=45632, on_cuda=False) == "dense"
    assert sp_route("auto", local_kv=16, on_cuda=True, flash_min_shard=8) == "flash"
    assert sp_route("flash", local_kv=1, on_cuda=False) == "flash"
    assert sp_route("dense", local_kv=1 << 20, on_cuda=True) == "dense"
    with pytest.raises(ValueError, match="impl must be"):
        sp_route("xla", local_kv=1, on_cuda=False)


def test_sp_dispatch_and_refusals():
    """The dispatch's "sp" path (JAX ops/attention.py:82-90), and what
    input_token_sharding refuses."""
    from perceiverio_pytorch_tpu_torch import PerceiverIO, TrainableQuery
    from perceiverio_pytorch_tpu_torch.ops.attention import attention_path
    from perceiverio_pytorch_tpu_torch.parallel import NamedSharding

    mesh = object()
    kw = dict(q_len=4, kv_len=32768, on_cuda=False, sp_mesh=mesh)
    assert attention_path("dense", **kw) == "sp"
    assert attention_path("dense", **dict(kw, kv_len=32767)) == "dense"
    assert attention_path("auto", **dict(kw, sp_min_kv=64, kv_len=64)) == "sp"
    assert attention_path("flash", **dict(kw, sp_mesh=None)) == "flash"
    assert attention_path("auto", **dict(kw, dropout_rate=0.1)) == "dense"
    assert attention_path("auto", **dict(kw, attention_mask=torch.ones(1))) == "dense"
    assert attention_path("auto", **dict(kw, return_matrix=True)) == "dense"
    base = dict(MODEL, output_queries=TrainableQuery(**QUERY))
    with pytest.raises(ValueError, match="token dim"):
        PerceiverIO(**base, input_token_sharding=NamedSharding(mesh, ("model",)))
    with pytest.raises(ValueError, match="attention dropout"):
        PerceiverIO(**base, perceiver_encoder_kwargs=dict(dropout_attn_prob=0.1),
                    input_token_sharding=NamedSharding(mesh, (None, "model")))
