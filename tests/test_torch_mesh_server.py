"""The mesh server (``parallel.serve_on_mesh``) on 2 gloo ranks, against
the single-process model and the JAX package's apply (JAX
``tests/test_serving_server.py:288-326``).

The tiny pixel classifier on the JAX weights (``state_dict_from_flax``)
behind ``BatchingServer(max_batch=16, batch_sizes=(8, 16), pipeline=True)``
over ``make_data_parallel_apply`` on a (2, 1) mesh: rank 0 serves 12
single-image requests, each batch broadcast to rank 1, which runs the same
``fn`` on its rows until the server stops.  Each served row equals the
single-process port model's at rtol 1e-5 / atol 1e-6 and JAX's at rtol 2e-4
/ atol 2e-5; rank 1 returns from its loop once the server stops, having run
every batch rank 0 dispatched.  A warm-up of each bucket runs on both ranks
too, and a tuple example (two row arguments) goes through the header.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
WORLD = 2
CLS = dict(num_classes=5, img_size=(16, 16), num_self_attends_per_block=1, num_blocks=1,
           num_latents=8, num_latent_channels=32)


def _examples():
    rng = np.random.RandomState(0)
    return [rng.randn(3, 16, 16).astype(np.float32) for _ in range(12)]


def _model(state):
    from perceiverio_pytorch_tpu_torch import ClassificationPerceiver, PrepType

    model = ClassificationPerceiver(prep_type=PrepType.FOURIER_POS_PIXEL, **CLS, device="cpu")
    model.load_state_dict(state, strict=True)
    return model.eval()


class _Sum(torch.nn.Module):
    """Two row arguments: their sum, to carry a tuple example."""

    def forward(self, a, b):
        return a + b


def _ranks(rank, world, state):
    from perceiverio_pytorch_tpu_torch.parallel import (
        make_data_parallel_apply,
        make_mesh,
        serve_on_mesh,
    )

    mesh = make_mesh((world, 1), device="cpu")
    model = _model(state)
    calls = []
    fn, place = make_data_parallel_apply(model, mesh)

    def counted(variables, *rows):
        calls.append(rows[0].shape[0])
        return fn(variables, *rows)

    server = serve_on_mesh(counted, place(state)[0], mesh, max_batch=16, batch_sizes=(8, 16),
                           max_wait_ms=5.0, pipeline=True)
    out = dict(calls=calls)
    if server is not None:
        try:
            server.warmup(_examples()[0])
            futures = [server.submit(x) for x in _examples()]
            out["rows"] = np.stack([f.result(timeout=60).numpy() for f in futures])
            out["stats"] = server.stats()
        finally:
            server.stop()
    pair_fn, pair_place = make_data_parallel_apply(_Sum(), mesh)
    server = serve_on_mesh(pair_fn, pair_place({})[0], mesh, max_batch=8, batch_sizes=(8,))
    if server is not None:
        a, b = np.ones(3, np.float32), np.arange(3, dtype=np.float32)
        try:
            out["pair"] = server((a, b)).numpy()
        finally:
            server.stop()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu.models import ClassificationPerceiver, PrepType
    from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

    jm = ClassificationPerceiver(prep_type=PrepType.FOURIER_POS_PIXEL, **CLS)
    batch = jnp.asarray(np.stack(_examples()))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), batch[:8])
    jax_rows = np.asarray(jax.jit(jm.apply)(variables, batch))
    state = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        port_rows = _model(state)(torch.from_numpy(np.stack(_examples()))).numpy()
    ranks = run_ranks(_ranks, WORLD, tmp_path_factory.mktemp("mesh_server"), state)
    return dict(jax=jax_rows, port=port_rows), ranks


def test_served_rows_match_the_single_process_model(results):
    want, ranks = results
    rows = ranks[0]["rows"]
    assert rows.shape == (12, 5)
    np.testing.assert_allclose(rows, want["port"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rows, want["jax"], rtol=2e-4, atol=2e-5)


def test_followers_run_every_batch_and_stop_with_the_server(results):
    """Both ranks ran the same batches (each its half of the rows): the two
    warm-up buckets, then the dispatched ones; rank 1's loop returned."""
    _, ranks = results
    stats = ranks[0]["stats"]
    assert stats["requests_served"] == 12 and stats["errors"] == 0
    assert len(ranks[0]["calls"]) == 2 + stats["batches_dispatched"]
    assert ranks[1]["calls"] == ranks[0]["calls"]
    assert ranks[0]["calls"][:2] == [4, 8]  # buckets 8 and 16 over 2 data ranks
    assert "rows" not in ranks[1]


def test_tuple_examples_cross_the_header(results):
    _, ranks = results
    np.testing.assert_array_equal(ranks[0]["pair"],
                                  np.ones(3, np.float32) + np.arange(3, dtype=np.float32))
