"""``MultiModalPerceiver(chunk_mesh=...)`` on a 2-rank data axis (a (2, 1)
mesh over gloo), against the JAX model's sequential decode and the port's.

One spawned group (``test_torch_parallel.run_ranks``) runs the golden
configuration (16x16 frames, 2 of them, 11 classes, 8 latents x 512) on the
JAX weights (``state_dict_from_flax``, 1-D parameters moved off 1 and 0),
8 chunks decoded in 4 waves of 2:

  * the fp32 dense model and the query-pad fold, every rank's output against
    JAX's sequential decode at rtol 2e-4 / atol 2e-5 (JAX
    ``tests/test_sharding_training.py:801``, ``tests/test_fold_query_pad.py:82``)
    and against the port's own sequential decode at the JAX test's rtol
    1e-5 / atol 1e-6;
  * the gradient of every parameter of one loss, with and without remat,
    against the port's sequential decode at rtol 1e-4 / atol 1e-5: each rank
    decodes half the chunks, so the decoder's and the latents' gradients
    are summed over the axis;
  * ``int8_static`` calibration ignores the mesh (every chunk is decoded on
    every rank: the same ``amax`` as without), and static inference over
    the mesh equals it without;
  * the refusals: an ``n_chunks`` the data axis does not divide (JAX :801's
    ValueError) and one the query counts do not divide (JAX :967).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
SAME = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
WORLD = 2
N_CHUNKS = 8
SMALL = dict(img_size=(16, 16), num_frames=2, num_classes=11, audio_samples_per_frame=128,
             audio_samples_per_patch=16, num_self_attends_per_block=1, num_blocks=1,
             num_latents=8, num_latent_channels=512)


def _clip():
    rng = np.random.default_rng(4)
    images = rng.random((1, 2, 3, 16, 16), dtype=np.float32)
    audio = rng.uniform(-1, 1, (1, 256, 1)).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(audio)


def _model(state, remat=False, **policy):
    import dataclasses

    from perceiverio_pytorch_tpu_torch import PARITY, MultiModalPerceiver

    model = MultiModalPerceiver(**SMALL, policy=dataclasses.replace(PARITY, **policy),
                                remat=remat, device="cpu")
    # A static int8 model's amax buffers start at 0 (uncalibrated).
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all(k.endswith(".amax") for k in missing)
    assert bool(missing) == ("quant" in policy)
    return model.eval()


def _forward(model, mesh=None, n_chunks=N_CHUNKS):
    with torch.no_grad():
        out = model(*_clip(), n_chunks=n_chunks, chunk_mesh=mesh)
    return {k: v.numpy() for k, v in out.items()}


def _grads(model, mesh=None):
    model.zero_grad(set_to_none=True)
    out = model(*_clip(), n_chunks=N_CHUNKS, chunk_mesh=mesh)
    loss = sum((x ** 2).mean() for x in out.values())
    loss.backward()
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


def _calibrated(state, mesh=None):
    from perceiverio_pytorch_tpu_torch.ops import quant

    model = _model(state, quant="int8_static")
    quant.calibrate(model, [_clip()], n_chunks=N_CHUNKS, chunk_mesh=mesh)
    amax = {k: v.numpy() for k, v in model.state_dict().items() if k.endswith("amax")}
    return amax, _forward(model, mesh)


def _ranks(rank, world, state):
    from perceiverio_pytorch_tpu_torch.parallel import make_mesh

    mesh = make_mesh((world, 1), device="cpu")
    out = dict(dense=_forward(_model(state), mesh),
               fold=_forward(_model(state, fold_query_pad=True), mesh),
               grads=_grads(_model(state).train(), mesh),
               grads_remat=_grads(_model(state, remat=True).train(), mesh),
               int8_static=_calibrated(state, mesh))
    model = _model(state)
    for name, n_chunks in (("not_a_multiple", 1), ("not_a_divisor", 3)):
        try:
            _forward(model, mesh, n_chunks)
        except ValueError as exc:
            out[name] = str(exc)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from perceiverio_pytorch_tpu import config as jax_config
    from perceiverio_pytorch_tpu.models import multimodal as jax_mm
    from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

    images, audio = (x.numpy() for x in _clip())
    jm = jax_mm.MultiModalPerceiver(policy=jax_config.PARITY, **SMALL)
    variables = jax.jit(lambda k, i, a: jm.init(k, i, a, N_CHUNKS))(
        jax.random.PRNGKey(0), images, audio)
    rng = np.random.default_rng(9)  # 1-D parameters off 1 and 0
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["params"] = jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32) if x.ndim == 1
        else x, variables["params"])
    jax_out = jax.jit(lambda v, i, a: jm.apply(v, i, a, N_CHUNKS))(variables, images, audio)
    state = state_dict_from_flax(variables)
    want = dict(jax={k: np.asarray(v) for k, v in jax_out.items()},
                port=_forward(_model(state)), grads=_grads(_model(state).train()),
                int8_static=_calibrated(state))
    return want, run_ranks(_ranks, WORLD, tmp_path_factory.mktemp("chunk_mesh"), state)


@pytest.mark.parametrize("run", ["dense", "fold"])
def test_chunk_parallel_decode_matches_jax_and_the_sequential_decode(results, run):
    want, ranks = results
    for result in ranks:
        for key in ("image", "audio", "label"):
            got = result[run][key]
            np.testing.assert_allclose(got, want["jax"][key], **TOL, err_msg=f"{run} {key}")
            np.testing.assert_allclose(got, want["port"][key], **SAME, err_msg=f"{run} {key}")


@pytest.mark.parametrize("run", ["grads", "grads_remat"])
def test_chunk_parallel_gradients_equal_the_sequential_decode(results, run):
    want, ranks = results
    assert len(want["grads"]) > 40
    for result in ranks:
        assert set(result[run]) == set(want["grads"])
        for name, ref in want["grads"].items():
            np.testing.assert_allclose(result[run][name], ref, **GRAD_TOL,
                                       err_msg=f"{run} {name}")


def test_calibration_ignores_the_mesh(results):
    want, ranks = results
    amax, out = want["int8_static"]
    assert amax and all(v > 0 for v in amax.values())
    for result in ranks:
        got_amax, got_out = result["int8_static"]
        assert got_amax.keys() == amax.keys()
        for name in amax:
            np.testing.assert_array_equal(got_amax[name], amax[name], err_msg=name)
        for key in out:
            np.testing.assert_allclose(got_out[key], out[key], **SAME, err_msg=key)


def test_chunk_mesh_refusals(results):
    for result in results[1]:
        assert "must be a multiple of the mesh's data axis (2)" in result["not_a_multiple"]
        assert "must divide both the image query" in result["not_a_divisor"]
