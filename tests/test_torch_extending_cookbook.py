"""docs/EXTENDING.md Parts 1 and 2 through the port's public API.

The cookbook's custom modality, an IMU-style sensor stream [B, T, 6], is
written once as a torch module (the port's preprocessor protocol:
``forward(inputs, *, pos=None) -> (with_pos, without_pos)`` and
``n_output_channels()``) and wired as the guide wires its flax twin
(``tests/test_extending_cookbook.py``): alone through ``PerceiverIO``
(Part 1), then beside a label modality with masking, padding and
per-modality queries and postprocessors (Part 2).  No port module changes
for it.  The JAX forward on the same inputs, with its variables carried
across by ``state_dict_from_flax``, is the oracle; then the port's
``Trainer`` takes five steps of Part 1 and lowers the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import perceiverio_pytorch_tpu as jax_pkg
import perceiverio_pytorch_tpu_torch as port
from perceiverio_pytorch_tpu_torch.io_processors import (
    ClassificationPostprocessor,
    OneHotPreprocessor,
    ProjectionPostprocessor,
)
from perceiverio_pytorch_tpu_torch.training import Trainer, build_optimizer
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax
from test_extending_cookbook import SensorPreprocessor as JaxSensorPreprocessor

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


class SensorPreprocessor(torch.nn.Module):
    """The cookbook's sensor modality: a linear projection of the raw
    channels, concatenated with Fourier features of the time axis."""

    def __init__(self, num_timesteps: int, raw_channels: int = 6, num_channels: int = 32,
                 num_bands: int = 8):
        super().__init__()
        self.num_channels, self.num_bands = num_channels, num_bands
        self.project = torch.nn.Linear(raw_channels, num_channels)
        self.position_enc = port.build_position_encoding(
            port.PosEncodingType.FOURIER,
            index_dims=(num_timesteps,),
            fourier_position_encoding_kwargs=dict(
                num_bands=num_bands, max_resolution=(num_timesteps,), sine_only=False,
                concat_pos=True),
        )

    def n_output_channels(self) -> int:
        # projection + fourier features (2*bands + 1 raw pos per dim)
        return self.num_channels + 2 * self.num_bands + 1

    def forward(self, inputs, *, pos=None):
        features = self.project(inputs)
        pos_enc = self.position_enc(inputs.shape[0], pos=pos)
        return torch.cat([features, pos_enc.to(features.dtype)], dim=-1), features


def _part1(T, pkg, sensor):
    return pkg.PerceiverIO(
        num_blocks=1, num_self_attends_per_block=2, num_latents=16, num_latent_channels=64,
        input_preprocessors=sensor(num_timesteps=T),
        output_queries=pkg.FourierQuery(output_index_dims=(T,), num_bands=8,
                                        max_resolution=(T,)),
        final_project_out_channels=64,
        output_postprocessors=_projection(pkg, 64, 3),
    )


def _projection(pkg, num_inputs, num_outputs):
    if pkg is port:
        return ProjectionPostprocessor(num_inputs=num_inputs, num_outputs=num_outputs)
    from perceiverio_pytorch_tpu.io_processors import ProjectionPostprocessor as JaxProjection

    return JaxProjection(num_inputs=num_inputs, num_outputs=num_outputs)


def _carried(jax_model, port_model, *init_args, **init_kw):
    variables = jax.jit(lambda k, *a: jax_model.init(k, *a, **init_kw))(
        jax.random.PRNGKey(0), *init_args)
    port_model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return variables


def test_part1_sensor_regression_matches_jax_and_trains():
    T = 64
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, T, 6)).astype(np.float32)
    y = rng.standard_normal((2, T, 3)).astype(np.float32)
    jax_model = _part1(T, jax_pkg, JaxSensorPreprocessor)
    model = _part1(T, port, SensorPreprocessor)
    variables = _carried(jax_model, model, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (2, T, 3)
    np.testing.assert_allclose(got, want, **TOL)

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def loss_fn(m, x, y):
        return torch.mean((m(x) - y) ** 2)

    trainer = Trainer(loss_fn, build_optimizer(1e-3), log_every=0)
    state = trainer.init_state(model)
    with torch.no_grad():
        l0 = float(loss_fn(model, xt, yt))
    state = trainer.fit(state, iter([(xt, yt)] * 5), num_steps=5)
    with torch.no_grad():
        l1 = float(loss_fn(state.model, xt, yt))
    assert state.step == 5 and l1 < l0


def _part2(T, n_classes, pkg, sensor):
    if pkg is port:
        onehot, classify = OneHotPreprocessor, ClassificationPostprocessor
    else:
        from perceiverio_pytorch_tpu.io_processors import ClassificationPostprocessor as classify
        from perceiverio_pytorch_tpu.io_processors import OneHotPreprocessor as onehot
    return pkg.PerceiverIO(
        num_blocks=1, num_self_attends_per_block=2, num_latents=16, num_latent_channels=64,
        input_preprocessors={"sensor": sensor(num_timesteps=T),
                             "label": onehot(input_channels=n_classes)},
        input_mask_probs={"sensor": 0.0, "label": 1.0},
        input_padding_channels=2,
        output_queries={
            "sensor": pkg.FourierQuery(output_index_dims=(T,), num_bands=8,
                                       max_resolution=(T,)),
            "label": pkg.TrainableQuery(output_index_dims=(1,), num_channels=32),
        },
        output_query_padding_channels=2,
        final_project_out_channels=64,
        output_postprocessors={
            "sensor": _projection(pkg, 64, 6),
            "label": classify(num_classes=n_classes, num_input_channels=64),
        },
    )


def test_part2_sensor_plus_label_matches_jax():
    T, n_classes = 32, 10
    rng = np.random.default_rng(1)
    sensor = rng.standard_normal((2, T, 6)).astype(np.float32)
    label = np.eye(n_classes, dtype=np.float32)[[3, 7]]
    jax_model = _part2(T, n_classes, jax_pkg, JaxSensorPreprocessor)
    model = _part2(T, n_classes, port, SensorPreprocessor)
    batch = {"sensor": jnp.asarray(sensor), "label": jnp.asarray(label)}
    variables = _carried(jax_model, model, batch, deterministic=False)
    want = jax.jit(jax_model.apply)(variables, batch)
    with torch.no_grad():
        got = model({"sensor": torch.from_numpy(sensor), "label": torch.from_numpy(label)})
    assert set(got) == set(want) == {"sensor", "label"}
    assert tuple(got["sensor"].shape) == (2, T, 6)
    assert tuple(got["label"].shape) == (2, n_classes)
    for key in ("sensor", "label"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)

