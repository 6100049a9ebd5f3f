"""The port's flow training path against the JAX package's.

Gradients of the tiny flow model through the flash path (the plain
versions of K1, K2 and K3 on the CPU, the Pallas kernels in interpreter mode
in JAX), with remat on and off; the schedule and AdamW with its clip against
optax; the batch order; three Trainer steps; the Trainer's evaluation
against the JAX Trainer's and a hand loop; and the example's tiny
configuration.
"""

import importlib.util
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import flow as jax_flow
from perceiverio_pytorch_tpu.training import Trainer as JaxTrainer
from perceiverio_pytorch_tpu.training import batch_iterator as jax_batch_iterator
from perceiverio_pytorch_tpu.training import build_optimizer as jax_build_optimizer
from perceiverio_pytorch_tpu.training import build_schedule as jax_build_schedule
from perceiverio_pytorch_tpu.training import flow_endpoint_error as jax_epe
from perceiverio_pytorch_tpu.utils.data import epoch_batches as jax_epoch_batches
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.examples import train_flow
from perceiverio_pytorch_tpu_torch.models import flow as port_flow
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    batch_iterator,
    build_optimizer,
    build_schedule,
    epoch_batches,
    flow_endpoint_error,
    global_norm,
    make_train_step,
)
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
             num_self_attends_per_block=2)


def _jax_variables(model, seed):
    """Initial variables with a random decoder projection (it is
    zero-initialised by design, which would hide the decoder's gradient)."""
    zeros = jnp.zeros((1, 3) + SMALL["img_size"])
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), zeros, zeros)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    final = params["perceiver"]["decoder"]["final_layer"]
    final["kernel"] = np.random.default_rng(seed).standard_normal(
        final["kernel"].shape).astype(np.float32) * 0.1
    return {**variables, "params": params}


def _flow_data(n, seed):
    rng = np.random.default_rng(seed)
    shape = (n, 3) + SMALL["img_size"]
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-2, 2, (n, 2) + SMALL["img_size"]).astype(np.float32))


@pytest.mark.parametrize("remat", [False, True])
def test_flow_gradients_through_flash_match_jax(remat):
    """Per-parameter gradients of the endpoint error, every attention site
    on the flash path: K1/K2/K3's plain versions against the Pallas kernels
    in interpreter mode under jax.grad."""
    jax_pol = jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash",
                                interpret=True)
    jm = jax_flow.FlowPerceiver(**SMALL, policy=jax_pol, remat=remat)
    variables = _jax_variables(jm, seed=0)
    img1, img2, gt = _flow_data(2, seed=1)

    def loss(params):
        out = jm.apply({**variables, "params": params}, img1, img2)
        return jax_epe(out, gt)

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = state_dict_from_flax({"params": grads})

    pm = port_flow.FlowPerceiver(
        **SMALL, remat=remat, device="cpu",
        policy=port_config.Policy(compute_dtype=torch.float32, attn_impl="flash"))
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    pm.train()
    got_loss = flow_endpoint_error(
        pm(torch.from_numpy(img1), torch.from_numpy(img2)), torch.from_numpy(gt))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    names = dict(pm.named_parameters())
    assert set(names) == set(want)
    for name, param in names.items():
        grad = (torch.zeros_like(param) if param.grad is None else param.grad).numpy()
        np.testing.assert_allclose(grad, want[name].numpy(), err_msg=name, **TOL)
    decoder = names["perceiver._decoder.decoding_cross_attn.attention.proj_q.weight"]
    assert decoder.grad.abs().max() > 0


def test_flow_endpoint_error_matches_jax():
    rng = np.random.default_rng(0)
    pred, gt = (rng.standard_normal((2, 2, 5, 7)).astype(np.float32) for _ in range(2))
    valid = rng.random((2, 5, 7)) > 0.5
    for kw in ({}, {"valid": valid}):
        want = float(jax_epe(pred, gt, **kw))
        got = flow_endpoint_error(torch.from_numpy(pred), torch.from_numpy(gt),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    zero = flow_endpoint_error(torch.from_numpy(pred), torch.from_numpy(gt),
                               valid=torch.zeros(2, 5, 7))
    assert zero.item() == 0.0


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(schedule, warmup):
    kw = dict(schedule=schedule, total_steps=10, warmup_steps=warmup, end_lr_ratio=0.1)
    want = jax_build_schedule(2e-3, **kw)
    got = build_schedule(2e-3, **kw)
    for step in range(14):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    if warmup:
        assert got(0) == 0.0


@pytest.mark.parametrize("weight_decay_mask", [None, "non_1d"])
def test_adamw_with_clip_matches_optax(weight_decay_mask):
    """Several AdamW updates with a warmup+cosine schedule and a global-norm
    clip that binds on some steps and not on others."""
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}
    scales = [0.05, 3.0, 0.2, 10.0, 0.01, 1.0]
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in init.items()} for s in scales]
    kw = dict(schedule="cosine", total_steps=len(scales), warmup_steps=2,
              weight_decay=0.1, weight_decay_mask=weight_decay_mask, clip_norm=1.0)

    tx = jax_build_optimizer(1e-2, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = tx.init(params)
    want = []
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        want.append({k: np.asarray(v) for k, v in params.items()})

    spec = build_optimizer(1e-2, **kw)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = spec.create(tparams.values())
    for step, (g, w) in enumerate(zip(grads, want)):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())  # the clip scales it in place
        norm = spec.update(opt)  # the optimizer counts its own updates
        want_norm = float(optax.global_norm(g))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} after step {step}")


def test_unported_optimizer_and_trainer_options_raise():
    """What raises: FSDP without a mesh (JAX's ValueError), an argument the
    JAX Trainer does not take.  Every optimizer option of the JAX package is
    taken; bad values are refused."""
    for kw in (dict(optimizer="lion"), dict(optimizer="adafactor"), dict(optimizer="sgd"),
               dict(accum_steps=2), dict(skip_nonfinite_updates=3),
               dict(trainable_mask=lambda m: {}), dict(weight_decay_mask={"w": True})):
        build_optimizer(1e-3, **kw)
    for kw in (dict(optimizer="adam"), dict(weight_decay_mask="all"), dict(accum_steps=0)):
        with pytest.raises(ValueError):
            build_optimizer(1e-3, **kw)
    tx = build_optimizer(1e-3)
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(lambda m: m, tx, fsdp=True)
    with pytest.raises(TypeError):
        Trainer(lambda m: m, tx, mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="log_grad_norm"):
        Trainer(lambda m: m, tx, steps_per_call=2, log_grad_norm=True)
    assert Trainer(lambda m: m, tx, steps_per_call=4).steps_per_call == 4
    # Checkpoints, prefetch, EMA and the logged lr are ported: the Trainer takes them.
    trainer = Trainer(lambda m: m, tx, checkpoint_dir="x", checkpoint_every=2,
                      checkpoint_keep=1, checkpoint_final=True, checkpoint_async=True,
                      prefetch=2, ema_decay=0.999, lr_schedule=tx.schedule)
    assert (trainer.checkpoint_dir, trainer.checkpoint_every, trainer.prefetch) == ("x", 2, 2)
    assert (trainer.ema_decay, trainer.lr_schedule) == (0.999, tx.schedule)
    # The logged lr is the applied one: a schedule other than tx's is refused.
    with pytest.raises(ValueError, match="tx.schedule"):
        Trainer(lambda m: m, tx, lr_schedule=build_schedule(1e-3))


@pytest.mark.parametrize(
    "kw",
    [dict(shuffle=True, seed=4, epochs=None, start_batch=5),
     dict(shuffle=True, seed=1, epochs=2, drop_remainder=False),
     dict(shuffle=False, epochs=1, start_batch=1)],
)
def test_batch_iterator_order_matches_jax(kw):
    arrays = (np.arange(10), np.arange(10) * 10)
    want = jax_batch_iterator(arrays, 3, **kw)
    got = batch_iterator(arrays, 3, **kw)
    for _ in range(8):
        w, g = next(want, None), next(got, None)
        if w is None:
            assert g is None
            break
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False, drop_remainder=False),
                                dict(seed=3, drop_remainder=False)])
def test_epoch_batches_match_jax(kw):
    arrays = (np.arange(11), np.arange(11) * 10)
    want = list(jax_epoch_batches(arrays, 4, **kw))
    got = list(epoch_batches(arrays, 4, **kw))
    assert len(got) == len(want) == (2 if kw.get("drop_remainder", True) else 3)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_trainer_steps_match_jax_trainer(tmp_path):
    """Three steps of the tiny flow model on the dense path, warmup+cosine
    AdamW with the clip: per-step losses and the final parameters."""
    jm = jax_flow.FlowPerceiver(**SMALL, policy=jax_config.PARITY)
    variables = _jax_variables(jm, seed=3)
    data = _flow_data(6, seed=4)
    kw = dict(schedule="cosine", total_steps=3, warmup_steps=1, clip_norm=1.0)

    def jax_loss(params, model_state, a, b, gt):
        out = jm.apply({"params": params, **model_state}, a, b)
        return jax_epe(out, gt), model_state

    jax_trainer = JaxTrainer(jax_loss, jax_build_optimizer(1e-3, **kw),
                             with_model_state=True, log_every=1,
                             metrics_path=str(tmp_path / "jax.jsonl"))
    consts = {k: v for k, v in variables.items() if k != "params"}
    state = jax_trainer.init_state(variables["params"], model_state=consts)
    state = jax_trainer.fit(
        state, lambda s: jax_batch_iterator(data, 2, shuffle=True, epochs=None,
                                            start_batch=s), num_steps=3)
    want_params = state_dict_from_flax({"params": state.params})

    pm = port_flow.FlowPerceiver(**SMALL, policy=port_config.PARITY, device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(train_flow.loss_fn, build_optimizer(1e-3, **kw), log_every=1,
                      metrics_path=str(tmp_path / "port.jsonl"))

    def batches(start):
        for batch in batch_iterator(data, 2, shuffle=True, epochs=None, start_batch=start):
            yield tuple(torch.from_numpy(a) for a in batch)

    port_state = trainer.init_state(pm)
    port_state = trainer.fit(port_state, batches, num_steps=2)
    port_state = trainer.fit(port_state, batches, num_steps=3)  # resumes the order
    assert port_state.step == 3

    def losses(name):
        with open(tmp_path / name) as f:
            return [json.loads(line)["loss"] for line in f]

    want_losses, got_losses = losses("jax.jsonl"), losses("port.jsonl")
    assert len(got_losses) == len(want_losses) == 3
    np.testing.assert_allclose(got_losses, want_losses, **TOL)
    initial = state_dict_from_flax(variables)
    moved = 0.0
    for name, param in pm.named_parameters():
        if name.endswith("proj_k.bias"):
            # Its exact gradient is 0 (softmax ignores a shift shared by a
            # row's logits): both sides hold rounding noise, which AdamW
            # scales up to steps of up to lr, with either sign.
            assert (param.detach() - initial[name]).abs().max() <= 2e-3
            continue
        np.testing.assert_allclose(param.detach().numpy(), want_params[name].numpy(),
                                   err_msg=name, **TOL)
        if param.numel():
            moved = max(moved, (param.detach() - initial[name]).abs().max().item())
    assert moved > 1e-4


def _linear_problem():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((12, 3)).astype(np.float32),
            rng.standard_normal((12, 1)).astype(np.float32),
            rng.standard_normal((3, 1)).astype(np.float32))


def _linear_model(w):
    model = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w.T))
    return model


def _mse(model, x, y):
    return ((model(x) - y) ** 2).mean()


@pytest.mark.parametrize("metrics", ["scalar", "dict"])
def test_trainer_evaluation_matches_jax_trainer(tmp_path, metrics):
    """fit with eval_fn and eval_every=2 over 5 AdamW steps of a linear
    regression, the evaluation batches a generator: the JAX Trainer's
    cadence (steps 2 and 4, each on a line of its own) and values, for a
    scalar eval_fn (logged as eval_loss) and for a dict of metrics."""
    x, y, w = _linear_problem()

    def jax_eval(params, xb, yb):
        err = xb @ params["w"] - yb
        loss = jnp.mean(err ** 2)
        return loss if metrics == "scalar" else {"eval_loss": loss,
                                                 "eval_mae": jnp.mean(jnp.abs(err))}

    def port_eval(model, xb, yb):
        err = model(xb) - yb
        loss = (err ** 2).mean()
        return loss if metrics == "scalar" else {"eval_loss": loss, "eval_mae": err.abs().mean()}

    jax_trainer = JaxTrainer(lambda p, xb, yb: jnp.mean((xb @ p["w"] - yb) ** 2),
                             jax_build_optimizer(1e-2), log_every=1, eval_fn=jax_eval,
                             eval_every=2, metrics_path=str(tmp_path / "jax.jsonl"))
    state = jax_trainer.init_state({"w": jnp.asarray(w)})
    jax_trainer.fit(state, jax_batch_iterator((x, y), 4, shuffle=True, epochs=None),
                    num_steps=5, eval_batches=jax_batch_iterator((x, y), 6, epochs=1))
    trainer = Trainer(_mse, build_optimizer(1e-2), log_every=1, eval_fn=port_eval,
                      eval_every=2, metrics_path=str(tmp_path / "port.jsonl"))
    port_state = trainer.init_state(_linear_model(w))
    held_out = (tuple(torch.from_numpy(a) for a in b)
                for b in batch_iterator((x, y), 6, epochs=1))
    trainer.fit(port_state, (tuple(torch.from_numpy(a) for a in b)
                             for b in batch_iterator((x, y), 4, shuffle=True, epochs=None)),
                num_steps=5, eval_batches=held_out)

    def evals(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f if "eval_loss" in line]

    want, got = evals("jax.jsonl"), evals("port.jsonl")
    assert [e["step"] for e in got] == [e["step"] for e in want] == [2, 4]
    for g, e in zip(got, want):
        assert set(g) == set(e) == ({"step", "eval_loss"} | (
            set() if metrics == "scalar" else {"eval_mae"}))
        for key in g:
            np.testing.assert_allclose(g[key], e[key], **TOL)


def test_trainer_evaluate_against_a_hand_loop():
    """``evaluate``: the mean of a scalar or of each metric over the
    batches, in eval mode without gradients, the model put back in the mode
    it was in; no batch gives 0.0; EMA asked of a state without it raises,
    and resuming needs a checkpoint directory."""
    x, y, w = _linear_problem()
    model = _linear_model(w)
    batches = [(torch.from_numpy(x[i:i + 4]), torch.from_numpy(y[i:i + 4]))
               for i in range(0, 12, 4)]
    seen = []

    def eval_fn(m, xb, yb):
        seen.append((m.training, torch.is_grad_enabled()))
        return {"eval_loss": _mse(m, xb, yb), "eval_max": (m(xb) - yb).abs().max()}

    trainer = Trainer(_mse, build_optimizer(1e-2), log_every=0, eval_fn=eval_fn)
    state = trainer.init_state(model)
    for training in (True, False):
        model.train(training)
        seen.clear()
        got = trainer.evaluate(state, batches)
        assert seen == [(False, False)] * 3 and model.training == training
        with torch.no_grad():
            np.testing.assert_allclose(
                got["eval_loss"], np.mean([_mse(model, *b).item() for b in batches]), rtol=1e-6)
            np.testing.assert_allclose(
                got["eval_max"],
                np.mean([(model(b[0]) - b[1]).abs().max().item() for b in batches]), rtol=1e-6)
    trainer.eval_fn = _mse
    with torch.no_grad():
        want = np.mean([_mse(model, *b).item() for b in batches])
    np.testing.assert_allclose(trainer.evaluate(state, iter(batches)), want, rtol=1e-6)
    assert trainer.evaluate(state, []) == 0.0
    with pytest.raises(ValueError, match="ema_params"):
        trainer.evaluate(state, batches, use_ema=True)
    assert Trainer(_mse, build_optimizer(1e-2), ema_decay=0.999).init_state(
        model).ema_params is not None
    with pytest.raises(ValueError, match="checkpoint_dir"):
        trainer.fit(state, batches, resume=True)  # resuming is ported; it needs a directory


def test_fit_takes_a_callable_eval_batches(tmp_path):
    """``fit(eval_batches=callable)`` calls it before each evaluation and
    logs the same ``eval_loss`` lines as with the list of its batches, and
    as the JAX Trainer given the same callable."""
    x, y, w = _linear_problem()
    held_out = [(x[i:i + 6], y[i:i + 6]) for i in (0, 6)]
    calls = []

    def port_batches():
        calls.append(1)
        return [tuple(torch.from_numpy(a) for a in b) for b in held_out]

    def fit(name, eval_batches):
        trainer = Trainer(_mse, build_optimizer(1e-2), log_every=0, eval_fn=_mse, eval_every=2,
                          metrics_path=str(tmp_path / name))
        trainer.fit(trainer.init_state(_linear_model(w)),
                    (tuple(torch.from_numpy(a) for a in b)
                     for b in batch_iterator((x, y), 4, shuffle=True, epochs=None)),
                    num_steps=5, eval_batches=eval_batches)

    fit("list.jsonl", port_batches())
    calls.clear()
    fit("callable.jsonl", port_batches)
    assert len(calls) == 2  # once before each evaluation (steps 2 and 4)
    jax_trainer = JaxTrainer(lambda p, xb, yb: jnp.mean((xb @ p["w"] - yb) ** 2),
                             jax_build_optimizer(1e-2), log_every=0,
                             eval_fn=lambda p, xb, yb: jnp.mean((xb @ p["w"] - yb) ** 2),
                             eval_every=2, metrics_path=str(tmp_path / "jax.jsonl"))
    jax_trainer.fit(jax_trainer.init_state({"w": jnp.asarray(w)}),
                    jax_batch_iterator((x, y), 4, shuffle=True, epochs=None), num_steps=5,
                    eval_batches=lambda: list(held_out))

    def evals(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f if "eval_loss" in line]

    got, listed, want = evals("callable.jsonl"), evals("list.jsonl"), evals("jax.jsonl")
    assert got == listed
    assert [e["step"] for e in got] == [e["step"] for e in want] == [2, 4]
    np.testing.assert_allclose([e["eval_loss"] for e in got], [e["eval_loss"] for e in want],
                               **TOL)


def test_trainer_ema_and_lr_match_jax_trainer(tmp_path):
    """``Trainer(ema_decay, lr_schedule)`` against the JAX Trainer over five
    AdamW steps (warmup and cosine) of a linear regression: the live and the
    EMA parameters, ``evaluate`` on the EMA by default and on the live
    parameters when asked, and the logged ``lr`` of every step."""
    x, y, w = _linear_problem()
    kw = dict(schedule="cosine", total_steps=5, warmup_steps=2)

    def jax_loss(p, xb, yb):
        return jnp.mean((xb @ p["w"] - yb) ** 2)

    jax_trainer = JaxTrainer(jax_loss, jax_build_optimizer(1e-1, **kw), log_every=1,
                             eval_fn=jax_loss, ema_decay=0.8,
                             lr_schedule=jax_build_schedule(1e-1, **kw),
                             metrics_path=str(tmp_path / "jax.jsonl"))
    jax_state = jax_trainer.fit(jax_trainer.init_state({"w": jnp.asarray(w)}),
                                jax_batch_iterator((x, y), 4, shuffle=True, epochs=None),
                                num_steps=5)
    tx = build_optimizer(1e-1, **kw)
    trainer = Trainer(_mse, tx, log_every=1, eval_fn=_mse, ema_decay=0.8,
                      lr_schedule=tx.schedule, metrics_path=str(tmp_path / "port.jsonl"))
    model = _linear_model(w)
    state = trainer.init_state(model)
    assert set(state.ema_params) == {"weight"}
    assert state.ema_params["weight"] is not model.weight
    state = trainer.fit(state, (tuple(torch.from_numpy(a) for a in b)
                                for b in batch_iterator((x, y), 4, shuffle=True, epochs=None)),
                        num_steps=5)
    np.testing.assert_allclose(model.weight.detach().numpy(),
                               np.asarray(jax_state.params["w"]).T, **TOL)
    ema = state.ema_params["weight"].numpy()
    np.testing.assert_allclose(ema, np.asarray(jax_state.ema_params["w"]).T, **TOL)
    assert np.abs(ema - model.weight.detach().numpy()).max() > 1e-3
    held_out = [(x, y)]
    port_held_out = [(torch.from_numpy(x), torch.from_numpy(y))]
    for use_ema in (None, True, False):
        np.testing.assert_allclose(
            trainer.evaluate(state, port_held_out, use_ema=use_ema),
            jax_trainer.evaluate(jax_state, held_out, use_ema=use_ema), **TOL)
    assert trainer.evaluate(state, port_held_out) != trainer.evaluate(
        state, port_held_out, use_ema=False)
    live = model.weight.detach().clone()
    trainer.evaluate(state, port_held_out)
    assert torch.equal(model.weight.detach(), live)  # the live weights are back

    def lines(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    got, want = lines("port.jsonl"), lines("jax.jsonl")
    assert [g["step"] for g in got] == [e["step"] for e in want] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([g["lr"] for g in got], [e["lr"] for e in want],
                               rtol=1e-6, atol=1e-9)
    assert got[0]["lr"] == 0.0 and got[2]["lr"] == tx.schedule(2)


def test_utils_data_shim_matches_jax():
    """``utils.data``: the JAX package's module path, the same names; its
    one-epoch ``epoch_batches`` gives the JAX shim's batches."""
    from perceiverio_pytorch_tpu.utils import data as jax_data
    from perceiverio_pytorch_tpu_torch.training import data as port_training_data
    from perceiverio_pytorch_tpu_torch.utils import data as port_data

    assert set(port_data.__all__) == {"batch_iterator", "epoch_batches", "prefetch_to_device"}
    assert port_data.prefetch_to_device is port_training_data.prefetch_to_device
    arrays = (np.arange(13), np.arange(13) * 10)
    for kw in (dict(), dict(seed=5, shuffle=True, drop_remainder=False)):
        got = list(port_data.epoch_batches(arrays, 4, **kw))
        want = list(jax_data.epoch_batches(arrays, 4, **kw))
        assert len(got) == len(want) > 0
        for g, e in zip(got, want):
            for a, b in zip(g, e):
                np.testing.assert_array_equal(a, b)


def test_train_step_metrics_and_buffers():
    """with_metrics gives the pre-clip gradient norm and the parameter norm;
    the Fourier tables are buffers (built at their first use) with no
    optimizer state."""
    model = port_flow.FlowPerceiver(**SMALL, device="cpu")
    trainer = Trainer(train_flow.loss_fn, build_optimizer(1e-3, clip_norm=0.01),
                      log_every=0, log_grad_norm=True)
    state = trainer.init_state(model)
    optimized = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert optimized == {id(p) for p in model.parameters()}
    step = make_train_step(train_flow.loss_fn, trainer.tx, with_metrics=True)
    img1, img2, gt = (torch.from_numpy(a) for a in _flow_data(2, seed=5))
    state, metrics = step(state, img1, img2, gt)
    assert all(id(b) not in optimized for b in model.buffers())
    assert any("fourier" in name for name, _ in model.named_buffers())
    assert state.step == 1 and set(metrics) == {"loss", "grad_norm", "param_norm"}
    params = [p for p in model.parameters()]
    # the logged norm is the one before the clip; the gradients were clipped
    assert metrics["grad_norm"].item() > 0.01
    np.testing.assert_allclose(global_norm([p.grad for p in params]).item(), 0.01,
                               rtol=1e-5)
    np.testing.assert_allclose(
        metrics["param_norm"].item(),
        float(torch.sqrt(sum((p.detach() ** 2).sum() for p in params))), rtol=1e-5)


def test_train_flow_example_tiny_on_cpu(tmp_path):
    path = tmp_path / "flow_metrics.jsonl"
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    state = train_flow.main(steps=3, device="cpu", metrics_path=str(path))
    assert state.step == 3
    with open(path) as f:
        logged = [json.loads(line) for line in f]
    assert logged[-1]["step"] == 3 and np.isfinite(logged[-1]["loss"])
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before


def test_synthetic_flow_pairs_match_jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_flow", os.path.join(ROOT, "examples", "train_flow.py"))
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    for n, hw in ((16, (32, 48)), (3, (10, 13))):
        want = jax_example.synthetic_flow_pairs(n, hw)
        got = train_flow.synthetic_flow_pairs(n, hw)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_train_flow_example_defaults_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_flow.main(steps=1, metrics_path=str(tmp_path / "m.jsonl"))
