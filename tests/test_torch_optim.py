"""The port's optimizer chain against optax, update by update.

Each case feeds the same gradients (made with numpy) to the JAX package's
``build_optimizer`` (optax) and to the port's, over several steps of a small
parameter set, and holds the parameters after every step at rtol 1e-5,
atol 1e-7 (``test_adamw_with_clip_matches_optax``'s tolerance, which
Adafactor's factored rsqrt meets too): Adafactor
with and without weight decay (a factored, an unfactored and a 1-D leaf),
Lion, SGD with momentum; the weight-decay mask as None, "non_1d", a
callable and a mapping; accumulation over 2 and 3 micro-steps with the
clip; skipping non-finite gradients alone and composed with accumulation;
the trainable mask with the clip.  The counts the optimizer keeps go
through its ``state_dict``.
"""

import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu.training import build_optimizer as jax_build_optimizer
from perceiverio_pytorch_tpu.training.optim import (
    non_1d_weight_decay_mask as jax_non_1d_mask,
)
from perceiverio_pytorch_tpu_torch.training import build_optimizer
from perceiverio_pytorch_tpu_torch.training.optim import non_1d_weight_decay_mask

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {"w": (4, 3), "b": (3,), "big": (128, 136)}  # "big" is factored by Adafactor
STEPS = 6


def _problem(seed, shapes=SHAPES, steps=STEPS, scales=None):
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    scales = scales or [0.05, 3.0, 0.2, 10.0, 0.01, 1.0, 0.5, 2.0, 0.3][:steps]
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in init.items()} for s in scales]
    return init, grads


def _run_jax(kw, init, grads, lr):
    tx = jax_build_optimizer(lr, **kw)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _module(init):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()})


def _run_port(kw, init, grads, lr, module=None):
    spec = build_optimizer(lr, **kw)
    module = module if module is not None else _module(init)
    opt = spec.create(module)
    out = []
    for g in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        spec.update(opt)
        out.append({k: p.detach().numpy().copy() for k, p in module.items()})
    return out, opt


def _compare(got, want, tol=TOL):
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{k} after step {step}", **tol)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adafactor_matches_optax(weight_decay, schedule):
    """Factored (128 x 136) and unfactored (4 x 3, and 1-D) leaves; the
    weight decay added after the learning rate's scale."""
    init, grads = _problem(0)
    kw = dict(optimizer="adafactor", weight_decay=weight_decay, schedule=schedule,
              total_steps=STEPS, warmup_steps=2 if schedule == "cosine" else 0)
    want = _run_jax(kw, init, grads, 1e-2)
    got, opt = _run_port(kw, init, grads, 1e-2)
    _compare(got, want)
    state = {k: opt.state[p] for k, p in zip(SHAPES, opt.param_groups[0]["params"])}
    big = next(s for s in opt.state.values() if "v_row" in s)
    assert big["v_row"].shape == (128,) and big["v_col"].shape == (136,)  # optax's
    assert sum("v" in s for s in state.values()) == 2  # w and b: unfactored


def test_adafactor_factors_as_optax():
    """The two largest dims, numpy's tie-break, the 128 threshold."""
    from perceiverio_pytorch_tpu_torch.training.optim import _adafactor_dims
    from optax._src.factorized import _factored_dims

    for shape in [(128, 128), (200, 130, 3), (3, 256, 128), (127, 500), (512,), (4, 3),
                  (129, 129, 129)]:
        assert _adafactor_dims(shape) == _factored_dims(shape, True, 128), shape


@pytest.mark.parametrize("mask", [None, "non_1d", "callable", "mapping"])
@pytest.mark.parametrize("optimizer", ["adamw", "lion"])
def test_weight_decay_masks_match_optax(optimizer, mask):
    """None, "non_1d", a callable of the params (JAX) / the module (port)
    and a mapping by parameter name (the same names on both sides)."""
    init, grads = _problem(1)
    chosen = {"w": False, "b": True, "big": True}
    jax_mask = port_mask = mask
    if mask == "callable":
        jax_mask, port_mask = (lambda params: dict(chosen)), (lambda module: dict(chosen))
    elif mask == "mapping":
        jax_mask = port_mask = dict(chosen)
    kw = dict(optimizer=optimizer, weight_decay=0.3, b2=0.99 if optimizer == "lion" else 0.999)
    want = _run_jax(dict(kw, weight_decay_mask=jax_mask), init, grads, 3e-3)
    got, _ = _run_port(dict(kw, weight_decay_mask=port_mask), init, grads, 3e-3)
    _compare(got, want)


def test_non_1d_weight_decay_mask_matches_jax():
    init, _ = _problem(2)
    want = jax_non_1d_mask({k: jnp.asarray(v) for k, v in init.items()})
    assert non_1d_weight_decay_mask(_module(init)) == {k: bool(v) for k, v in want.items()}


@pytest.mark.parametrize("momentum", [0.9, 0.0, None])
def test_sgd_matches_optax(momentum):
    init, grads = _problem(3)
    kw = dict(optimizer="sgd", momentum=momentum, weight_decay=0.5, clip_norm=2.0)
    _compare(_run_port(kw, init, grads, 0.05)[0], _run_jax(kw, init, grads, 0.05))


def test_lion_matches_optax():
    """The JAX package's own b2 (0.999) and a warmup+linear schedule."""
    init, grads = _problem(4)
    kw = dict(optimizer="lion", schedule="linear", total_steps=STEPS, warmup_steps=1,
              weight_decay=0.1)
    _compare(_run_port(kw, init, grads, 1e-3)[0], _run_jax(kw, init, grads, 1e-3))


@pytest.mark.parametrize("accum_steps", [2, 3])
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_accumulation_with_clip_matches_optax(accum_steps, optimizer):
    """The running mean over the window, the clip on the mean, the schedule
    advancing once a window; between windows the parameters stay put."""
    init, grads = _problem(5, steps=9)
    kw = dict(optimizer=optimizer, accum_steps=accum_steps, clip_norm=1.0,
              schedule="cosine", total_steps=3, warmup_steps=1, weight_decay=0.1)
    want = _run_jax(kw, init, grads, 1e-2)
    got, opt = _run_port(kw, init, grads, 1e-2)
    _compare(got, want)
    for step in range(len(got) - 1):
        if (step + 1) % accum_steps:  # step + 1 closes no window
            for k in init:
                prev = got[step - 1][k] if step else init[k]
                np.testing.assert_array_equal(got[step][k], prev)
    assert opt.chain["count"] == 9 // accum_steps
    assert opt.chain["mini_step"] == 9 % accum_steps


def _nan_grads(grads, steps):
    out = []
    for i, g in enumerate(grads):
        g = {k: v.copy() for k, v in g.items()}
        if i in steps:
            g["b"][1] = np.nan
        out.append(g)
    return out


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_skip_nonfinite_matches_optax(accum_steps):
    """NaNs at chosen steps: a lone one dropped (parameters, moments and
    counts untouched), three in a row with a limit of 2 applied, alone and
    composed with accumulation."""
    init, grads = _problem(6, steps=9)
    grads = _nan_grads(grads, {1, 4, 5, 6})
    kw = dict(skip_nonfinite_updates=2, accum_steps=accum_steps, clip_norm=5.0)
    want = _run_jax(kw, init, grads[:6], 1e-2)
    got, opt = _run_port(kw, init, grads[:6], 1e-2)
    _compare(got, want)
    np.testing.assert_array_equal(got[1]["w"], got[0]["w"])  # dropped
    assert opt.chain["notfinite_count"] == 2 and opt.chain["total_notfinite"] == 3
    assert opt.chain["last_finite"] is False
    # The third NaN in a row is applied: the parameters go non-finite, as in optax.
    want = _run_jax(kw, init, grads[:7], 1e-2)
    got, opt = _run_port(kw, init, grads[:7], 1e-2)
    if accum_steps == 1:
        assert not np.isfinite(want[-1]["b"]).all() and not np.isfinite(got[-1]["b"]).all()
    assert opt.chain["notfinite_count"] == 3


def test_skipped_update_leaves_the_state_bit_for_bit():
    """A skipped update changes no parameter, moment or count; an empty
    parameter (the MLM's [1, 0] padding embedding) has no max and is left
    out of the finiteness check."""
    init, grads = _problem(7)
    init["empty"] = np.zeros((1, 0), np.float32)
    grads = [dict(g, empty=np.zeros((1, 0), np.float32)) for g in grads]
    spec = build_optimizer(1e-2, skip_nonfinite_updates=1, optimizer="adafactor")
    module = _module(init)
    opt = spec.create(module)
    for g in grads[:2]:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        spec.update(opt)
    before = opt.state_dict()
    moments = {i: {k: v.clone() for k, v in s.items()} for i, s in before["state"].items()}
    params = {k: p.detach().clone() for k, p in module.items()}
    for k, p in module.items():
        p.grad = torch.full_like(p, math.inf if k == "w" else 0.0)
    spec.update(opt)
    after = opt.state_dict()
    for i, s in after["state"].items():
        for k, v in s.items():
            assert torch.equal(v, moments[i][k]), (i, k)
    for k, p in module.items():
        assert torch.equal(p.detach(), params[k]), k
    assert after["chain"]["count"] == before["chain"]["count"] == 2
    assert after["chain"]["notfinite_count"] == 1


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_trainable_mask_with_clip_matches_optax(optimizer):
    """Frozen leaves: no update, no state, outside the clip's norm (the clip
    binds on the trainable ones only)."""
    init, grads = _problem(8)
    trainable = {"w": True, "b": False, "big": True}
    kw = dict(optimizer=optimizer, clip_norm=0.5, weight_decay=0.05)
    want = _run_jax(dict(kw, trainable_mask=dict(trainable)), init, grads, 1e-2)
    module = _module(init)
    got, opt = _run_port(dict(kw, trainable_mask=lambda m: dict(trainable)), init, grads,
                         1e-2, module)
    _compare(got, want)
    np.testing.assert_array_equal(got[-1]["b"], init["b"])
    assert module["b"] not in opt.state
    frozen = [g for g in opt.param_groups if not g["trainable"]]
    assert [p is module["b"] for g in frozen for p in g["params"]] == [True]


def test_masks_need_names_and_entries():
    init, _ = _problem(9)
    spec = build_optimizer(1e-3, trainable_mask={"w": True})
    with pytest.raises(ValueError, match="no entry"):
        spec.create(_module(init))
    with pytest.raises(ValueError, match="names"):
        spec.create(_module(init).values())
    named = build_optimizer(1e-3, weight_decay_mask={"w": True, "b": False, "big": False})
    assert named.create(_module(init).named_parameters()).param_groups[0]["decay"]
    with pytest.raises(ValueError, match="module"):
        build_optimizer(1e-3, trainable_mask=lambda m: {}).create(
            _module(init).named_parameters())


def test_optimizer_state_dict_round_trip_mid_window():
    """The counts and the running mean travel with the state_dict: a chain
    restored in the middle of a window ends it as the uninterrupted one."""
    init, grads = _problem(10, steps=5)
    kw = dict(accum_steps=3, skip_nonfinite_updates=2, optimizer="lion")
    want, _ = _run_port(kw, init, grads, 1e-2)
    spec = build_optimizer(1e-2, **kw)
    module = _module(init)
    opt = spec.create(module)
    for g in grads[:4]:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        spec.update(opt)
    saved = opt.state_dict()
    assert saved["chain"]["mini_step"] == 1 and saved["chain"]["count"] == 1
    other = _module({k: v + 1.0 for k, v in init.items()})
    with torch.no_grad():
        for k, p in other.items():
            p.copy_(module[k])
    opt2 = spec.create(other)
    with pytest.raises(ValueError, match="chain"):
        opt2.load_state_dict({k: v for k, v in saved.items() if k != "chain"})
    opt2.load_state_dict(saved)
    for k, p in other.items():
        p.grad = torch.from_numpy(grads[4][k].copy())
    spec.update(opt2)
    for k, p in other.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[4][k])
    assert opt2.chain == dict(saved["chain"], mini_step=2)


def test_accumulator_covers_the_trainable_parameters_only():
    """optax.MultiSteps wraps the trainable mask, so its accumulator spans
    every leaf, the frozen ones too; the port keeps a running mean for the
    trainable ones only, which changes no update (frozen ones get none)."""
    init, grads = _problem(11, steps=3)
    kw = dict(accum_steps=2, trainable_mask={"w": True, "b": False, "big": False})
    tx = jax_build_optimizer(1e-2, **kw)
    state = tx.init({k: jnp.asarray(v) for k, v in init.items()})
    assert len(jax.tree_util.tree_leaves(state.acc_grads)) == 3
    module = _module(init)
    got, opt = _run_port(kw, init, grads, 1e-2, module)
    _compare(got, _run_jax(kw, init, grads, 1e-2))
    assert list(opt.state) == [module["w"]]
    assert sorted(opt.state[module["w"]]) == ["acc", "mu", "nu"]
