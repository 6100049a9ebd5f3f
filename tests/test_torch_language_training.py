"""The port's byte-MLM training path against the JAX package's.

``masked_token_cross_entropy`` with a mask, without one and with an empty
one; the tiny language model's loss and every parameter's gradient under it
against ``jax.grad`` of the JAX model on the same weights (carried by
``state_dict_from_flax`` with the language overrides and the tie), on the
dense path and through the plain K1/K2/K3 (Pallas in interpreter mode in
JAX), the tied table's two uses summed into one parameter; the replay of
``tests/goldens/language_grads.npz``; the tied table as one fp32 parameter
of the optimizer in fp32 and in bf16; and the example's synthetic corpus and
tiny configuration.  Inputs are made with numpy.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import language as jax_lang
from perceiverio_pytorch_tpu.training import masked_token_cross_entropy as jax_mlm_loss
from perceiverio_pytorch_tpu.utils.data import epoch_batches as jax_epoch_batches
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.examples import train_mlm
from perceiverio_pytorch_tpu_torch.models import language as port_lang
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.training import (
    TrainState,
    build_optimizer,
    make_train_step,
    masked_token_cross_entropy,
)
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    state_dict_from_flax,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
GOLDEN = os.path.join(ROOT, "tests", "goldens", "language_grads.npz")
# The golden configuration (tests/make_goldens.py `language_grads`).
SMALL = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=2,
             num_blocks=1, num_latents=8, num_latent_channels=64)
EMBED = "perceiver._multi_preprocessor._preprocessors.__default.embed.weight"
DECODE = "perceiver._output_postprocessors.__default._embedding.weight"


@pytest.mark.parametrize("mask", ["partial", "none", "empty"])
def test_masked_token_cross_entropy_matches_jax(mask):
    """The mean over the masked positions (all without a mask); an empty
    mask divides by 1 and gives 0."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 262), dtype=np.float32) * 3
    targets = rng.integers(0, 262, (2, 9)).astype(np.int32)
    loss_mask = {"partial": rng.random((2, 9)) < 0.3, "none": None,
                 "empty": np.zeros((2, 9), bool)}[mask]
    want = float(jax_mlm_loss(jnp.asarray(logits), jnp.asarray(targets),
                              None if loss_mask is None else jnp.asarray(loss_mask)))
    got = masked_token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                     None if loss_mask is None else torch.from_numpy(loss_mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    if mask == "empty":
        assert got.item() == 0.0
    # bf16 logits: the port takes the cross-entropy in fp32.
    low = masked_token_cross_entropy(torch.from_numpy(logits).bfloat16(),
                                     torch.from_numpy(targets),
                                     None if loss_mask is None else torch.from_numpy(loss_mask))
    assert low.dtype == torch.float32


def _mlm_batch(seed):
    """Token ids [2, 32], an input mask with right padding on the second row,
    target ids and the loss mask."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 262, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), bool)
    mask[1, 25:] = False
    targets = rng.integers(6, 262, (2, 32)).astype(np.int32)
    loss_mask = (rng.random((2, 32)) < 0.4) & mask
    return tokens, mask, targets, loss_mask


def _jax_variables(jm, tokens, mask, seed):
    """The JAX init's params, every 1-D one moved by seeded noise, so that
    LayerNorm scales and biases and every bias show."""
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), tokens, mask)
    rng = np.random.default_rng(seed)

    def perturb(x):
        x = np.asarray(x)
        return x if x.ndim != 1 else x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)

    return {**variables, "params": jax.tree_util.tree_map(perturb, variables["params"])}


def _policies(impl):
    if impl == "dense":
        return jax_config.PARITY, port_config.PARITY
    return (jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash", interpret=True),
            dataclasses.replace(port_config.PARITY, attn_impl="flash"))


def _port_model(variables, policy):
    model = port_lang.LanguagePerceiver(**SMALL, policy=policy, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, overrides=LANGUAGE_OVERRIDES,
                                               tied=LANGUAGE_TIED), strict=True)
    return model


def _assert_grads(model, want):
    """Every parameter's gradient against ``want`` (a state_dict of
    gradients, the tied table under both names); atol scales with a
    gradient's max above 1."""
    names = dict(model.named_parameters())
    assert set(want) - set(names) == {DECODE} and set(names) <= set(want)
    for name, param in names.items():
        grad = (torch.zeros_like(param) if param.grad is None else param.grad).numpy()
        ref = np.asarray(want[name])
        peak = max(1.0, float(np.abs(ref).max(initial=0.0)))
        np.testing.assert_allclose(grad, ref, err_msg=name, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * peak)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_language_gradients_match_jax(impl):
    """The masked-token loss and every parameter's gradient against jax.grad
    of the JAX model on the same weights, with an input mask (padding) and a
    loss mask: on the dense path, and through the plain K1, K2 and K3 (the
    Pallas kernels in interpreter mode).  The tied table is one parameter
    whose gradient sums its two uses, the embedding and the decode."""
    jax_pol, port_pol = _policies(impl)
    tokens, mask, targets, loss_mask = _mlm_batch(1)
    jm = jax_lang.LanguagePerceiver(policy=jax_pol, **SMALL)
    variables = _jax_variables(jm, tokens, mask, seed=2)

    def loss(params):
        logits = jm.apply({**variables, "params": params}, tokens, mask)
        return jax_mlm_loss(logits, targets, loss_mask)

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = state_dict_from_flax({"params": grads}, overrides=LANGUAGE_OVERRIDES,
                                tied=LANGUAGE_TIED)
    model = _port_model(variables, port_pol)
    model.train()
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    got_loss = masked_token_cross_entropy(
        model(torch.from_numpy(tokens), torch.from_numpy(mask)),
        torch.from_numpy(targets), torch.from_numpy(loss_mask))
    got_loss.backward()
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    _assert_grads(model, want)
    assert model.get_parameter(EMBED).grad.abs().max() > 0


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_language_gradient_golden_replay(impl):
    """tests/goldens/language_grads.npz (MSE of the logits against a random
    target, the reference's tied table accumulating both uses): the weights
    load strictly, the loss and every gradient replay, on the dense path and
    through the plain K1/K2/K3."""
    z = np.load(GOLDEN)
    kwargs = json.loads(bytes(z["meta"]).decode())["kwargs"]
    assert kwargs == SMALL
    sd = {k[4:]: torch.from_numpy(z[k].astype(np.float32))
          for k in z.files if k.startswith("sd::")}
    want = {k[6:]: z[k] for k in z.files if k.startswith("grad::")}
    np.testing.assert_array_equal(want[EMBED], want[DECODE])  # one tensor, two names
    model = port_lang.LanguagePerceiver(**kwargs, policy=_policies(impl)[1], device="cpu")
    model.load_state_dict(sd, strict=True)
    model.train()
    logits = model(torch.from_numpy(z["in::tokens"]), torch.from_numpy(z["in::mask"]))
    loss = ((logits - torch.from_numpy(z["in::target"])) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(z["out::loss"]), rtol=1e-5)
    _assert_grads(model, want)


@pytest.mark.parametrize("policy", ["DEFAULT", "PERFORMANCE"])
def test_tied_table_is_one_fp32_parameter_of_the_optimizer(policy):
    """In fp32 and in bf16 (PERFORMANCE: bf16 GEMMs, the tied decode
    promoted to fp32), the optimizer holds the table once, as an fp32
    parameter with an fp32 gradient, and one step moves it."""
    model = port_lang.LanguagePerceiver(**SMALL, policy=getattr(port_config, policy),
                                        device="cpu", generator=torch.Generator().manual_seed(3))
    tx = build_optimizer(1e-3)
    opt = tx.create(model.parameters())
    step = make_train_step(train_mlm.loss_fn, tx)
    table = model.get_parameter(EMBED)
    assert table is model.perceiver._output_postprocessors["__default"]._embedding.weight
    held = [p for g in opt.param_groups for p in g["params"]]
    assert sum(p is table for p in held) == 1 and len(held) == len({id(p) for p in held})
    before = table.detach().clone()
    tokens, _, targets, loss_mask = (torch.from_numpy(x) for x in _mlm_batch(4))
    _, loss = step(TrainState(0, model, opt), tokens, targets, loss_mask)
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert table.dtype == table.grad.dtype == torch.float32
    assert (table.detach() - before).abs().max() > 0


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_mlm", os.path.join(ROOT, "examples", "train_mlm.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_corpus_matches_jax_example():
    jax_example = _jax_example()
    for args, kw in (((1024, 256, 262), {}), ((16, 2048, 262), dict(seed=1)),
                     ((5, 33, 100), dict(seed=7))):
        want = jax_example.synthetic_corpus(*args, **kw)
        got = train_mlm.synthetic_corpus(*args, **kw)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_train_mlm_example_tiny_on_cpu(tmp_path):
    """Three steps of the tiny configuration: finite losses, an evaluation
    line after every step (eval_every = max(3 // 2, 1)), the evaluation
    batches in the JAX example's order (epoch_batches, seed 0), and no
    kernel launch."""
    path = tmp_path / "mlm_metrics.jsonl"
    trainer, state, batches, eval_batches = train_mlm.setup(3, device="cpu",
                                                            metrics_path=str(path))
    held_out = train_mlm.synthetic_corpus(16, 256, 262, seed=1)
    want = list(jax_epoch_batches(held_out, 8))
    assert len(eval_batches) == len(want) == 2
    for got_batch, want_batch in zip(eval_batches, want):
        for x, y in zip(got_batch, want_batch):
            np.testing.assert_array_equal(x.numpy(), y)
    launches = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    state = trainer.fit(state, batches, num_steps=3, eval_batches=eval_batches)
    assert state.step == 3
    with open(path) as f:
        logged = [json.loads(line) for line in f]
    evals = [x for x in logged if "eval_loss" in x]
    losses = [x for x in logged if "loss" in x]
    assert [x["step"] for x in evals] == [1, 2, 3]
    assert [x["step"] for x in losses] == [3]
    assert all(np.isfinite(x["eval_loss"]) for x in evals)
    assert all(np.isfinite(x["loss"]) for x in losses)
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == launches


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_train_mlm_example_defaults_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mlm.main(steps=1, metrics_path=str(tmp_path / "m.jsonl"))
