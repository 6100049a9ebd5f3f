"""The port's LoRA (training/lora.py) against the JAX package's.

A JAX adapter tree is carried into the port's ``LoRA`` module
(``lora_state_dict_from_flax``), and the merged weights, the wrapped loss,
the adapter gradients, the selected paths, the errors, alpha's scale, a
short fit, a checkpoint round trip and the full-scale adapter count are
held against the JAX functions on a small ``LanguagePerceiver``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import language as jax_lang
from perceiverio_pytorch_tpu.training import init_lora as jax_init_lora
from perceiverio_pytorch_tpu.training import lora_paths as jax_lora_paths
from perceiverio_pytorch_tpu.training import masked_token_cross_entropy as jax_mtce
from perceiverio_pytorch_tpu.training import merge_lora as jax_merge_lora
from perceiverio_pytorch_tpu.training import wrap_loss as jax_wrap_loss
from perceiverio_pytorch_tpu.training.lora import default_match as jax_default_match
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.models import language as port_lang
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    build_optimizer,
    init_lora,
    lora_paths,
    masked_token_cross_entropy,
    merge_lora,
    restore_train_state,
    save_train_state,
    wrap_loss,
)
from perceiverio_pytorch_tpu_torch.training.lora import DEFAULT_TARGETS
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    lora_state_dict_from_flax,
    state_dict_from_flax,
    translate_path,
)

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
TINY = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=2,
            num_blocks=1, num_latents=8, num_latent_channels=64)


@pytest.fixture(scope="module")
def tiny():
    """The JAX model and its variables, the port model with the same
    weights, and a batch of tokens with an all-valid mask."""
    jm = jax_lang.LanguagePerceiver(**TINY, policy=jax_config.PARITY)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 262, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), bool)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), tokens, mask))
    pm = port_lang.LanguagePerceiver(**TINY, policy=port_config.PARITY, device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables, overrides=LANGUAGE_OVERRIDES,
                                            tied=LANGUAGE_TIED), strict=True)
    return jm, variables, pm, tokens, mask


def _jax_lora(params, rank=4, seed=1):
    """A JAX adapter tree with ``b`` drawn too, so that the delta shows."""
    lora = jax_init_lora(jax.random.PRNGKey(seed), params, rank=rank)
    leaves, tree = jax.tree_util.tree_flatten(lora)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) if x.shape[0] != rank else
              rng.normal(0.0, 0.05, x.shape).astype(np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _carried(pm, jax_lora, rank=4):
    adapters = init_lora(pm.state_dict(), rank)
    adapters.load_state_dict(lora_state_dict_from_flax(jax_lora), strict=True)
    return adapters


def _port_loss(model, tokens, mask):
    return masked_token_cross_entropy(model(tokens, mask), tokens, mask)


def _torch(*arrays):
    return tuple(torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
                 for a in arrays)


def test_fresh_adapter_merges_to_identity(tiny):
    """``b`` starts at zero: the merged state_dict is the base's bit for
    bit, and so is the wrapped model's output."""
    _, _, pm, tokens, mask = tiny
    adapters = init_lora(pm.state_dict(), rank=4, generator=torch.Generator().manual_seed(3))
    base = pm.state_dict()
    merged = merge_lora(base, adapters)
    assert set(merged) == set(base)
    for k, v in base.items():
        assert torch.equal(merged[k], v), k
    t, m = _torch(tokens, mask)
    seen = []
    wrapped = wrap_loss(lambda model, *b: seen.append(model(*b)) or seen[-1].sum(), pm)
    with torch.no_grad():
        wrapped(adapters, t, m)
        assert torch.equal(seen[0], pm(t, m))


def test_default_targets_and_paths_match_jax(tiny):
    """The adapted weights are the translated JAX paths (attention and MLP
    projections only), ``a`` is [in, rank] and ``b`` [rank, out] of zeros;
    a subset of targets selects the same subset as in JAX."""
    _, variables, pm, _, _ = tiny
    adapters = init_lora(pm.state_dict(), rank=2)
    want = sorted(translate_path(tuple(p.split("/")), "params")
                  for p in jax_lora_paths(jax_init_lora(jax.random.PRNGKey(1),
                                                        variables["params"], rank=2)))
    assert lora_paths(adapters) == want and want
    weights = dict(pm.named_parameters())
    for path in want:
        assert path.rsplit(".", 2)[-2] in DEFAULT_TARGETS
        a, b = adapters.adapter(path)
        d_out, d_in = weights[path].shape
        assert a.shape == (d_in, 2) and b.shape == (2, d_out)
        assert torch.equal(b, torch.zeros_like(b))
    assert not any("embed" in p for p in want)
    q_only = init_lora(pm.state_dict(), rank=2, targets=("proj_q",))
    jax_q = jax_init_lora(jax.random.PRNGKey(1), variables["params"], rank=2,
                          targets=("proj_q",))
    assert lora_paths(q_only) == sorted(translate_path(tuple(p.split("/")), "params")
                                        for p in jax_lora_paths(jax_q))


def test_no_match_and_foreign_paths_raise(tiny):
    _, variables, pm, _, _ = tiny
    with pytest.raises(ValueError, match="matched no kernels"):
        init_lora(pm.state_dict(), rank=2, targets=("nonexistent_module",))
    with pytest.raises(ValueError, match="matched no kernels"):
        jax_init_lora(jax.random.PRNGKey(1), variables["params"], rank=2,
                      targets=("nonexistent_module",))
    adapters = init_lora(pm.state_dict(), rank=2)
    embed = {k: v for k, v in pm.state_dict().items() if "embed" in k}
    with pytest.raises(ValueError, match="absent from params"):
        merge_lora(embed, adapters)
    with pytest.raises(ValueError, match="absent from params"):
        jax_merge_lora({"embed_only": variables["params"]["embed"]},
                       jax_init_lora(jax.random.PRNGKey(1), variables["params"], rank=2))
    with pytest.raises(ValueError, match="rank"):
        init_lora(pm.state_dict(), rank=0)


def test_merged_weights_loss_and_adapter_grads_match_jax(tiny):
    """The same adapters in both: the merged weights (flax [in, out] ->
    torch [out, in]), the wrapped loss and the gradient of every a and b."""
    jm, variables, pm, tokens, mask = tiny
    jlora = _jax_lora(variables["params"])
    adapters = _carried(pm, jlora)
    want = state_dict_from_flax({"params": jax_merge_lora(variables["params"], jlora)},
                                overrides=LANGUAGE_OVERRIDES, tied=LANGUAGE_TIED)
    got = merge_lora(pm.state_dict(), adapters)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **TOL)
    base = pm.state_dict()
    assert min((got[k] - base[k]).abs().max().item() for k in lora_paths(adapters)) > 1e-4

    def jax_loss(p, t, m):
        return jax_mtce(jm.apply({"params": p}, t, m), t, m)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_wrap_loss(jax_loss, variables[
        "params"])))(jlora, tokens, mask)
    loss = wrap_loss(_port_loss, pm)(adapters, *_torch(tokens, mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    want_grads = lora_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_grads))
    params = dict(adapters.named_parameters())
    assert set(params) == set(want_grads)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), err_msg=k, **TOL)
    assert all(p.grad is None for p in pm.parameters())


def test_alpha_scales_delta_linearly(tiny):
    """alpha = 2 * rank doubles the delta of the default (alpha = rank), as
    in JAX."""
    _, variables, pm, _, _ = tiny
    jlora = _jax_lora(variables["params"])
    adapters = _carried(pm, jlora)
    base = pm.state_dict()
    m1, m2 = merge_lora(base, adapters, alpha=4.0), merge_lora(base, adapters, alpha=8.0)
    want = state_dict_from_flax(
        {"params": jax_merge_lora(variables["params"], jlora, alpha=8.0)},
        overrides=LANGUAGE_OVERRIDES, tied=LANGUAGE_TIED)
    for k in lora_paths(adapters):
        np.testing.assert_allclose(2.0 * (m1[k] - base[k]).numpy(), (m2[k] - base[k]).numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(m2[k].numpy(), want[k].numpy(), err_msg=k, **TOL)


def test_lora_training_learns_and_freezes_base(tiny):
    """The Trainer over the adapters: the loss falls, the optimizer holds
    the adapters only, the base weights stay bit for bit, the merge loads
    strictly into a fresh model and moves its output; the JAX run over the
    same batch learns too."""
    jm, variables, pm, tokens, mask = tiny
    batch = _torch(tokens, mask)
    base_copy = {k: v.clone() for k, v in pm.state_dict().items()}
    adapters = init_lora(pm.state_dict(), rank=4)
    loss = wrap_loss(_port_loss, pm)
    trainer = Trainer(loss, build_optimizer(1e-2), log_every=0, eval_fn=loss)
    state = trainer.init_state(adapters)
    opt_params = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert opt_params == {id(p) for p in adapters.parameters()}
    loss0 = trainer.evaluate(state, [batch])
    state = trainer.fit(state, [batch] * 8, num_steps=8)
    loss1 = trainer.evaluate(state, [batch])
    assert loss1 < loss0
    for k, v in pm.state_dict().items():
        assert torch.equal(v, base_copy[k]), k
    fresh = port_lang.LanguagePerceiver(**TINY, policy=port_config.PARITY, device="cpu",
                                        generator=torch.Generator().manual_seed(5))
    fresh.load_state_dict(merge_lora(pm.state_dict(), state.model), strict=True)
    with torch.no_grad():
        out_merged, out_base = fresh(*batch), pm(*batch)
        np.testing.assert_allclose(_port_loss(fresh.eval(), *batch).item(), loss1, **TOL)
    assert (out_merged - out_base).abs().max().item() > 0
    n_base = sum(p.numel() for p in pm.parameters())
    n_lora = sum(p.numel() for p in adapters.parameters())
    assert n_lora < n_base / 5

    def jax_loss(p, t, m):
        return jax_mtce(jm.apply({"params": p}, t, m), t, m)

    from perceiverio_pytorch_tpu.training import Trainer as JaxTrainer
    from perceiverio_pytorch_tpu.training import build_optimizer as jax_build_optimizer

    lifted = jax_wrap_loss(jax_loss, variables["params"])
    jlora = jax_init_lora(jax.random.PRNGKey(1), variables["params"], rank=4)
    jax_loss0 = float(jax.jit(lifted)(jlora, tokens, mask))  # the step donates jlora
    jax_trainer = JaxTrainer(lifted, jax_build_optimizer(1e-2), log_every=0)
    jax_state = jax_trainer.fit(jax_trainer.init_state(jlora),
                                iter([(tokens, mask)] * 8), num_steps=8)
    assert float(jax.jit(lifted)(jax_state.params, tokens, mask)) < jax_loss0


def test_lora_state_checkpoint_roundtrip(tiny, tmp_path):
    _, _, pm, tokens, mask = tiny
    batch = _torch(tokens, mask)
    trainer = Trainer(wrap_loss(_port_loss, pm), build_optimizer(1e-2), log_every=0)
    state = trainer.fit(trainer.init_state(init_lora(pm.state_dict(), rank=4)),
                        [batch] * 2, num_steps=2)
    save_train_state(str(tmp_path / "ck"), state)
    other = trainer.init_state(init_lora(pm.state_dict(), rank=4,
                                         generator=torch.Generator().manual_seed(9)))
    restored = restore_train_state(str(tmp_path / "ck"), other)
    assert restored.step == 2
    for (k, a), (k2, b) in zip(state.model.state_dict().items(),
                               restored.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_full_scale_adapter_count_matches_jax():
    """The published MLM: the port's adapters (built on the meta device)
    cover the translated paths JAX's default_match selects in the shapes of
    ``jax.eval_shape`` of its init, with sum(rank * (in + out)) parameters."""
    jm = jax_lang.LanguagePerceiver()
    tokens = jax.ShapeDtypeStruct((1, 2048), jnp.int32)
    mask = jax.ShapeDtypeStruct((1, 2048), jnp.bool_)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), tokens, mask)["params"]
    rank, want, count = 8, [], 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = tuple(str(getattr(k, "key", k)) for k in path)
        if jax_default_match(names, leaf):
            want.append(translate_path(names, "params"))
            count += rank * (leaf.shape[0] + leaf.shape[1])
    with torch.device("meta"):
        pm = port_lang.LanguagePerceiver(device="meta")
    adapters = init_lora(pm.state_dict(), rank=rank)
    assert lora_paths(adapters) == sorted(want)
    assert sum(p.numel() for p in adapters.parameters()) == count == 2940928
