"""Sharded train steps against JAX's single-device train step.

The tiny flow model, the byte MLM with unequal mask counts on the data
ranks, and the convnet classifier in train-mode BatchNorm each take 3 steps
of the flow example's optimizer (AdamW, warmup then cosine, the global-norm
clip: ``test_torch_training.py``'s Trainer case) on 3 global batches of 4
from the same
weights (``state_dict_from_flax``), under DP (2, 1), TP (1, 2) and FSDP
(2, 1) in a group of 2 processes, and DP+TP (2, 2) and FSDP+TP (2, 2) in a
group of 4 (gloo, ``test_torch_parallel.run_ranks``).  Each run's global
loss at every step and every parameter after step 3 (gathered from the
pieces, the checkpoints' gather) equal JAX's at rtol 2e-4 / atol 2e-5, and
the classifier's running averages equal JAX's batch_stats; each parameter's
local shape follows its spec and its AdamW moments have its local shape.
The one exception is ``proj_k.bias``, whose exact gradient is 0 (a shift
shared by a row's logits): both sides hold rounding noise, which AdamW
scales to steps of up to the learning rate, so it is held within 3 steps of
1e-3 of its initial value, as ``test_torch_training.py`` holds it (JAX
counterparts: ``tests/test_sharding_training.py:61``, :140).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
FLOW = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
            num_self_attends_per_block=2)
LM = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=2,
          num_latents=8, num_latent_channels=64)
CLS = dict(num_classes=7, img_size=(32, 32), num_self_attends_per_block=2, num_blocks=2,
           num_latents=8, num_latent_channels=32)
OPT = dict(schedule="cosine", total_steps=3, warmup_steps=1, clip_norm=1.0)
LR = 1e-3
GROUPS = {2: [((2, 1), False), ((1, 2), False), ((2, 1), True)],
          4: [((2, 2), False), ((2, 2), True)]}
MODELS = ("flow", "mlm", "cls")


def build_port_model(kind, state_dict, policy=None, remat=False):
    """The port model of ``kind`` on the CPU with ``state_dict`` loaded."""
    from perceiverio_pytorch_tpu_torch import (
        PARITY,
        ClassificationPerceiver,
        FlowPerceiver,
        LanguagePerceiver,
        PrepType,
    )

    policy = policy or PARITY
    if kind == "flow":
        model = FlowPerceiver(**FLOW, policy=policy, remat=remat, device="cpu")
    elif kind == "mlm":
        model = LanguagePerceiver(**LM, policy=policy, device="cpu")
    else:
        model = ClassificationPerceiver(prep_type=PrepType.FOURIER_POS_CONVNET, **CLS,
                                        policy=policy, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()},
                          strict=True)
    return model


def port_loss(kind):
    from perceiverio_pytorch_tpu_torch.examples import train_classification, train_flow
    from perceiverio_pytorch_tpu_torch.training import masked_token_cross_entropy

    if kind == "flow":
        return train_flow.loss_fn
    if kind == "mlm":
        def loss(model, tokens, mask, targets, loss_mask):
            return masked_token_cross_entropy(model(tokens, mask), targets, loss_mask)
        return loss
    return train_classification.loss_fn


def _train_rank(rank, world, cases):
    """Each case's runs on this rank: 3 sharded steps; rank 0 returns the
    losses, the gathered train state and the pieces' shapes."""
    from perceiverio_pytorch_tpu_torch.parallel import make_mesh
    from perceiverio_pytorch_tpu_torch.training import build_optimizer
    from perceiverio_pytorch_tpu_torch.training.checkpoint import _train_state_tree
    from perceiverio_pytorch_tpu_torch.training.trainer import (
        create_sharded_train_state,
        make_sharded_train_step,
    )

    out = {}
    for case in cases:
        for shape, fsdp in GROUPS[world]:
            model = build_port_model(case["kind"], case["state_dict"])
            mesh = make_mesh(shape, device="cpu")
            tx = build_optimizer(LR, **OPT)
            state = create_sharded_train_state(model, tx, mesh, fsdp=fsdp)
            step = make_sharded_train_step(port_loss(case["kind"]), tx, mesh, state)
            losses = []
            for batch in case["batches"]:
                state, loss = step(state, *batch)
                losses.append(loss.item())
            tree = _train_state_tree(state)
            local = {n: tuple(p.shape) for n, p in model.named_parameters()}
            moments = {n: {k: tuple(v.shape) for k, v in state.optimizer.state[p].items()}
                       for n, p in model.named_parameters() if p in state.optimizer.state}
            out[(case["kind"], shape, fsdp)] = dict(
                losses=losses, local=local, moments=moments,
                full={k: v.numpy() for k, v in tree["model"].items()} if rank == 0 else None)
    return out


def _flow_case():
    import jax
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu import config as jax_config
    from perceiverio_pytorch_tpu.models import flow as jax_flow
    from perceiverio_pytorch_tpu.training import flow_endpoint_error as jax_epe

    jm = jax_flow.FlowPerceiver(**FLOW, policy=jax_config.PARITY)
    zeros = jnp.zeros((1, 3) + FLOW["img_size"])
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3), zeros, zeros))
    final = variables["params"]["perceiver"]["decoder"]["final_layer"]
    # zero-initialised by design, which would hide the decoder's gradient
    final["kernel"] = np.random.default_rng(3).standard_normal(
        final["kernel"].shape).astype(np.float32) * 0.1
    rng = np.random.default_rng(4)
    hw = FLOW["img_size"]
    batches = [(rng.uniform(-1, 1, (4, 3) + hw).astype(np.float32),
                rng.uniform(-1, 1, (4, 3) + hw).astype(np.float32),
                rng.uniform(-2, 2, (4, 2) + hw).astype(np.float32)) for _ in range(3)]

    def loss(params, model_state, a, b, gt):
        return jax_epe(jm.apply({"params": params, **model_state}, a, b), gt), model_state

    return variables, batches, loss, {}


def _mlm_case():
    import jax

    from perceiverio_pytorch_tpu import config as jax_config
    from perceiverio_pytorch_tpu.models import language as jax_lang
    from perceiverio_pytorch_tpu.training import masked_token_cross_entropy as jax_mlm_loss

    jm = jax_lang.LanguagePerceiver(policy=jax_config.PARITY, **LM)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        tokens = rng.integers(0, 262, (4, 32)).astype(np.int32)
        mask = np.ones((4, 32), bool)
        mask[1, 26:] = False
        mask[3, 20:] = False
        targets = rng.integers(6, 262, (4, 32)).astype(np.int32)
        # unequal mask counts on the data ranks: ~60% of rows 0-1, ~10% of rows 2-3
        density = np.array([0.6, 0.6, 0.1, 0.1])[:, None]
        loss_mask = (rng.random((4, 32)) < density) & mask
        batches.append((tokens, mask, targets, loss_mask))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), batches[0][0], batches[0][1]))
    noise = np.random.default_rng(6)
    variables["params"] = jax.tree_util.tree_map(
        lambda x: x if x.ndim != 1 else x + 0.1 * noise.standard_normal(x.shape).astype(
            np.float32), variables["params"])

    def loss(params, model_state, tokens, mask, targets, loss_mask):
        logits = jm.apply({"params": params, **model_state}, tokens, mask)
        return jax_mlm_loss(logits, targets, loss_mask), model_state

    return variables, batches, loss, {}


def _cls_case():
    import jax
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu import config as jax_config
    from perceiverio_pytorch_tpu.models import classification as jax_cls
    from perceiverio_pytorch_tpu.training import classification_cross_entropy as jax_ce

    jm = jax_cls.ClassificationPerceiver(prep_type=jax_cls.PrepType.FOURIER_POS_CONVNET,
                                         policy=jax_config.PARITY, **CLS)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32))))
    noise = np.random.default_rng(7)
    variables["params"] = jax.tree_util.tree_map(
        lambda x: x if x.ndim != 1 else x + 0.1 * noise.standard_normal(x.shape).astype(
            np.float32), variables["params"])
    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal((4, 3, 32, 32), dtype=np.float32) * 30,
                rng.integers(0, CLS["num_classes"], 4).astype(np.int32)) for _ in range(3)]

    def loss(params, model_state, img, labels):
        logits, mutated = jm.apply({"params": params, **model_state}, img,
                                   deterministic=False, mutable=["batch_stats"])
        return jax_ce(logits, labels), {**model_state, **mutated}

    return variables, batches, loss, {}


def _jax_run(variables, batches, loss):
    """JAX's single-device train step, 3 AdamW steps: the losses and the
    final variables."""
    import jax

    from perceiverio_pytorch_tpu.training import build_optimizer as jax_build_optimizer
    from perceiverio_pytorch_tpu.training import create_train_state, make_train_step

    tx = jax_build_optimizer(LR, **OPT)
    model_state = {k: v for k, v in variables.items() if k != "params"}
    state = create_train_state(variables["params"], tx, model_state=model_state)
    step = make_train_step(loss, tx, donate=False, with_model_state=True)
    losses = []
    for batch in batches:
        state, value = step(state, *batch)
        losses.append(float(value))
    final = {"params": jax.tree_util.tree_map(np.asarray, state.params)}
    if "batch_stats" in (state.model_state or {}):
        final["batch_stats"] = jax.tree_util.tree_map(np.asarray,
                                                      state.model_state["batch_stats"])
    return losses, final


_CASES = {"flow": _flow_case, "mlm": _mlm_case, "cls": _cls_case}


def oracle(kind):
    """The port's initial state_dict of ``kind``, its batches, and JAX's
    losses and final state_dict."""
    from perceiverio_pytorch_tpu_torch.utils.weights import (
        LANGUAGE_OVERRIDES,
        LANGUAGE_TIED,
        state_dict_from_flax,
    )

    variables, batches, loss, _ = _CASES[kind]()
    kw = dict(overrides=LANGUAGE_OVERRIDES, tied=LANGUAGE_TIED) if kind == "mlm" else {}
    losses, final = _jax_run(variables, batches, loss)
    return dict(
        kind=kind, batches=batches, losses=losses,
        state_dict={k: v.numpy() for k, v in state_dict_from_flax(variables, **kw).items()},
        final={k: v.numpy() for k, v in state_dict_from_flax(final, **kw).items()})


def check_sharded_runs(want, world, tmp_path):
    """The runs of ``world`` ranks (``GROUPS``) against JAX (see the module
    docstring)."""
    from perceiverio_pytorch_tpu_torch.parallel.sharding import (
        fsdp_param_partition_spec,
        param_partition_spec,
    )

    kind, initial = want["kind"], want["state_dict"]
    case = dict(kind=kind, state_dict=initial, batches=want["batches"])
    results = run_ranks(_train_rank, world, tmp_path, [case])
    for shape, fsdp in GROUPS[world]:
        key = (kind, shape, fsdp)
        got = results[0][key]
        label = f"{kind} mesh {shape} fsdp={fsdp}"
        np.testing.assert_allclose(got["losses"], want["losses"], err_msg=label, **TOL)
        for rank in range(world):  # every rank returns the global loss
            assert results[rank][key]["losses"] == got["losses"], (label, rank)
        for name, value in got["full"].items():
            if name.endswith("num_batches_tracked"):
                assert int(value) == 3, name
                continue
            if name.endswith("proj_k.bias"):
                assert np.abs(value - initial[name]).max() <= 3 * LR, (label, name)
                continue
            np.testing.assert_allclose(value, want["final"][name], err_msg=f"{label} {name}",
                                       **TOL)
        sizes = {"data": shape[0], "model": shape[1]}
        for name, local in got["local"].items():
            tensor = torch.empty(initial[name].shape)
            spec = param_partition_spec(name, tensor)
            if fsdp:
                spec = fsdp_param_partition_spec(name, tensor, shape[0], base=spec)
            expect = tuple(n // (sizes[a] if a else 1) for n, a in zip(tensor.shape, spec))
            assert local == expect, (label, name, spec)
            for k, moment in got["moments"].get(name, {}).items():
                assert moment == local, (label, name, k)
    return results


@pytest.fixture(scope="module")
def flow_oracle():
    return oracle("flow")


@pytest.mark.parametrize("world", [2, 4])
def test_flow_sharded_steps_match_jax_single_device(flow_oracle, world, tmp_path):
    """DP, TP and FSDP (2 ranks), DP+TP and FSDP+TP (4 ranks): the tiny flow
    model's sites split 16 heads over the model axis in the self-attends
    and gather at the 1-head cross-attends."""
    check_sharded_runs(flow_oracle, world, tmp_path)
