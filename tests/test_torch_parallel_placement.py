"""Optimizer state placement and int8 on a mesh, against the port's own
single-process step (the JAX package's oracles for these compare its sharded
step with its single-device one the same way).

In a group of 2 processes (gloo, ``test_torch_parallel.run_ranks``):
Adafactor under FSDP (2, 1), a model wide enough that Adafactor factors its
128-wide projections, and AdamW with ``accum_steps=2`` under FSDP (2, 1)
give the single-process losses and parameters at rtol 2e-4 / atol 2e-5;
Adafactor's factored moments are whole on every rank (replicated, as
JAX's ``opt_state_shardings`` leaves them), its unfactored ones and the
accumulation are placed like their parameters, and ``opt_state_shardings``
says so (JAX ``tests/test_sharding_training.py:97``, :118, :173, :209,
:246).  int8 dynamic QAT (one SGD step of the JAX test's MLM) under (1, 2)
with and without FSDP, and in a group of 4 under (2, 2) with and without
FSDP, gives the single-process loss at rtol 1e-5 and parameters at rtol
1e-4 / atol 1e-5, the JAX test's tolerances (``tests/test_quant.py:362``);
int8 static through ``make_data_parallel_apply`` at (2, 1) gives the
single-process logits at rtol 1e-5 / atol 1e-6 (``tests/test_quant.py:335``).
A projection the rules split outside an attention block or an MLP (a
module's own ``fc1``) is refused by ``shard_module`` (no block would run
its part).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
WIDE_LM = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=1,
               num_latents=8, num_latent_channels=128)
QAT_LM = dict(vocab_size=262, max_seq_len=16, embed_dim=16, num_latents=8,
              num_latent_channels=64, num_self_attends_per_block=1, num_blocks=1)
PIXEL = dict(num_classes=5, img_size=(32, 32), num_self_attends_per_block=1, num_blocks=1,
             num_latents=8, num_latent_channels=32)
OPTIMIZERS = {"adafactor": dict(peak_lr=1e-3, optimizer="adafactor", clip_norm=1.0),
              "accum": dict(peak_lr=1e-3, accum_steps=2, clip_norm=1.0),
              "sgd": dict(peak_lr=1e-2, optimizer="sgd", momentum=None)}


def _lm(cfg, quant, state_dict):
    from perceiverio_pytorch_tpu_torch import PARITY, LanguagePerceiver

    policy = dataclasses.replace(PARITY, quant=quant)
    model = LanguagePerceiver(**cfg, policy=policy, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def _mlm_loss(model, tokens, mask, targets, loss_mask):
    from perceiverio_pytorch_tpu_torch.training import masked_token_cross_entropy

    return masked_token_cross_entropy(model(tokens, mask), targets, loss_mask)


def _train(case, mesh=None, fsdp=False):
    """The case's steps, sharded with ``mesh``; returns (losses, state)."""
    from perceiverio_pytorch_tpu_torch.training import build_optimizer
    from perceiverio_pytorch_tpu_torch.training.trainer import (
        create_sharded_train_state,
        create_train_state,
        make_sharded_train_step,
        make_train_step,
    )

    model = _lm(case["cfg"], case["quant"], case["state_dict"])
    opt = dict(OPTIMIZERS[case["opt"]])
    tx = build_optimizer(opt.pop("peak_lr"), **opt)
    if mesh is None:
        state = create_train_state(model, tx)
        step = make_train_step(_mlm_loss, tx)
    else:
        state = create_sharded_train_state(model, tx, mesh, fsdp=fsdp)
        step = make_sharded_train_step(_mlm_loss, tx, mesh, state)
    losses = []
    for batch in case["batches"]:
        state, loss = step(state, *(torch.as_tensor(x) for x in batch))
        losses.append(loss.item())
    return losses, state


class _Loose(torch.nn.Module):
    """A projection named as the rules split it, outside an ``Attention``
    or ``MLP``."""

    def __init__(self):
        from perceiverio_pytorch_tpu_torch.core.attention import Dense

        super().__init__()
        self.fc1 = Dense(6, 8)


def _refuses_loose(mesh):
    from perceiverio_pytorch_tpu_torch.parallel import shard_module

    try:
        shard_module(_Loose(), mesh)
    except ValueError as exc:
        return str(exc)
    return None


def _placement_rank(rank, world, cases, static):
    from perceiverio_pytorch_tpu_torch.parallel import (
        layout_of,
        make_data_parallel_apply,
        make_mesh,
    )
    from perceiverio_pytorch_tpu_torch.training.checkpoint import _train_state_tree
    from perceiverio_pytorch_tpu_torch.training.trainer import opt_state_shardings

    out = {}
    for case in cases:
        mesh = make_mesh(case["shape"], device="cpu")
        losses, state = _train(case, mesh, case["fsdp"])
        tree = _train_state_tree(state)
        names = {id(p): n for n, p in state.model.named_parameters()}
        out[case["name"]] = dict(
            losses=losses,
            full={k: v.numpy() for k, v in tree["model"].items()} if rank == 0 else None,
            local={n: tuple(p.shape) for n, p in state.model.named_parameters()},
            opt={names[id(p)]: {k: tuple(v.shape) for k, v in entries.items()}
                 for p, entries in state.optimizer.state.items()},
            opt_specs={n: {k: s.spec for k, s in entries.items()}
                       for n, entries in opt_state_shardings(state).items()},
            specs=dict(layout_of(state.model).specs))
    if world == 2:
        out["loose"] = _refuses_loose(make_mesh((1, 2), device="cpu"))
    if static is not None:
        from perceiverio_pytorch_tpu_torch import PARITY, ClassificationPerceiver, PrepType

        mesh = make_mesh((world, 1), device="cpu")
        model = ClassificationPerceiver(
            prep_type=PrepType.FOURIER_POS_PIXEL, **PIXEL, device="cpu",
            policy=dataclasses.replace(PARITY, quant="int8_static")).eval()
        fn, place = make_data_parallel_apply(model, mesh)
        with torch.no_grad():
            out["static"] = fn(*place(static["state_dict"], static["images"])).numpy()
    return out


def _batches(seed, n, seq):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(6, 262, (4, seq)).astype(np.int32)
        mask = np.ones((4, seq), bool)
        loss_mask = rng.random((4, seq)) < np.array([0.5, 0.5, 0.2, 0.2])[:, None]
        out.append((tokens, mask, tokens, loss_mask))
    return out


def _state_dict(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    from perceiverio_pytorch_tpu_torch import PARITY, LanguagePerceiver

    return LanguagePerceiver(**cfg, policy=PARITY, device="cpu", generator=gen).state_dict()


@pytest.fixture(scope="module")
def cases():
    wide, qat = _state_dict(WIDE_LM, 1), _state_dict(QAT_LM, 2)
    two = [dict(name="adafactor", cfg=WIDE_LM, quant=None, state_dict=wide, opt="adafactor",
                batches=_batches(3, 2, 32), shape=(2, 1), fsdp=True),
           dict(name="accum", cfg=WIDE_LM, quant=None, state_dict=wide, opt="accum",
                batches=_batches(4, 4, 32), shape=(2, 1), fsdp=True)]
    for fsdp in (False, True):
        two.append(dict(name=f"int8_tp_fsdp{fsdp}", cfg=QAT_LM, quant="int8_dynamic",
                        state_dict=qat, opt="sgd", batches=_batches(5, 1, 16), shape=(1, 2),
                        fsdp=fsdp))
    four = [dict(c, name=f"int8_dp_tp_fsdp{c['fsdp']}", shape=(2, 2))
            for c in two if c["name"].startswith("int8")]
    return {2: two, 4: four}


@pytest.fixture(scope="module")
def static_case():
    from perceiverio_pytorch_tpu_torch import PARITY, ClassificationPerceiver, PrepType
    from perceiverio_pytorch_tpu_torch.ops.quant import calibrate

    model = ClassificationPerceiver(
        prep_type=PrepType.FOURIER_POS_PIXEL, **PIXEL, device="cpu",
        generator=torch.Generator().manual_seed(3),
        policy=dataclasses.replace(PARITY, quant="int8_static")).eval()
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 3, 32, 32), dtype=np.float32))
    calibrate(model, [(images,)])
    with torch.no_grad():
        want = model(images).numpy()
    return dict(state_dict=model.state_dict(), images=images, want=want)


@pytest.mark.parametrize("world", [2, 4])
def test_optimizer_state_and_int8_on_a_mesh(cases, static_case, world, tmp_path):
    from perceiverio_pytorch_tpu_torch.training.trainer import _PARAM_LIKE

    results = run_ranks(_placement_rank, world, tmp_path, cases[world],
                        static_case if world == 2 else None)
    for case in cases[world]:
        want_losses, want_state = _train(case)
        want = {k: v.numpy() for k, v in want_state.model.state_dict().items()}
        got = results[0][case["name"]]
        int8 = case["quant"] is not None
        loss_tol = dict(rtol=1e-5) if int8 else TOL
        param_tol = dict(rtol=1e-4, atol=1e-5) if int8 else TOL
        np.testing.assert_allclose(got["losses"], want_losses, err_msg=case["name"], **loss_tol)
        for name, value in got["full"].items():
            np.testing.assert_allclose(value, want[name], err_msg=f"{case['name']} {name}",
                                       **param_tol)
        whole = {n: tuple(p.shape) for n, p in want_state.model.named_parameters()}
        want_opt = {n: {k: tuple(v.shape) for k, v in entries.items()}
                    for n, entries in (
                        (dict((id(p), n) for n, p in want_state.model.named_parameters())[id(p)],
                         e) for p, e in want_state.optimizer.state.items())}
        for rank in range(world):
            local, opt = results[rank][case["name"]]["local"], results[rank][case["name"]]["opt"]
            assert set(opt) == set(want_opt)
            for name, entries in opt.items():
                assert set(entries) == set(want_opt[name]), name
                for k, shape in entries.items():
                    # moments like their parameter's piece; Adafactor's
                    # factored moments whole
                    assert shape == (local[name] if k in _PARAM_LIKE else want_opt[name][k]), \
                        (case["name"], name, k)
            specs = results[rank][case["name"]]["specs"]
            for name, entries in results[rank][case["name"]]["opt_specs"].items():
                for k, spec in entries.items():
                    assert spec == (specs[name] if k in _PARAM_LIKE else ()), (name, k)
        if case["name"] == "adafactor":
            factored = [n for n, e in got["opt"].items() if "v_row" in e]
            assert factored and any(got["local"][n] != whole[n] for n in factored)
        if case["fsdp"] and case["shape"][0] > 1:
            assert any(got["local"][n] != whole[n] for n in whole)
    if world == 2:
        for rank in range(world):
            np.testing.assert_allclose(results[rank]["static"], static_case["want"],
                                       rtol=1e-5, atol=1e-6)
            assert "['fc1']" in results[rank]["loose"]
