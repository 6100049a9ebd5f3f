"""The port's export, weights and inference cast against the JAX package's.

``perceiverio_pytorch_tpu_torch.serving`` (``export_apply`` /
``load_exported`` on ``torch.export``) against
``perceiverio_pytorch_tpu.serving`` (``jax.export``): the tiny pixel and
convnet classifiers and the tiny byte MLM, with the JAX package's random
weights carried by ``state_dict_from_flax`` and seeded numpy inputs, fp32
on the CPU, at ``rtol=2e-4, atol=2e-5``.  Then what the port's artifact
must be: batch polymorphic, with static kwargs baked in, weights an
argument (a second state_dict runs through the same bytes) and no
parameter inside; K1's ``torch.library`` op in the graph under
``attn_impl="flash"`` and ``opcheck`` on it; the weights directory
(``save_variables``/``restore_variables``); ``cast_variables_for_inference``
against the JAX one on bf16 outputs (5% of the output's max |x|, as every
bf16 comparison of the port with JAX); and the whole serving stack end to
end.  Every future and socket wait has a timeout.
"""

import dataclasses
import io
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu import serving as jax_serving
from perceiverio_pytorch_tpu.models import classification as jax_cls
from perceiverio_pytorch_tpu.models import language as jax_lang
from perceiverio_pytorch_tpu.utils import params as jax_params
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch import serving as port_serving
from perceiverio_pytorch_tpu_torch.models import classification as port_cls
from perceiverio_pytorch_tpu_torch.models import language as port_lang
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.serving_http import HttpFrontend, decode_npz, encode_npz
from perceiverio_pytorch_tpu_torch.serving_server import BatchingServer
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_variables, save_variables
from perceiverio_pytorch_tpu_torch.utils import params as port_params
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    state_dict_from_flax,
)

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = 0.05  # of the output's max |x|
# The JAX serving tests' tiny classifier (tests/test_serving.py).
SMALL = dict(num_classes=5, img_size=(32, 32), num_self_attends_per_block=1, num_blocks=1,
             num_latents=8, num_latent_channels=32)
PREPS = ["FOURIER_POS_PIXEL", "FOURIER_POS_CONVNET"]
LM_SMALL = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=1,
                num_blocks=1, num_latents=8, num_latent_channels=64)
POSITIONS = np.array([3, 17, 0, 25])
OP = torch.ops.perceiverio_torch.flash_attention_fwd.default


def _images(seed, batch):
    return np.random.default_rng(seed).standard_normal((batch, 3, 32, 32), dtype=np.float32)


def _perturbed(variables, seed):
    """Seeded noise on the 1-D parameters, and BatchNorm statistics off 0
    and 1, so that no bias or scale sits at its initial value."""
    rng = np.random.default_rng(seed)

    def params(x):
        x = np.asarray(x)
        return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32) if x.ndim == 1 else x

    out = {**variables, "params": jax.tree_util.tree_map(params, variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.uniform(0.5, 1.5, np.shape(x)) if p[-1].key == "var"
                          else 0.3 * rng.standard_normal(np.shape(x))).astype(np.float32),
            variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def cls_variables():
    out = {}
    for i, prep in enumerate(PREPS):
        jm = jax_cls.ClassificationPerceiver(prep_type=jax_cls.PrepType[prep],
                                             policy=jax_config.PARITY, **SMALL)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(i), jnp.zeros((1, 3, 32, 32)))
        out[prep] = [_perturbed(jax.tree_util.tree_map(np.asarray, variables), 10 * i + s)
                     for s in (1, 2)]
    return out


def _jax_model(prep, policy=jax_config.PARITY):
    return jax_cls.ClassificationPerceiver(prep_type=jax_cls.PrepType[prep], policy=policy,
                                           **SMALL)


def _port_model(prep, variables, policy=port_config.PARITY):
    model = port_cls.ClassificationPerceiver(prep_type=port_cls.PrepType[prep], policy=policy,
                                             device="cpu", **SMALL)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def pixel_artifact(cls_variables):
    """The pixel classifier exported batch-polymorphic from a batch of 2."""
    model = _port_model("FOURIER_POS_PIXEL", cls_variables["FOURIER_POS_PIXEL"][0])
    blob = port_serving.export_apply(model, model.state_dict(),
                                     torch.from_numpy(_images(0, 2)), batch_polymorphic=True)
    return model, blob


def _exported_program(blob):
    return torch.export.load(io.BytesIO(blob))


@pytest.mark.parametrize("prep", PREPS)
def test_export_roundtrip_matches_jax(cls_variables, pixel_artifact, prep):
    """Both packages export the same weights (the port's pixel artifact is
    the batch-polymorphic one, the convnet's at a fixed batch of 2); both
    artifacts, reloaded from bytes, give the same logits, and the port's
    those of its eager model.  On the dense path (the CPU's, under PARITY)
    the graph holds no K1 op."""
    variables = cls_variables[prep][0]
    img = _images(3, 2)
    jm = _jax_model(prep)
    want = np.asarray(jax_serving.load_exported(
        jax_serving.export_apply(jm.apply, variables, jnp.asarray(img)))(variables, img))
    if prep == "FOURIER_POS_PIXEL":
        model, blob = pixel_artifact
    else:
        model = _port_model(prep, variables)
        blob = port_serving.export_apply(model, model.state_dict(), torch.from_numpy(img))
    assert isinstance(blob, bytes) and len(blob) > 0
    assert not [n for n in _exported_program(blob).graph.nodes if n.target is OP]
    got = port_serving.load_exported(blob)(model.state_dict(), torch.from_numpy(img))
    with torch.no_grad():
        eager = model(torch.from_numpy(img))
    assert got.shape == (2, 5) and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), **TOL)


def test_export_batch_polymorphic_serves_any_batch(cls_variables, pixel_artifact):
    """One artifact, exported at batch 2, serves batches 1 and 3 as JAX's
    batch-polymorphic one does; a batch of 1 cannot be the example."""
    model, blob = pixel_artifact
    variables = cls_variables["FOURIER_POS_PIXEL"][0]
    jm = _jax_model("FOURIER_POS_PIXEL")
    jax_serve = jax_serving.load_exported(jax_serving.export_apply(
        jm.apply, variables, jnp.asarray(_images(0, 2)), batch_polymorphic=True))
    serve = port_serving.load_exported(blob)
    for b in (1, 3):
        img = _images(b, b)
        got = serve(model.state_dict(), torch.from_numpy(img))
        assert got.shape == (b, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_serve(variables, img)), **TOL)
    with pytest.raises(ValueError, match="2 or more"):
        port_serving.export_apply(model, model.state_dict(), torch.from_numpy(_images(0, 1)),
                                  batch_polymorphic=True)


def test_export_static_kwargs_are_baked():
    """The byte MLM with ``predict_positions`` closed over as a static
    kwarg, in both packages: the rows at those positions.  Its token table
    is one module under two names; the artifact takes it once and a
    state_dict holding both names runs through it."""
    jm = jax_lang.LanguagePerceiver(policy=jax_config.PARITY, **LM_SMALL)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 262, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), bool)
    mask[1, 20:] = False
    variables = _perturbed(jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3), tokens, mask)), 4)
    want = np.asarray(jax_serving.load_exported(jax_serving.export_apply(
        jm.apply, variables, tokens, mask, predict_positions=POSITIONS))(
        variables, tokens, mask))
    model = port_lang.LanguagePerceiver(**LM_SMALL, policy=port_config.PARITY, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, overrides=LANGUAGE_OVERRIDES,
                                               tied=LANGUAGE_TIED), strict=True)
    model.eval()
    args = (torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    blob = port_serving.export_apply(model, model.state_dict(), *args,
                                     predict_positions=torch.from_numpy(POSITIONS))
    got = port_serving.load_exported(blob)(model.state_dict(), *args)
    assert got.shape == want.shape == (2, len(POSITIONS), 262)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with torch.no_grad():  # the model came out of the export unchanged
        eager = model(*args, predict_positions=torch.from_numpy(POSITIONS))
    assert type(eager) is torch.Tensor
    np.testing.assert_allclose(eager.numpy(), got.numpy(), **TOL)


def test_second_state_dict_through_the_same_artifact(cls_variables, pixel_artifact):
    """The weights are an argument: the second set of JAX weights through
    the same bytes gives the second model's logits."""
    _, blob = pixel_artifact
    variables = cls_variables["FOURIER_POS_PIXEL"][1]
    img = _images(6, 3)
    second = _port_model("FOURIER_POS_PIXEL", variables)
    got = port_serving.load_exported(blob)(second.state_dict(), torch.from_numpy(img))
    want = np.asarray(jax.jit(_jax_model("FOURIER_POS_PIXEL").apply)(variables, img))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), second(torch.from_numpy(img)).numpy(), **TOL)


def test_artifact_holds_no_parameter(pixel_artifact):
    """The exported program's state holds none of the model's parameters
    or persistent buffers; its only constant is the Fourier table, a
    non-persistent buffer."""
    model, blob = pixel_artifact
    ep = _exported_program(blob)
    assert len(ep.state_dict) == 0
    tables = [b for name, b in model.named_buffers() if name.endswith("fourier_table")]
    assert len(ep.constants) == len(tables) == 1
    (constant,) = ep.constants.values()
    assert torch.equal(constant, tables[0])
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    table = constant.numel() * constant.element_size()
    assert len(blob) < table + weights // 2


def test_k1_op_in_the_exported_graph(cls_variables):
    """Under ``attn_impl="flash"`` every attention site of the tiny pixel
    classifier (encoder, one self-attend, decoder) is K1's op in the graph,
    and the CPU runs its plain version: the logits match JAX's flash path
    (Pallas in interpreter mode)."""
    variables = cls_variables["FOURIER_POS_PIXEL"][0]
    img = _images(7, 2)
    policy = dataclasses.replace(port_config.PARITY, attn_impl="flash")
    model = _port_model("FOURIER_POS_PIXEL", variables, policy)
    blob = port_serving.export_apply(model, model.state_dict(), torch.from_numpy(img))
    nodes = [n for n in _exported_program(blob).graph.nodes if n.target is OP]
    assert len(nodes) == 3
    before = fa.LAUNCHES
    got = port_serving.load_exported(blob)(model.state_dict(), torch.from_numpy(img))
    assert fa.LAUNCHES == before  # CPU tensors take the plain K1
    jax_policy = jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash", interpret=True)
    want = np.asarray(jax.jit(_jax_model("FOURIER_POS_PIXEL", jax_policy).apply)(variables, img))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("return_lse", [True, False])
def test_opcheck_flash_attention_op(return_lse):
    """``torch.library.opcheck`` on K1's op at small masked shapes: schema,
    fake (symbolic batch included) and dispatch, and its CPU implementation
    equal to the plain version."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 10, 2, 8), (2, 37, 2, 8), (2, 37, 2, 6)))
    kv_mask = torch.from_numpy(rng.random((2, 37)) > 0.3)
    q_mask = torch.from_numpy(rng.random((2, 10)) > 0.2)
    args = (q, k, v, kv_mask, q_mask, 0.3, 30, return_lse)
    torch.library.opcheck(OP, args)
    out, lse = OP(*args)
    want = fa.flash_attention_reference(q, k, v, kv_mask=kv_mask, q_mask=q_mask,
                                        softmax_scale=0.3, kv_logical_len=30, return_lse=True)
    assert torch.equal(out, want[0])
    assert torch.equal(lse, want[1]) if return_lse else lse.shape == (0,)


def test_save_restore_variables_round_trip(tmp_path):
    """A weights directory round-trips dtypes, zero-size entries and
    integer buffers exactly; an existing directory is refused unless
    ``overwrite``."""
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(3, 2),
             "pad.pos_embs": torch.zeros((1, 0), dtype=torch.bfloat16),
             "b": torch.full((4,), 1.5, dtype=torch.bfloat16),
             "norm.num_batches_tracked": torch.tensor(7)}
    path = str(tmp_path / "weights")
    save_variables(path, state)
    back = restore_variables(path, device="cpu")
    assert list(back) == list(state)
    for name, t in state.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t)
    with pytest.raises(FileExistsError):
        save_variables(path, state)
    save_variables(path, {"w": state["w"] * 2}, overwrite=True)
    assert list(restore_variables(path, device="cpu")) == ["w"]


@pytest.mark.parametrize("case", ["FOURIER_POS_CONVNET", "LEARNED_POS_1X1CONV", "language"])
def test_cast_variables_for_inference_matches_jax(cls_variables, case):
    """bf16 parameters under PERFORMANCE in both packages (JAX's
    ``cast_variables_for_inference``), in the modules that hold more than
    Dense and LayerNorm parameters (the convs, BatchNorm, the tied token
    table): the outputs agree within 5% of their max |x|.  BatchNorm's
    statistics stay fp32, the tied token table stays one tensor, and a
    module and its state_dict cast alike."""
    rng = np.random.default_rng(9)
    if case == "language":
        jm = jax_lang.LanguagePerceiver(policy=jax_config.PERFORMANCE, **LM_SMALL)
        tokens = rng.integers(0, 262, (2, 32)).astype(np.int32)
        mask = np.ones((2, 32), bool)
        inputs = (tokens, mask)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(2), *inputs)
        model = port_lang.LanguagePerceiver(**LM_SMALL, policy=port_config.PERFORMANCE,
                                            device="cpu")
        sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                                  overrides=LANGUAGE_OVERRIDES, tied=LANGUAGE_TIED)
        port_inputs = (torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    else:
        jm = _jax_model(case, jax_config.PERFORMANCE)
        img = _images(10, 2)
        inputs = (img,)
        if case in cls_variables:
            variables = cls_variables[case][0]
        else:
            variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(img))
            variables = _perturbed(jax.tree_util.tree_map(np.asarray, variables), 11)
        model = port_cls.ClassificationPerceiver(prep_type=port_cls.PrepType[case],
                                                 policy=port_config.PERFORMANCE, device="cpu",
                                                 **SMALL)
        sd = state_dict_from_flax(variables)
        port_inputs = (torch.from_numpy(img),)
    model.load_state_dict(sd, strict=True)
    model.eval()
    want = np.asarray(jax.jit(jm.apply)(jax_params.cast_variables_for_inference(variables),
                                        *inputs).astype(jnp.float32))
    cast = port_params.cast_variables_for_inference(model)
    assert cast.keys() == model.state_dict().keys()
    for name, t in cast.items():
        if name.endswith(("running_mean", "running_var")):
            assert t.dtype == torch.float32
        elif name.endswith("num_batches_tracked"):
            assert t.dtype == torch.int64
        else:
            assert t.dtype == torch.bfloat16, name
    from_sd = port_params.cast_variables_for_inference(model.state_dict())
    assert all(torch.equal(from_sd[n], cast[n]) and from_sd[n].dtype == cast[n].dtype
               for n in cast)
    if case == "language":
        tied = [cast[n] for n in cast if n.endswith(("embed.weight", "_embedding.weight"))]
        assert len(tied) == 2 and tied[0] is tied[1]
    assert next(model.parameters()).dtype == torch.float32  # the module is left as it was
    with torch.no_grad():
        got = torch.func.functional_call(model, cast, port_inputs).float().numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_cast_floating_leaves_other_leaves():
    tree = {"a": torch.ones(2), "b": [torch.arange(3), 1.5], "c": torch.ones(1, dtype=torch.bool)}
    out = port_params.cast_floating(tree)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int64 and out["b"][1] == 1.5
    assert out["c"].dtype == torch.bool


def test_full_serving_stack_end_to_end(cls_variables, pixel_artifact):
    """The whole serving path: export -> reload from bytes -> pipelined
    BatchingServer -> HttpFrontend with binary npz requests from concurrent
    clients -> each client's logits equal JAX's direct apply."""
    model, blob = pixel_artifact
    variables = cls_variables["FOURIER_POS_PIXEL"][0]
    serve = port_serving.load_exported(blob)
    weights = model.state_dict()
    server = BatchingServer(lambda x: serve(weights, x), max_batch=4, max_wait_ms=50.0,
                            pipeline=True, device="cpu")
    front = HttpFrontend(server, port=0).start()
    try:
        examples = list(_images(12, 6))
        want = np.asarray(jax.jit(_jax_model("FOURIER_POS_PIXEL").apply)(
            variables, np.stack(examples)))
        got = [None] * len(examples)

        def client(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{front.port}/v1/infer", data=encode_npz(examples[i]),
                headers={"Content-Type": "application/octet-stream"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                got[i] = decode_npz(resp.read())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(examples))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i in range(len(examples)):
            np.testing.assert_allclose(got[i], want[i], **TOL)
    finally:
        front.stop()
        server.stop()
