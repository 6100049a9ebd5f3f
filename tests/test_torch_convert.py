"""The port's convert.py: the family templates against the JAX package's
models, the .pth <-> weights directory round trip, and its refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu.models import ClassificationPerceiver as JaxClassification
from perceiverio_pytorch_tpu.models import FlowPerceiver as JaxFlow
from perceiverio_pytorch_tpu.models import LanguagePerceiver as JaxLanguage
from perceiverio_pytorch_tpu.models import MultiModalPerceiver as JaxMultiModal
from perceiverio_pytorch_tpu.models import PrepType as JaxPrepType
from perceiverio_pytorch_tpu_torch import ClassificationPerceiver, MultiModalPerceiver, PrepType
from perceiverio_pytorch_tpu_torch import convert
from perceiverio_pytorch_tpu_torch.training import restore_variables
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    translate_path,
)

torch.set_num_threads(1)


def _jax_shapes(family, prep):
    """``jax.eval_shape`` of the published JAX model's init, as the JAX
    package's own convert.py builds it (the classifier's PrepType by name)."""
    key = jax.random.PRNGKey(0)
    f32 = jnp.float32
    if family == "language":
        tokens = jax.ShapeDtypeStruct((1, 2048), jnp.int32)
        mask = jax.ShapeDtypeStruct((1, 2048), jnp.bool_)
        return jax.eval_shape(JaxLanguage().init, key, tokens, mask)
    if family == "classification":
        img = jax.ShapeDtypeStruct((1, 3, 224, 224), f32)
        return jax.eval_shape(JaxClassification(prep_type=JaxPrepType[prep]).init, key, img)
    if family == "flow":
        img = jax.ShapeDtypeStruct((1, 3, 368, 496), f32)
        return jax.eval_shape(JaxFlow().init, key, img, img)
    model = JaxMultiModal()
    video = jax.ShapeDtypeStruct((1, 16, 3, 224, 224), f32)
    audio = jax.ShapeDtypeStruct((1, 30720, 1), f32)
    return jax.eval_shape(lambda k, v, a: model.init(k, v, a, 16), key, video, audio)


def _translated(shapes, overrides=None, tied=None):
    """The torch names and shapes ``state_dict_from_flax`` gives a variables
    tree, from its shapes alone."""
    overrides = overrides or {}
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes.get(collection, {}))[0]:
            names = tuple(str(getattr(k, "key", k)) for k in path)
            shape = tuple(leaf.shape)
            if names[-1] == "kernel":
                shape = shape[::-1] if len(shape) == 2 else tuple(shape[i] for i in (3, 2, 0, 1))
            name = overrides.get("/".join(names)) or translate_path(names, collection)
            out[name] = shape
            if collection == "batch_stats" and names[-1] == "mean":
                out[name[: -len("running_mean")] + "num_batches_tracked"] = ()
    for alias, source in (tied or {}).items():
        out[alias] = out[source]
    return out


@pytest.mark.parametrize("family,prep", [
    ("language", None), ("flow", None), ("multimodal", None),
    ("classification", "FOURIER_POS_CONVNET"), ("classification", "LEARNED_POS_1X1CONV"),
    ("classification", "FOURIER_POS_PIXEL")])
def test_family_template_matches_the_jax_model(family, prep):
    """Each family's template (the published model on the meta device: no
    weight drawn) has the names and shapes of the JAX model's variables."""
    template = convert.build_family_template(family, prep or "FOURIER_POS_CONVNET")
    assert all(t.device.type == "meta" for t in template.state_dict().values())
    got = {k: tuple(v.shape) for k, v in template.state_dict().items()}
    extra = dict(overrides=LANGUAGE_OVERRIDES, tied=LANGUAGE_TIED) if family == "language" else {}
    assert got == _translated(_jax_shapes(family, prep), **extra)


def test_pth_to_directory_to_pth_is_bit_for_bit(tmp_path, capsys):
    """The published multimodal model: .pth -> weights directory -> .pth,
    every tensor equal bit for bit, the directory strict for the model."""
    model = MultiModalPerceiver(device="cpu", generator=torch.Generator().manual_seed(3))
    state = model.state_dict()
    src, weights, back = tmp_path / "mm.pth", tmp_path / "mm", tmp_path / "back.pth"
    torch.save({"model_state_dict": state}, src)
    assert convert.main([str(src), str(weights), "--family", "multimodal"]) == 0
    assert f"{len(state)} tensors" in capsys.readouterr().out
    restored = restore_variables(str(weights), device="cpu")
    assert convert.main([str(weights), str(back), "--family", "multimodal"]) == 0
    again = torch.load(back, weights_only=True)["model_state_dict"]
    for sd in (restored, again):
        assert set(sd) == set(state)
        for k, v in state.items():
            assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k
    MultiModalPerceiver(device="cpu").load_state_dict(restored, strict=True)
    with pytest.raises(FileExistsError):
        convert.main([str(src), str(weights), "--family", "multimodal"])
    convert.main([str(src), str(weights), "--family", "multimodal", "--overwrite"])


def test_convert_refuses_a_foreign_checkpoint(tmp_path):
    """A foreign key, a bare state_dict of another family and another prep
    type each fail, naming the first bad key and its shapes; a .pth without
    BatchNorm's counters (written from JAX variables) takes them as 0."""
    model = ClassificationPerceiver(prep_type=PrepType.FOURIER_POS_CONVNET, device="cpu",
                                    generator=torch.Generator().manual_seed(1))
    state = model.state_dict()
    no_counters = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    assert len(no_counters) < len(state)
    torch.save(no_counters, tmp_path / "cls.pth")  # a bare state_dict
    template = convert.build_family_template("classification", "fourier_pos_convnet")
    convert.convert(str(tmp_path / "cls.pth"), str(tmp_path / "cls"), template)
    restored = restore_variables(str(tmp_path / "cls"), device="cpu")
    assert set(restored) == set(state)
    assert all(int(restored[k]) == 0 for k in state if k.endswith("num_batches_tracked"))
    torch.save({"model_state_dict": {**state, "bogus": torch.ones(2)}}, tmp_path / "extra.pth")
    with pytest.raises(ValueError, match=r"'bogus': checkpoint shape \(2,\), model shape None"):
        convert.convert(str(tmp_path / "extra.pth"), str(tmp_path / "x"), template)
    with pytest.raises(ValueError, match="does not match the family's model at"):
        convert.convert(str(tmp_path / "cls.pth"), str(tmp_path / "y"),
                        convert.build_family_template("classification", "FOURIER_POS_PIXEL"))
    with pytest.raises(ValueError, match=r"checkpoint shape \(.*\), model shape \(.*\)"):
        convert.main([str(tmp_path / "cls.pth"), str(tmp_path / "z"), "--family", "flow"])
    with pytest.raises(ValueError, match="unknown family"):
        convert.build_family_template("speech")


def test_convert_rejects_ambiguous_direction(tmp_path):
    template = convert.build_family_template("flow")
    with pytest.raises(ValueError, match="exactly one"):
        convert.convert("a.pth", "b.pth", template)
    with pytest.raises(ValueError, match="exactly one"):
        convert.convert(str(tmp_path / "a"), str(tmp_path / "b"), template)
    assert np.all([not (tmp_path / n).exists() for n in ("a", "b")])
