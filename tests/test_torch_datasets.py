"""The port's file-backed data path against the JAX package's.

Trees written by the port's ``tools/make_synthetic_data.py`` (held byte for
byte against the JAX tool's) are read by both packages' datasets: the same
items, bit for bit, for the same seed and epoch; ``dataset_iterator`` and
``batch_iterator`` give the same batches across an epoch boundary and for
two faked processes; the ``.flo`` IO, the flow error numbers, the image
helpers and the label tables are equal.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from perceiverio_pytorch_tpu.training import data as jax_data
from perceiverio_pytorch_tpu.training import datasets as jax_ds
from perceiverio_pytorch_tpu.utils import flow_io as jax_flow_io
from perceiverio_pytorch_tpu.utils import image as jax_image
from perceiverio_pytorch_tpu.utils import labels as jax_labels
from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data as port_tool
from perceiverio_pytorch_tpu_torch.training import data as port_data
from perceiverio_pytorch_tpu_torch.training import datasets as port_ds
from perceiverio_pytorch_tpu_torch.utils import flow_io as port_flow_io
from perceiverio_pytorch_tpu_torch.utils import image as port_image
from perceiverio_pytorch_tpu_torch.utils import labels as port_labels

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_data", os.path.join(ROOT, "tools", "make_synthetic_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree_bytes(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Small trees of every kind, written by the port's tool."""
    root = str(tmp_path_factory.mktemp("data"))
    port_tool.make_flow(root, hw=(20, 28), scenes={"train": (2, 4), "val": (1, 3)})
    port_tool.make_gratings(root, "cls", n_classes=3, amplitude=40, noise=48,
                            per_split={"train": 4}, splits=("train",), hw=(36, 30))
    port_tool.make_text(root, total_chars=20000)
    port_tool.make_clips(root, n_classes=2, num_frames=3, hw=(16, 16), samples_per_frame=32,
                         per_class={"train": 2})
    return root


@pytest.mark.parametrize("kind", ["flow", "gratings", "clips"])
def test_tool_writes_the_jax_tools_files(tmp_path, kind):
    """The port's tool writes the JAX tool's trees byte for byte, from the
    same seeds (at the sizes the JAX tool takes as arguments)."""
    jax_tool = _jax_tool()
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    if kind == "flow":
        port_tool.make_flow(ours, hw=(12, 16))
        jax_tool.make_flow(theirs, hw=(12, 16))
    elif kind == "gratings":
        kw = dict(n_classes=2, amplitude=40, noise=48, per_split={"val": 2}, splits=("val",))
        port_tool.make_gratings(ours, "g", **kw)
        jax_tool.make_gratings(theirs, "g", **kw)
    else:
        pytest.importorskip("cv2")
        kw = dict(n_classes=1, num_frames=2, hw=(8, 8), samples_per_frame=16)
        port_tool.make_clips(ours, **kw)
        jax_tool.make_clips(theirs, **kw)
    got, want = _tree_bytes(ours), _tree_bytes(theirs)
    assert len(want) >= 4 and sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)


def test_tool_text_matches_the_jax_tool(tmp_path):
    port_tool.make_text(str(tmp_path / "port"))
    _jax_tool().make_text(str(tmp_path / "jax"))
    assert _tree_bytes(str(tmp_path / "port")) == _tree_bytes(str(tmp_path / "jax"))


def test_flo_io_and_error_stats_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    flow = rng.normal(size=(2, 7, 9)).astype(np.float32)
    port_flow_io.write_flo(str(tmp_path / "p.flo"), flow)
    jax_flow_io.write_flo(str(tmp_path / "j.flo"), np.transpose(flow, (1, 2, 0)))
    assert (tmp_path / "p.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(port_flow_io.read_flo(str(tmp_path / "j.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="not a .flo"):
        port_flow_io.read_flo(str(tmp_path / "bad.flo"))
    gt = rng.normal(scale=4, size=flow.shape).astype(np.float32)
    pred = gt + rng.normal(scale=3, size=flow.shape).astype(np.float32)
    valid = rng.random(flow.shape[1:]) < 0.7
    for kw in ({}, {"valid": valid}):
        assert port_flow_io.flow_error_stats(pred, gt, **kw) == \
            jax_flow_io.flow_error_stats(pred, gt, **kw)


def test_image_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    hwc = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    port_image.write_png(path, hwc)
    np.testing.assert_array_equal(port_image.load_image(path), jax_image.load_image(path))
    np.testing.assert_array_equal(port_image.read_rgb(path), hwc)
    batch = port_image.load_image(path)
    for size in ((16, 20), (30, 30)):  # a resize, and the square crop's own size
        np.testing.assert_array_equal(port_image.center_crop_resize(batch, size),
                                      jax_image.center_crop_resize(batch, size))
    np.testing.assert_array_equal(port_image.normalize_imagenet(batch),
                                  jax_image.normalize_imagenet(batch))
    np.testing.assert_array_equal(port_image.crop_center_square(hwc),
                                  jax_image.crop_center_square(hwc))
    video = rng.random((3, 16, 16, 3)).astype(np.float32)
    port_image.save_video(str(tmp_path / "v.avi"), video)
    np.testing.assert_array_equal(port_image.load_video(str(tmp_path / "v.avi"), resize=(8, 8)),
                                  jax_image.load_video(str(tmp_path / "v.avi"), resize=(8, 8)))
    port_image.dump_pickle({"a": 1}, str(tmp_path / "x.pkl"))
    assert jax_image.load_pickle(str(tmp_path / "x.pkl")) == port_image.load_pickle(
        str(tmp_path / "x.pkl"))


def test_label_tables_are_the_ports_own_copies():
    assert port_labels.imagenet_labels() == jax_labels.imagenet_labels()
    assert port_labels.kinetics700_labels() == jax_labels.kinetics700_labels()
    port_dir = os.path.realpath(port_labels._DATA_DIR)
    assert port_dir == os.path.join(ROOT, "perceiverio_pytorch_tpu_torch", "data")
    assert port_dir != os.path.realpath(jax_labels._DATA_DIR)


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _dataset_pairs(tree):
    flow_root = os.path.join(tree, "flow_synth")
    cls_root = os.path.join(tree, "cls", "train")
    text = os.path.join(tree, "text", "corpus_train.txt")
    clips = os.path.join(tree, "kinetics_synth", "train")
    return {
        "flow_augment": lambda m: m.FlowPairDataset(flow_root, crop_size=(12, 16),
                                                    augment=True, seed=3),
        "flow_center": lambda m: m.FlowPairDataset(
            os.path.join(flow_root, "val", "scene_00"), crop_size=(12, 16)),
        "flow_native": lambda m: m.FlowPairDataset(flow_root),
        "images_resized": lambda m: m.ImageFolderDataset(cls_root, image_size=(24, 24)),
        "images_native": lambda m: m.ImageFolderDataset(cls_root, image_size=(30, 30)),
        "text": lambda m: m.TextFileDataset(text, seq_len=64, stride=48),
        "mlm": lambda m: m.MLMDataset(m.TextFileDataset(text, seq_len=64), mask_rate=0.2,
                                      seed=5),
        "clips": lambda m: m.VideoClipDataset(clips, num_frames=4, image_size=(8, 8),
                                              audio_samples_per_frame=40),
    }


@pytest.mark.parametrize("name", ["flow_augment", "flow_center", "flow_native",
                                  "images_resized", "images_native", "text", "mlm", "clips"])
def test_dataset_items_match_jax(tree, name):
    """Every item, bit for bit, at epochs 0, 1 and 2 where the dataset takes
    an epoch."""
    if name == "clips":
        pytest.importorskip("cv2")
    make = _dataset_pairs(tree)[name]
    ours, theirs = make(port_ds), make(jax_ds)
    assert len(ours) == len(theirs) > 1
    epochs = (0, 1, 2) if hasattr(theirs, "getitem_at_epoch") else (None,)
    for epoch in epochs:
        for i in range(len(theirs)):
            if epoch is None:
                _assert_items_equal(ours[i], theirs[i])
            else:
                _assert_items_equal(ours.getitem_at_epoch(i, epoch),
                                    theirs.getitem_at_epoch(i, epoch))
    if name == "images_native":
        assert ours.class_names == theirs.class_names == ["class_00", "class_01", "class_02"]


def test_subset_passes_the_epoch_on(tree):
    """The port's Subset hands the epoch to a dataset that takes one (fresh
    crops each epoch); the JAX package's Subset has no getitem_at_epoch."""
    flow = jax_ds.FlowPairDataset(os.path.join(tree, "flow_synth"), crop_size=(12, 16),
                                  augment=True)
    ours = port_ds.Subset(port_ds.FlowPairDataset(os.path.join(tree, "flow_synth"),
                                                  crop_size=(12, 16), augment=True), [4, 1])
    assert not hasattr(jax_ds.Subset(flow, [4, 1]), "getitem_at_epoch")
    for epoch in (0, 2):
        _assert_items_equal(ours.getitem_at_epoch(0, epoch), flow.getitem_at_epoch(4, epoch))
    _assert_items_equal(ours[1], flow[1])
    assert not np.array_equal(ours.getitem_at_epoch(0, 1)[0], ours.getitem_at_epoch(0, 2)[0])
    text = port_ds.TextFileDataset(os.path.join(tree, "text", "corpus_train.txt"), seq_len=32)
    _assert_items_equal(port_ds.Subset(text, [3]).getitem_at_epoch(0, 5), text[3])


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_items_equal(g, w)


def _take(iterator, n):
    return [b for _, b in zip(range(n), iterator)]


@pytest.mark.parametrize("name", ["mlm", "flow_augment"])
@pytest.mark.parametrize("workers", [0, 2])
def test_dataset_iterator_matches_jax_across_epochs(tree, name, workers):
    """Shuffled batches with start_batch inside the second epoch: the same
    batches (the epoch of each one reaches the dataset) whatever the
    decoding threads."""
    make = _dataset_pairs(tree)[name]
    ours, theirs = make(port_ds), make(jax_ds)
    batch = 3 if name == "mlm" else 2
    bpe = len(theirs) // batch
    kw = dict(shuffle=True, seed=7, epochs=None, start_batch=bpe + 1)
    _batches_equal(_take(port_ds.dataset_iterator(ours, batch, num_workers=workers, **kw),
                         2 * bpe + 1),
                   _take(jax_ds.dataset_iterator(theirs, batch, num_workers=0, **kw),
                         2 * bpe + 1))
    kw = dict(shuffle=False, epochs=2, drop_remainder=False)
    _batches_equal(port_ds.dataset_iterator(ours, batch, num_workers=workers, **kw),
                   jax_ds.dataset_iterator(theirs, batch, num_workers=0, **kw))


@pytest.fixture
def two_processes(monkeypatch):
    """Fakes process ``rank`` of two, on both sides: ``torch.distributed``
    for the port, ``jax.process_*`` for the JAX package."""

    def use(rank):
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda *a, **k: rank)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 2)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda: rank)

    return use


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_by_process_matches_jax(tree, two_processes, rank):
    two_processes(rank)
    arrays = (np.arange(20), np.arange(20) * 3)
    kw = dict(shuffle=True, seed=2, epochs=3, shard_by_process=True, start_batch=2)
    got = list(port_data.batch_iterator(arrays, 4, **kw))
    _batches_equal(got, jax_data.batch_iterator(arrays, 4, **kw))
    assert all(len(b[0]) == 2 for b in got)
    make = _dataset_pairs(tree)["mlm"]
    _batches_equal(
        _take(port_ds.dataset_iterator(make(port_ds), 4, num_workers=2, **kw), 5),
        _take(jax_ds.dataset_iterator(make(jax_ds), 4, num_workers=0, **kw), 5))
    with pytest.raises(ValueError, match="divisible"):
        next(port_data.batch_iterator(arrays, 3, shard_by_process=True))
    with pytest.raises(ValueError, match="drop_remainder"):
        next(port_data.batch_iterator(arrays, 4, shard_by_process=True,
                                      drop_remainder=False))


def test_shards_of_two_processes_cover_the_global_batch(tree, two_processes):
    arrays = (np.arange(12),)
    shards = []
    for rank in (0, 1):
        two_processes(rank)
        shards.append([b[0] for b in port_data.batch_iterator(arrays, 4, shuffle=True,
                                                              shard_by_process=True)])
    glob = [b[0] for b in port_data.batch_iterator(arrays, 4, shuffle=True)]
    for g, a, b in zip(glob, *shards):
        np.testing.assert_array_equal(g, np.concatenate([a, b]))


def test_dataset_errors_match_jax(tree, tmp_path):
    for make in (lambda m: m.ImageFolderDataset(str(tmp_path)),
                 lambda m: m.TextFileDataset(str(tmp_path / "none*.txt"), 8),
                 lambda m: m.MLMDataset([], mask_rate=0.0),
                 lambda m: m.FlowPairDataset(str(tmp_path)),
                 lambda m: m.FlowPairDataset(tree, missing_flow="skip")):
        with pytest.raises(ValueError):
            make(jax_ds)
        with pytest.raises(ValueError):
            make(port_ds)
    os.makedirs(tmp_path / "s" / "frames")
    port_image.write_png(str(tmp_path / "s" / "frames" / "a.png"), np.zeros((4, 4, 3), np.uint8))
    port_image.write_png(str(tmp_path / "s" / "frames" / "b.png"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="missing ground truth"):
        port_ds.FlowPairDataset(str(tmp_path / "s"))
    item = port_ds.FlowPairDataset(str(tmp_path / "s"), missing_flow="zeros")[0]
    _assert_items_equal(item, jax_ds.FlowPairDataset(str(tmp_path / "s"),
                                                     missing_flow="zeros")[0])
    with pytest.raises(ValueError, match="smaller than crop"):
        port_ds.FlowPairDataset(str(tmp_path / "s"), crop_size=(8, 8), missing_flow="zeros")[0]
