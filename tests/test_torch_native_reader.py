"""The port's native dvrec reader (deep_vision_tpu_torch/data/native:
dvrec_reader.cc built with the host's C++ compiler) behind
``ImageNetLoader._native_batch``: built here with g++; its batches byte
for byte the port's numpy path and the JAX package's ``ImageNetLoader``
(the counterpart of tests/test_imagenet_data.py's native check) on the
same raw shards and seeds; a failing compile and a truncated shard
raise; only a machine without a compiler takes the numpy path, and says
so once; ``assemble_batch.batches`` moves only on the native path."""

import os
import stat

import numpy as np
import pytest

pytest.importorskip("PIL")

import _torch_prep as tp  # noqa: E402
from deep_vision_tpu.data import imagenet as jax_imagenet  # noqa: E402
from deep_vision_tpu_torch.data import imagenet as port_imagenet  # noqa: E402
from deep_vision_tpu_torch.data import native  # noqa: E402
from deep_vision_tpu_torch.data import prep as port_prep  # noqa: E402
from deep_vision_tpu_torch.ops import _build  # noqa: E402

SIZE, RESIZE, BATCH = 32, 40, 5


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """12 images of 3 classes at odd sizes, stored raw with the shorter
    side at RESIZE in 2 shards (train) and 3 shards (val)."""
    root = tmp_path_factory.mktemp("native")
    flat = tp.imagenet_flat(root / "flat", per_class=4)
    labels = tp.metadata(root / "meta.txt")
    out = str(root / "recs")
    for split, n in (("train", 2), ("val", 3)):
        assert port_prep.prepare_imagenet(flat, labels, out, split,
                                          num_shards=n, num_workers=1,
                                          store="raw", resize=RESIZE) == 12
    return out


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The reader loaded anew from an empty build directory; the real
    one is loaded again afterwards."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    native.reset()
    yield
    native.reset()


def _loader(pkg, root, split, train, seed=7, **kw):
    kw = dict(train=train, image_size=SIZE, resize=RESIZE, num_workers=0,
              seed=seed, device_normalize=True, **kw)
    if pkg is jax_imagenet:
        kw.update(process_index=0, process_count=1)
    return pkg.ImageNetLoader.from_records(root, split, BATCH, **kw)


def _epochs(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += list(loader)
    loader.close()
    return out


def _numpy_path(monkeypatch):
    monkeypatch.setattr(port_imagenet.ImageNetLoader, "_native_batch",
                        lambda self, args, n_real: None)


def _assert_equal_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_reader_builds_with_the_host_compiler(tmp_path, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    assert os.path.basename(native.compiler()) in ("g++", "c++")
    path = native.build(str(tmp_path))
    assert path == native.library_path(str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    mtime = os.stat(path).st_mtime_ns
    assert native.build(str(tmp_path)) == path  # keyed by the source hash
    assert os.stat(path).st_mtime_ns == mtime
    assert native.library_path().startswith(_build.BUILD_DIR)
    assert native.load() is not None


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("split,train", [("train", True), ("val", False)])
def test_native_batches_equal_numpy_and_reference(shards, monkeypatch, split,
                                                  train, seed):
    # the reference on its numpy path: byte-equal to its own native one
    # (tests/test_imagenet_data.py), and no build outside the checkout
    monkeypatch.setenv("DEEP_VISION_TPU_NO_NATIVE", "1")
    before = native.assemble_batch.batches
    loader = _loader(port_imagenet, shards, split, train, seed)
    n = len(loader)
    got = _epochs(loader)
    assert native.assemble_batch.batches - before == 2 * n
    assert all(b["image"].flags["C_CONTIGUOUS"] for b in got)
    want = _epochs(_loader(jax_imagenet, shards, split, train, seed))
    _assert_equal_batches(got, want)
    _numpy_path(monkeypatch)
    numpy_batches = _epochs(_loader(port_imagenet, shards, split, train,
                                    seed))
    assert native.assemble_batch.batches - before == 2 * n
    _assert_equal_batches(got, numpy_batches)
    if train:  # control: another seed draws other crops and flips
        other = _epochs(_loader(port_imagenet, shards, split, train,
                                seed + 1))
        assert any(not np.array_equal(a["image"], b["image"])
                   for a, b in zip(got, other))


def test_native_count_moves_only_on_the_native_path(shards, tmp_path):
    c = native.assemble_batch
    cases = [
        # host-normalized float32: the numpy path
        dict(device_normalize=False),
        # stored at another size than the loader's resize: a rescale
        dict(resize=RESIZE + 4),
    ]
    for kw in cases:
        before = c.batches
        batches = _epochs(port_imagenet.ImageNetLoader.from_records(
            shards, "train", BATCH, **{**dict(
                image_size=SIZE, resize=RESIZE, num_workers=0), **kw}), (0,))
        assert batches and c.batches == before, kw
    # JPEG payloads decode on the numpy path
    flat = tp.imagenet_flat(tmp_path / "flat", per_class=2)
    jpeg = str(tmp_path / "jpeg")
    port_prep.prepare_imagenet(flat, tp.metadata(tmp_path / "m.txt"), jpeg,
                               "train", num_shards=1, num_workers=1)
    before = c.batches
    assert _epochs(_loader(port_imagenet, jpeg, "train", True), (0,))
    assert c.batches == before
    before = c.batches
    loader = _loader(port_imagenet, shards, "train", True)
    assert len(_epochs(loader, (0,))) == c.batches - before == len(loader)


def _failing_compiler(tmp_path) -> str:
    script = tmp_path / "cxx.sh"
    script.write_text("#!/bin/sh\necho 'dvrec_reader.cc:1: error: boom' >&2"
                      "\nexit 1\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_a_failing_compile_raises(shards, tmp_path, monkeypatch,
                                  fresh_native):
    monkeypatch.setenv("CXX", _failing_compiler(tmp_path))
    with pytest.raises(RuntimeError, match="(?s)exit 1.*error: boom"):
        native.build(str(tmp_path / "direct"))
    assert not os.listdir(tmp_path / "direct")  # no partial library left
    loader = _loader(port_imagenet, shards, "train", True)
    with pytest.raises(RuntimeError, match="error: boom"):
        next(iter(loader))
    loader.close()
    # control: with the compiler back the same loader builds and reads
    monkeypatch.delenv("CXX")
    native.reset()
    before = native.assemble_batch.batches
    assert len(_epochs(loader, (0,))) == len(loader)
    assert native.assemble_batch.batches - before == len(loader)


def test_no_compiler_takes_the_numpy_path_and_says_so_once(
        shards, monkeypatch, capsys, fresh_native):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    before = native.assemble_batch.batches
    got = _epochs(_loader(port_imagenet, shards, "train", True))
    got += _epochs(_loader(port_imagenet, shards, "val", False))
    err = capsys.readouterr().err
    assert err.count("no C++ compiler") == 1
    assert native.assemble_batch.batches == before
    monkeypatch.undo()
    _numpy_path(monkeypatch)
    want = _epochs(_loader(port_imagenet, shards, "train", True))
    want += _epochs(_loader(port_imagenet, shards, "val", False))
    _assert_equal_batches(got, want)


def test_a_truncated_shard_raises_naming_the_record(shards, tmp_path,
                                                    monkeypatch):
    import shutil

    root = str(tmp_path / "cut")
    shutil.copytree(shards, root)
    loader = _loader(port_imagenet, root, "val", False)
    path, off, plen, _ = loader.ds.entries[-1]
    with open(path, "r+b") as f:
        f.truncate(off + plen - 7)
    before = native.assemble_batch.batches
    with pytest.raises(OSError, match=f"{path}@{off}: the native reader"):
        list(loader)
    assert native.assemble_batch.batches - before < len(loader)
    loader.close()
    # the numpy path names the same record
    _numpy_path(monkeypatch)
    loader = _loader(port_imagenet, root, "val", False)
    with pytest.raises(OSError, match=f"{path}@{off}: read {plen - 7} of"):
        list(loader)
    loader.close()


def test_more_shards_a_batch_than_cached_descriptors(shards, monkeypatch):
    """Every batch touches every shard while the read cache holds one
    file: each native call opens its own descriptors, so none is closed
    and reused for another shard under it."""
    monkeypatch.setattr(port_imagenet, "_FDS_MAX", 1)
    got = _epochs(_loader(port_imagenet, shards, "val", False))
    _numpy_path(monkeypatch)
    want = _epochs(_loader(port_imagenet, shards, "val", False))
    _assert_equal_batches(got, want)


def test_a_payload_shorter_than_its_shape_is_not_read_natively(tmp_path):
    """A raw header whose shape needs more bytes than its payload holds:
    the reader would read past the record into a buffer sized for it, so
    the batch goes to the numpy path, which refuses the record."""
    from deep_vision_tpu_torch.data.records import RecordWriter, shard_name

    root = str(tmp_path)
    rng = np.random.default_rng(3)
    with RecordWriter(shard_name(root, "train", 0, 1)) as w:
        for i in range(BATCH):
            img = rng.integers(0, 256, (RESIZE, RESIZE, 3), dtype=np.uint8)
            payload = img.tobytes()[:-3] if i == 2 else img.tobytes()
            w.write({"label": i, "enc": "raw",
                     "shape": [RESIZE, RESIZE, 3]}, payload)
    before = native.assemble_batch.batches
    loader = _loader(port_imagenet, root, "train", True)
    with pytest.raises(ValueError, match="reshape"):
        list(loader)
    loader.close()
    assert native.assemble_batch.batches == before
