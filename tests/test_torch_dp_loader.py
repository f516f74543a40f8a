"""The data-parallel input and logging of the port against the
reference: ``ImageNetLoader`` at rank ``r`` of ``w`` (each rank reads
``np.arange(r, len, w)`` of every epoch) byte for byte the reference's
loader at ``process_index=r, process_count=w``, with the rank and world
taken from the process group by default (two gloo ranks on the CPU,
``tests/_torch_dist_worker.py``); and two ranks' ``Trainer.fit`` writing
``metrics.jsonl`` and the TensorBoard events once (rank 0) while both
keep the history."""

import json
import os

import numpy as np
import pytest

from _torch_dist_worker import run_ranks
from deep_vision_tpu.data import imagenet as jax_imagenet
from deep_vision_tpu_torch.data import imagenet as port_imagenet
from deep_vision_tpu_torch.data.records import RecordWriter, shard_name
from test_torch_data_parallel import LR, _batch, _variables

CLASSES = 10


def _write_records(root, n_train=11, n_val=7, side=40, seed=0):
    """Raw-payload records at ``side``² (rank shards of unequal length)."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        with RecordWriter(shard_name(str(root), split, 0, 1)) as w:
            for i in range(n):
                img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
                w.write({"label": int(i % CLASSES), "enc": "raw",
                         "shape": [side, side, 3]}, img.tobytes())


KW = dict(image_size=32, resize=40, seed=3)


def _reference(root, split, rank, world, monkeypatch):
    # the reference's native reader would build outside the checkout
    monkeypatch.setenv("DEEP_VISION_TPU_NO_NATIVE", "1")
    return jax_imagenet.ImageNetLoader.from_records(
        str(root), split, 2, num_workers=0, device_normalize=True,
        process_index=rank, process_count=world, train=split == "train",
        **KW)


def _equal(got: list, want: list):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("rank,world", [(0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("split", ["train", "val"])
def test_rank_shard_is_the_reference_process_shard(tmp_path, monkeypatch,
                                                    rank, world, split):
    _write_records(tmp_path)
    want = _reference(tmp_path, split, rank, world, monkeypatch)
    got = port_imagenet.ImageNetLoader.from_records(
        str(tmp_path), split, 2, num_workers=0, process_index=rank,
        process_count=world, train=split == "train", **KW)
    np.testing.assert_array_equal(got.host_indices, want.host_indices)
    for epoch in (1, 2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        _equal(list(got), list(want))
    want.close()
    got.close()


def test_without_a_group_a_loader_reads_every_record(tmp_path):
    _write_records(tmp_path)
    got = port_imagenet.ImageNetLoader.from_records(
        str(tmp_path), "train", 2, num_workers=0, **KW)
    np.testing.assert_array_equal(got.host_indices, np.arange(11))
    got.close()


def test_ranks_take_their_shard_from_the_group(tmp_path, monkeypatch):
    _write_records(tmp_path)
    ranks = run_ranks(2, [("loader", dict(root=str(tmp_path), split=s,
                                          batch_size=2,
                                          train=s == "train", **KW))
                          for s in ("train", "val")])
    for rank in (0, 1):
        for i, split in enumerate(("train", "val")):
            want = _reference(tmp_path, split, rank, 2, monkeypatch)
            want.set_epoch(1)
            _equal(ranks[rank][i], list(want))
            want.close()


def test_two_ranks_write_the_run_files_once(tmp_path):
    work = str(tmp_path / "work")
    ranks = run_ranks(2, [("fit", dict(
        variables=_variables(), batches=[_batch(10), _batch(11)],
        val=[_batch(30, weight=True)], workdir=work, epochs=2, lr=LR))])
    lines = [json.loads(s) for s in
             open(os.path.join(work, "metrics.jsonl")).read().splitlines()]
    keys = [(d["name"], d["step"]) for d in lines]
    assert len(keys) == len(set(keys)), "a value logged twice"
    # both ranks kept the same history; the file holds it once
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
    assert [d["value"] for d in lines if d["name"] == "train_loss"] == \
        ranks[0][0]["losses"]
    assert ranks[0][0]["val"] == ranks[1][0]["val"]
    events = os.listdir(os.path.join(work, "tensorboard"))
    assert len(events) == 1, events
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == \
        ["2", "4"]
    assert ranks[0][0]["writes"] >= 2 and ranks[1][0]["writes"] == 0
