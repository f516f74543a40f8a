"""Artifact upload (``core/upload.py``) and ``cli.train --upload``,
mirroring the reference's tests/test_upload.py on the port: incremental
sync, the fresh-run guard, the restore round trip, preemption recovery
onto a fresh host, both trainers uploading, and a ``gs://`` destination
without a client failing loudly while training goes on."""

import os
import shutil

import numpy as np
import pytest
import torch

from deep_vision_tpu.core import upload as ref
from deep_vision_tpu_torch.core import upload as port
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.data.loader import ArrayLoader
from deep_vision_tpu_torch.data.mnist import synthetic_mnist
from deep_vision_tpu_torch.tasks.classification import ClassificationTask


def _tree(path):
    return {os.path.relpath(os.path.join(r, f), path):
            open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(path) for f in fs}


@pytest.mark.parametrize("mod", [ref, port], ids=["ref", "port"])
def test_sync_dir_incremental(tmp_path, mod):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("one")
    (src / "sub" / "b.txt").write_text("two")
    dest = tmp_path / "dest"
    assert mod.sync_dir(str(src), f"file://{dest}") == 2
    assert (dest / "sub" / "b.txt").read_text() == "two"
    assert mod.sync_dir(str(src), str(dest)) == 0
    (src / "a.txt").write_text("one-changed")
    assert mod.sync_dir(str(src), str(dest)) == 1
    assert (dest / "a.txt").read_text() == "one-changed"
    # a file pruned locally (max_to_keep) leaves the mirror too
    os.remove(src / "sub" / "b.txt")
    assert mod.sync_dir(str(src), str(dest)) == 0
    assert _tree(dest) == _tree(src)


def test_sync_fresh_run_never_wipes_mirror(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    dest = tmp_path / "dest"
    (dest / "ckpt-5").mkdir(parents=True)
    (dest / "ckpt-5" / "data").write_text("precious")
    assert port.sync_dir(str(src), str(dest)) == 0
    assert (dest / "ckpt-5" / "data").read_text() == "precious"


def test_restore_dir_roundtrip(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "sub" / "b.txt").write_text("two")
    dest = tmp_path / "dest"
    port.sync_dir(str(src), str(dest))
    back = tmp_path / "back"
    assert port.restore_dir(f"file://{dest}", str(back)) == 1
    assert (back / "sub" / "b.txt").read_text() == "two"
    assert port.restore_dir(str(tmp_path / "nope"), str(back / "x")) == 0


def _lenet(tmp_path, upload, epochs=1):
    cfg = get_config("lenet5")
    cfg.total_epochs = epochs
    cfg.batch_size = 32
    trainer = Trainer(cfg, cfg.model(), ClassificationTask(10),
                      workdir=str(tmp_path / "run"), upload=upload,
                      device="cpu")
    data = synthetic_mnist(64)
    return (trainer, ArrayLoader(data, cfg.batch_size, seed=1),
            ArrayLoader(data, cfg.batch_size, shuffle=False))


def test_trainer_uploads_checkpoints(tmp_path):
    dest = tmp_path / "mirror"
    trainer, train, val = _lenet(tmp_path, str(dest))
    trainer.fit(train, val)
    for sub in ("checkpoints", "checkpoints_best"):
        local = _tree(tmp_path / "run" / sub)
        assert local and _tree(dest / sub) == local, sub


def test_trainer_restores_from_mirror_and_resumes(tmp_path):
    """Train one epoch with an upload, wipe the workdir (the host died),
    build the Trainer again with the same URI: the checkpoints come back
    from the mirror, the run resumes at epoch 2 and ends on the weights
    of a run that was never interrupted."""
    dest = tmp_path / "mirror"
    trainer, train, val = _lenet(tmp_path, str(dest), epochs=1)
    trainer.fit(train, val)
    shutil.rmtree(tmp_path / "run")
    trainer2, train, val = _lenet(tmp_path, str(dest), epochs=2)
    assert trainer2.checkpointer.latest_step() is not None
    resumed = trainer2.fit(train, val, resume=True)
    assert trainer2.start_epoch == 2
    assert os.listdir(dest / "checkpoints")
    whole, train, val = _lenet(tmp_path / "whole", None, epochs=2)
    straight = whole.fit(train, val)
    got, want = resumed.model.state_dict(), straight.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_adversarial_trainer_uploads(tmp_path):
    from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
    from deep_vision_tpu_torch.data.gan import GANLoader, mnist_gan_data
    from deep_vision_tpu_torch.models import gan as gan_models
    from deep_vision_tpu_torch.tasks.gan import DCGANTask

    cfg = get_config("dcgan")
    cfg.batch_size = 16
    cfg.checkpoint_every_epochs = 1
    task = DCGANTask(gan_models.DCGANGenerator, gan_models.DCGANDiscriminator,
                     opt=cfg.optimizer)
    dest = tmp_path / "mirror"
    trainer = AdversarialTrainer(cfg, task, workdir=str(tmp_path / "run"),
                                 device="cpu", upload=str(dest))
    loader = GANLoader(mnist_gan_data(None, n_synthetic=32), 16, seed=0)
    trainer.fit(loader, epochs=1)
    local = _tree(tmp_path / "run" / "checkpoints")
    assert local and _tree(dest / "checkpoints") == local


def test_gs_without_a_client_fails_loudly_and_training_goes_on(
        tmp_path, capsys, monkeypatch):
    """Neither google-cloud-storage nor gsutil: the reference's
    RuntimeError, reported by the uploader as ``[upload] FAILED``; the
    run finishes and keeps its local checkpoints."""
    import builtins

    real_import = builtins.__import__

    def no_gcs(name, *a, **k):
        if name.startswith("google"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_gcs)
    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="neither is available"):
        port.sync_dir(str(tmp_path), "gs://bucket/run")
    trainer, train, val = _lenet(tmp_path, "gs://bucket/run")
    state = trainer.fit(train, val)
    out = capsys.readouterr().out
    assert "[upload] restore FAILED for checkpoints: gs:// restore needs " \
        "google-cloud-storage or gsutil" in out
    assert "[upload] FAILED for checkpoints: gs:// upload needs " \
        "google-cloud-storage or gsutil; neither is available" in out
    assert state.step == 2 and trainer.checkpointer.latest_step() == 2
    assert np.isfinite(trainer.logger.latest("train_loss"))
