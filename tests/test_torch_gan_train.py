"""The port's GAN training input and loop on the CPU, against the JAX
reference where there is one: ``data/gan.py`` (``mnist_gan_data``,
``GANLoader``, ``UnpairedLoader``, ``synthetic_unpaired``,
``to_uint8_wire``) batch for batch, ``make_gan_preprocess`` bit for bit,
the unpaired records that the JAX ``prepare_unpaired`` writes, the
adversarial trainer's fit → checkpoint → resume for both tasks, the
``cli.train`` GAN branch, and the per-epoch learning rate on every
optimizer.  Everything here is exact: numpy with the same seeds, and
float32 casts and divisions by the same constants."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_vision_tpu.core.optim import build_scheduler as jax_scheduler
from deep_vision_tpu.data import gan as jdata
from deep_vision_tpu.ops.preprocess import (
    make_gan_preprocess as jax_gan_preprocess,
)
from deep_vision_tpu_torch.cli import train as cli
from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
from deep_vision_tpu_torch.core.checkpoint import Checkpointer
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.optim import build_scheduler
from deep_vision_tpu_torch.data import gan as data
from deep_vision_tpu_torch.data import mnist
from deep_vision_tpu_torch.models import gan
from deep_vision_tpu_torch.ops.preprocess import make_gan_preprocess
from deep_vision_tpu_torch.tasks.gan import CycleGANTask, DCGANTask


def _idx_root(tmp_path, n=40, gz=False):
    rng = np.random.default_rng(0)
    root = str(tmp_path / "mnist")
    os.makedirs(root, exist_ok=True)
    mnist.write_idx(root, "train", rng.integers(0, 256, (n, 28, 28),
                                                np.uint8),
                    rng.integers(0, 10, n).astype(np.uint8), gz=gz)
    return root


@pytest.mark.parametrize("source", ["idx", "idx_gz", "synthetic"])
@pytest.mark.parametrize("device_normalize", [False, True])
def test_mnist_gan_data_matches_reference(source, device_normalize,
                                          tmp_path):
    root = None if source == "synthetic" else \
        _idx_root(tmp_path, gz=source == "idx_gz")
    want = jdata.mnist_gan_data(root, n_synthetic=48,
                                device_normalize=device_normalize)
    got = data.mnist_gan_data(root, n_synthetic=48,
                              device_normalize=device_normalize)
    assert got.dtype == want.dtype == (np.uint8 if device_normalize
                                       else np.float32)
    assert got.shape[1:] == (28, 28, 1)
    np.testing.assert_array_equal(got, want)


def test_mnist_gan_data_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no MNIST idx images"):
        data.mnist_gan_data(str(tmp_path))


def test_gan_loader_batches_match_reference():
    images = jdata.mnist_gan_data(None, n_synthetic=70)
    ref, port = jdata.GANLoader(images, 16, seed=3), \
        data.GANLoader(images, 16, seed=3)
    assert len(port) == len(ref) == 4
    for epoch in (1, 2):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])


@pytest.mark.parametrize("device_normalize", [False, True])
def test_unpaired_data_and_loader_match_reference(device_normalize):
    a, b = data.synthetic_unpaired(7, 16, seed=2,
                                   device_normalize=device_normalize)
    ja, jb = jdata.synthetic_unpaired(7, 16, seed=2,
                                      device_normalize=device_normalize)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    ref = jdata.UnpairedLoader(ja, jb[:5], 2, seed=4)
    port = data.UnpairedLoader(a, b[:5], 2, seed=4)
    assert len(port) == len(ref) == 2
    for epoch in (1, 2):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        for g, w in zip(port, ref):
            assert set(g) == {"image_a", "image_b"}
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


def test_to_uint8_wire_matches_reference():
    x = np.linspace(-1.2, 1.2, 2001, dtype=np.float32)
    x = np.concatenate([x, (np.arange(256, dtype=np.float32) + 0.5)
                        / 127.5 - 1.0])
    np.testing.assert_array_equal(data.to_uint8_wire(x),
                                  jdata.to_uint8_wire(x))


def test_make_gan_preprocess_matches_reference():
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (2, 8, 8, 1), np.uint8),
             "image_a": np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1),
             "image_b": rng.integers(0, 256, (2, 8, 8, 3), np.uint8),
             "pool_a2b": rng.standard_normal((2, 8, 8, 3)).astype(
                 np.float32),
             "pool_valid": np.ones((), np.float32)}
    want = jax_gan_preprocess()({k: jnp.asarray(v) for k, v in
                                 batch.items()}, None, True)
    got = make_gan_preprocess()({k: torch.from_numpy(np.asarray(v)) for k, v
                                 in batch.items()}, None, True)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["pool_a2b"] is not None and \
        got["pool_valid"].dtype == torch.float32


def _small_cyclegan_task():
    return CycleGANTask(lambda: gan.CycleGANGenerator(2),
                        gan.PatchGANDiscriminator)


def _digest(states) -> dict:
    out = {}
    for n, st in states.items():
        sd = st.model.state_dict()
        opt = st.opt.state_dict()
        out[n] = [sd[k].clone() for k in sorted(sd)] + \
            [opt["mu"][k].clone() for k in sorted(opt["mu"])] + \
            [opt["nu"][k].clone() for k in sorted(opt["nu"])] + \
            [opt["count"].clone()]
    return out


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        len(a[n]) == len(b[n]) and all(torch.equal(x, y) for x, y in
                                       zip(a[n], b[n])) for n in a)


@pytest.mark.parametrize("name", ["dcgan", "cyclegan"])
def test_fit_checkpoint_resume(name, tmp_path):
    """Two epochs (the recipes checkpoint every 2), then a resumed third
    from that checkpoint with every network's weights, BN statistics,
    Adam state and the scheduler; a resumed CycleGAN starts with empty
    pools, as the reference's does."""
    cfg = get_config(name)
    if name == "dcgan":
        cfg.batch_size = 8
        images = data.mnist_gan_data(None, n_synthetic=32,
                                     device_normalize=True)
        loader = data.GANLoader(images, cfg.batch_size, seed=cfg.seed)
        make = lambda: DCGANTask(gan.DCGANGenerator,  # noqa: E731
                                 gan.DCGANDiscriminator, opt=cfg.optimizer)
    else:
        a, b = data.synthetic_unpaired(4, 32, device_normalize=True)
        loader = data.UnpairedLoader(a, b, 1, seed=cfg.seed)
        make = _small_cyclegan_task
    work = str(tmp_path / "w")
    trainer = AdversarialTrainer(cfg, make(), workdir=work,
                                 preprocess_fn=make_gan_preprocess(),
                                 device="cpu")
    states = trainer.fit(loader, epochs=2)
    steps = 2 * len(loader)
    assert all(st.step == steps and int(st.bad_steps) == 0
               for st in states.values())
    ckpt = Checkpointer(os.path.join(work, "checkpoints"))
    assert ckpt.all_steps() == [steps]
    saved = _digest(states)
    if name == "cyclegan":
        assert len(trainer.task.pool_a2b.pool) == steps - 1
    resumed = AdversarialTrainer(cfg, make(), workdir=work,
                                 preprocess_fn=make_gan_preprocess(),
                                 device="cpu")
    seen = {}
    original = resumed.maybe_resume

    def spy(st):
        st = original(st)
        seen.update(digest=_digest(st), epoch=resumed.start_epoch,
                    sched=resumed.scheduler.state_dict())
        return st

    resumed.maybe_resume = spy
    out = resumed.fit(loader, epochs=3, resume=True)
    assert seen["epoch"] == 3 and _same(seen["digest"], saved)
    assert seen["sched"] == trainer.scheduler.state_dict()
    if name == "cyclegan":
        assert len(resumed.task.pool_a2b.pool) == len(loader) - 1
    assert all(st.step == 3 * len(loader) for st in out.values())
    assert ckpt.all_steps() == [steps]  # epoch 3 is no multiple of 2
    losses = [v for k, s in resumed.logger.history.items()
              if k.endswith("loss") for v in s["values"]]
    assert losses and np.isfinite(losses).all()


def test_trainer_refuses_scan_steps(tmp_path):
    """scan_steps below 1 is refused; DCGAN accepts K > 1 and trains in
    groups (tests/test_torch_scan_steps.py holds K = 2 against K = 1)."""
    cfg = get_config("dcgan")
    cfg.scan_steps = 0
    with pytest.raises(ValueError, match="scan_steps"):
        AdversarialTrainer(cfg, DCGANTask(gan.DCGANGenerator,
                                          gan.DCGANDiscriminator),
                           workdir=str(tmp_path), device="cpu")
    cfg.scan_steps = 4
    trainer = AdversarialTrainer(cfg, DCGANTask(gan.DCGANGenerator,
                                                gan.DCGANDiscriminator),
                                 workdir=str(tmp_path), device="cpu")
    assert trainer.task.scan_safe and trainer.config.scan_steps == 4


def test_linear_decay_reaches_every_optimizer(tmp_path):
    """CycleGAN's learning rate, constant for ``decay_start`` epochs and
    then linear to 0, is set on all four optimizers each epoch, and it
    is the reference's schedule."""
    cfg = get_config("cyclegan")
    cfg.scheduler.kwargs = dict(total_epochs=4, decay_start=1)
    a, b = data.synthetic_unpaired(2, 32, device_normalize=True)
    trainer = AdversarialTrainer(cfg, _small_cyclegan_task(),
                                 workdir=str(tmp_path), device="cpu")
    states = trainer.init_states()
    seen = []

    def hook(epoch, states=states):
        seen.append([st.opt.get_learning_rate() for st in states.values()])

    loader = data.UnpairedLoader(a, b, 1)
    set_epoch = loader.set_epoch
    loader.set_epoch = lambda e: (hook(e), set_epoch(e))
    trainer.fit(loader, epochs=4, states=states)
    ref = jax_scheduler("linear_decay", 2e-4, total_epochs=4, decay_start=1)
    port = build_scheduler("linear_decay", 2e-4, total_epochs=4,
                           decay_start=1)
    want = [ref.epoch_begin(e) for e in range(1, 5)]
    assert [port.epoch_begin(e) for e in range(1, 5)] == want
    assert want[0] == want[1] > want[2] > want[3] > 0
    assert seen == [[np.float32(w).item()] * 4 for w in want]


def test_cli_trains_dcgan_and_resumes(tmp_path, capsys):
    work = str(tmp_path / "w")
    argv = ["-m", "dcgan", "--synthetic", "--synthetic-size", "48",
            "--batch-size", "16", "--workdir", work, "--device", "cpu"]
    assert cli.main(argv + ["--epochs", "2"]) == 0
    assert Checkpointer(os.path.join(work, "checkpoints")).all_steps() == [6]
    assert cli.main(argv + ["--epochs", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[resume] adversarial start_epoch=3 step=6" in out
    assert "done: trained generator, discriminator" in out


def test_cli_dcgan_reads_idx_files(tmp_path, capsys):
    root = _idx_root(tmp_path, n=32)
    assert cli.main(["-m", "dcgan", "--data-root", root, "--batch-size",
                     "16", "--epochs", "1", "--workdir",
                     str(tmp_path / "w"), "--device", "cpu"]) == 0
    assert "Epoch 1 Step 2 " in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--data-root"):
        cli.main(["-m", "dcgan", "--workdir", str(tmp_path / "x"),
                  "--device", "cpu"])


def _unpaired_dirs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    dirs = []
    for tag, n in (("a", 3), ("b", 4)):
        d = tmp_path / f"train{tag.upper()}"
        d.mkdir()
        for i in range(n):
            img = rng.integers(0, 256, (20 + 3 * i, 26, 3), np.uint8)
            ext = "png" if i % 2 else "jpg"
            Image.fromarray(img).save(d / f"{i}.{ext}")
        dirs.append(str(d))
    return dirs


def test_unpaired_records_from_reference_prep(tmp_path):
    """Shards written by the JAX ``prepare_unpaired`` (encoded JPEG and
    PNG payloads) decode and resize in the port as in the reference."""
    from deep_vision_tpu.cli.train import _load_unpaired_records
    from deep_vision_tpu.data.prep import prepare_unpaired

    dir_a, dir_b = _unpaired_dirs(tmp_path)
    out = str(tmp_path / "records")
    assert prepare_unpaired(dir_a, dir_b, out, num_shards=2,
                            num_workers=1) == (3, 4)
    got = cli.load_unpaired_records(out, 16)
    want = _load_unpaired_records(out, 16, device_normalize=True)
    for g, w, n in zip(got, want, (3, 4)):
        assert g.shape == (n, 16, 16, 3) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError, match="train_a"):
        cli.load_unpaired_records(str(tmp_path), 16)


def test_unpaired_records_without_pil_name_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        cli.load_unpaired_records(str(tmp_path), 16)
