"""The classifier zoo's training pieces in the port against the JAX
reference: ``RMSprop`` (deep_vision_tpu_torch/core/optim.py) against
``optax.rmsprop`` through the reference's ``build_optimizer``, the
aux-head loss (tasks/classification.py), the zoo configs
(zoo/classifiers.py, zoo/lenet.py, zoo/resnet.py), MNIST
(data/mnist.py, ops/preprocess.make_mnist_preprocess), the dropout's
draw and the trainer's dropout generator, and ``cli.train -m lenet5 --device
cpu`` with a resume.

Tolerances: RMSprop's parameters within 2e-7 of their scale over 6
steps (float32; ``rsqrt`` and the products round alike up to one ulp,
measured at most 1 ulp), and a state_dict round trip mid-run continues
bit for bit; the aux-head loss and its gradients within 1e-4·max
(measured 1e-7); configs, ``load_mnist`` and ``make_mnist_preprocess``
exactly; the dropout's keep share within 5 standard errors of
``1 − rate``; the resumed lenet5 run equal to the unbroken one bit for
bit.
"""

import dataclasses
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.optim import OptimizerConfig as JaxOptimizerConfig
from deep_vision_tpu.core.optim import build_optimizer as jax_build_optimizer
from deep_vision_tpu.core.optim import set_learning_rate
from deep_vision_tpu.data import mnist as jax_mnist
from deep_vision_tpu.ops.preprocess import (
    make_mnist_preprocess as jax_mnist_preprocess,
)
from deep_vision_tpu.tasks.classification import (
    ClassificationTask as JaxClassificationTask,
)
from deep_vision_tpu_torch.cli import train as cli_train
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.data import mnist
from deep_vision_tpu_torch.models.common import Dropout
from deep_vision_tpu_torch.models.mobilenet import MobileNetV1
from deep_vision_tpu_torch.ops.preprocess import make_mnist_preprocess
from deep_vision_tpu_torch.tasks.classification import ClassificationTask

ZOO = ("alexnet1", "alexnet2", "vgg16", "vgg19", "inception1",
       "inception3", "mobilenet1", "shufflenet1", "resnet50v2",
       "resnet50_modern", "lenet5_nano", "lenet5", "lenet5_big")


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 4)
        self.scale = torch.nn.Parameter(torch.ones(4))


def _rmsprop_pair(momentum=0.9):
    kw = dict(name="rmsprop", learning_rate=0.045, rms_decay=0.9, eps=1.0,
              momentum=momentum, weight_decay=1e-4)
    net = _Net()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.normal_()
    opt = build_optimizer(OptimizerConfig(**kw), net)
    params = {n: jnp.asarray(p.detach().numpy().copy())
              for n, p in net.named_parameters()}
    tx = jax_build_optimizer(JaxOptimizerConfig(**kw))
    return net, opt, params, tx


def _grads(net, step):
    rng = np.random.RandomState(step)
    return {n: (rng.randn(*p.shape) * 3).astype(np.float32)
            for n, p in net.named_parameters()}


def test_rmsprop_matches_optax_with_resume():
    """eps 1.0 inside the root, the momentum trace over lr-scaled
    updates (a learning-rate change at step 3 shows it), no weight decay
    (the reference's rmsprop branch ignores ``weight_decay``)."""
    net, opt, params, tx = _rmsprop_pair()
    state = tx.init(params)
    ok = torch.tensor(True)
    for step in range(6):
        if step == 3:
            opt.set_learning_rate(0.02)
            state = set_learning_rate(state, 0.02)
        g = _grads(net, step)
        opt.step([torch.from_numpy(g[n]) for n in opt.names], ok)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        for n, p in net.named_parameters():
            ref = np.asarray(params[n])
            np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                       atol=2e-7 * np.abs(ref).max())
        if step == 2:
            # a state_dict round trip mid-run continues bit for bit
            twin = _Net()
            twin.load_state_dict(net.state_dict())
            twin_opt = build_optimizer(opt.cfg, twin)
            twin_opt.load_state_dict(opt.state_dict())
    for step in range(3, 6):
        if step == 3:
            twin_opt.set_learning_rate(0.02)
        g = _grads(net, step)
        twin_opt.step([torch.from_numpy(g[n]) for n in twin_opt.names], ok)
    for (_, a), (_, b) in zip(net.named_parameters(),
                              twin.named_parameters()):
        assert torch.equal(a, b)
    for key in ("nu", "trace"):
        assert all(torch.equal(a, b) for a, b in
                   zip(getattr(opt, key), getattr(twin_opt, key)))


def test_rmsprop_skipped_step_keeps_state():
    net, opt, _, _ = _rmsprop_pair()
    before = [p.detach().clone() for p in net.parameters()]
    g = _grads(net, 0)
    opt.step([torch.from_numpy(g[n]) for n in opt.names],
             torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    assert all(not t.any() for t in opt.nu + opt.trace)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_aux_head_loss_and_gradients_match_reference(smoothing):
    rng = np.random.RandomState(0)
    heads = [rng.randn(6, 10).astype(np.float32) * 3 for _ in range(3)]
    labels = rng.randint(0, 10, 6).astype(np.int32)
    jt = JaxClassificationTask(10, smoothing)

    def jloss(hs):
        return jt.loss(tuple(hs), {"label": jnp.asarray(labels)})[0]

    want, want_g = jax.value_and_grad(jloss)([jnp.asarray(h) for h in heads])
    ts = [torch.from_numpy(h).requires_grad_() for h in heads]
    task = ClassificationTask(10, smoothing)
    loss, aux = task.loss(tuple(ts), {"label": torch.from_numpy(labels)})
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-4 * abs(float(want))
    for t, g in zip(ts, want_g):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max())
    # top-1 and eval read the main head only
    assert float(aux["top1"]) == np.float32(
        np.mean(heads[0].argmax(-1) == labels))
    sums = task.eval_metrics(tuple(torch.from_numpy(h) for h in heads),
                             {"label": torch.from_numpy(labels)})
    main = task.eval_metrics(torch.from_numpy(heads[0]),
                             {"label": torch.from_numpy(labels)})
    assert all(torch.equal(sums[k], main[k]) for k in sums)


def _model_dtype(cfg):
    with torch.device("meta"):
        return cfg.model().compute_dtype


@pytest.mark.parametrize("name", ZOO)
def test_zoo_config_matches_reference(name):
    cfg, ref = get_config(name), jax_get_config(name)
    for field in ("name", "task", "batch_size", "eval_batch_size",
                  "total_epochs", "label_smoothing", "half_precision",
                  "image_size", "channels", "num_classes", "seed",
                  "scan_steps", "grad_accum_steps", "ema_decay"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert dataclasses.asdict(cfg.optimizer) == \
        dataclasses.asdict(ref.optimizer)
    assert cfg.scheduler.name == ref.scheduler.name
    assert cfg.scheduler.kwargs == ref.scheduler.kwargs
    want = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[
        ref.model().dtype]
    assert _model_dtype(cfg) == want


def _images(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 28, 28)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.uint8))


@pytest.mark.parametrize("naming", ["raw", "gz", "idx"])
def test_load_mnist_matches_reference(tmp_path, naming):
    for split, n in (("train", 40), ("test", 12)):
        images, labels = _images(n, seed=n)
        for path in mnist.write_idx(str(tmp_path), split, images, labels,
                                    gz=naming == "gz"):
            if naming == "idx":
                shutil.move(path, path.replace("-idx", ".idx"))
    for split in ("train", "test"):
        for dev in (False, True):
            got = mnist.load_mnist(str(tmp_path), split, device_normalize=dev)
            want = jax_mnist.load_mnist(str(tmp_path), split,
                                        device_normalize=dev)
            for k in ("image", "label"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    images, _ = _images(12, seed=12)
    raw = mnist.load_idx_images(mnist.mnist_paths(str(tmp_path), "test")[0])
    np.testing.assert_array_equal(raw, images)
    with gzip.open(tmp_path / "bad.gz", "wb") as f:
        f.write(b"\0\0\0\1" + bytes(12))
    with pytest.raises(ValueError, match="magic"):
        mnist.load_idx_images(str(tmp_path / "bad.gz"))


def test_make_mnist_preprocess_matches_reference():
    img = np.random.RandomState(0).randint(0, 256, (5, 32, 32, 1)) \
        .astype(np.uint8)
    img[0, 0, :4, 0] = [0, 1, 254, 255]
    got = make_mnist_preprocess()({"image": torch.from_numpy(img)}, None,
                                  True)["image"]
    want = jax_mnist_preprocess()({"image": jnp.asarray(img)}, None, True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["image"]))
    floats = {"image": torch.zeros(2, 32, 32, 1)}
    assert make_mnist_preprocess()(floats, None, False) is floats


@pytest.mark.parametrize("rate", [0.001, 0.4, 0.5, 0.7])
def test_dropout_keep_rate_and_scale(rate):
    drop = Dropout(rate).train()
    drop.generator = torch.Generator().manual_seed(1)
    x = torch.full((400, 1000), 2.0)
    y = drop(x)
    kept = y != 0
    n = x.numel()
    share = float(kept.to(torch.float64).mean())
    assert abs(share - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / (1 - rate)))
    assert torch.equal(drop.eval()(x), x)
    drop.train().generator = None
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)


def test_trainer_dropout_follows_seed_and_step(tmp_path):
    """Masks are a function of (seed, step): the same step draws the same
    masks (so a resumed run repeats an unbroken one), another step
    others; eval draws none."""
    cfg = get_config("mobilenet1")
    cfg.num_classes, cfg.image_size = 10, 32
    model = MobileNetV1(alpha=0.25, num_classes=10, dropout=0.5)
    trainer = Trainer(cfg, model, ClassificationTask(10),
                      workdir=str(tmp_path), device="cpu")
    state = trainer.init_state()
    seen = []
    model.dropout.register_forward_hook(
        lambda m, i, o: seen.append((i[0].detach().clone(),
                                     o.detach().clone())))
    batch = {"image": np.random.RandomState(0).randn(4, 32, 32, 3)
             .astype(np.float32), "label": np.arange(4, dtype=np.int32)}
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.train_step(state, batch)
    model.load_state_dict(snapshot)
    state.step = 0
    trainer.train_step(state, batch)
    trainer.train_step(state, batch)
    dropped = [(i != 0) & (o == 0) for i, o in seen]
    assert torch.equal(dropped[0], dropped[1])
    assert not torch.equal(dropped[1], dropped[2])
    assert dropped[0].any()
    trainer.eval_step(state, batch)
    assert torch.equal(seen[3][0], seen[3][1])
    assert model.dropout.generator is None


def _write_mnist(root, n_train=192, n_test=40):
    os.makedirs(root, exist_ok=True)
    for split, n, seed in (("train", n_train, 1), ("test", n_test, 2)):
        mnist.write_idx(root, split, *_images(n, seed))


def _final_state(workdir):
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer

    return Checkpointer(os.path.join(workdir, "checkpoints")).load()["state"]


def test_cli_train_lenet5_on_cpu_with_resume(tmp_path, capsys):
    """Two epochs in one run equal one epoch and a resumed second, bit for
    bit (weights, Adam's moments and count, the step)."""
    data = str(tmp_path / "mnist")
    _write_mnist(data)
    common = ["-m", "lenet5", "--data-root", data, "--device", "cpu",
              "--batch-size", "32"]
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    assert cli_train.main(common + ["--workdir", whole, "--epochs", "2"]) == 0
    assert cli_train.main(common + ["--workdir", parts, "--epochs", "1"]) == 0
    assert cli_train.main(common + ["--workdir", parts, "--epochs", "2",
                                    "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step=6 start_epoch=2" in out
    assert out.count("final: loss=") == 3
    a, b = _final_state(whole), _final_state(parts)
    assert a["step"] == b["step"] == 12
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for key in ("mu", "nu"):
        for k, v in a["optimizer"][key].items():
            assert torch.equal(v, b["optimizer"][key][k]), k
    assert int(a["optimizer"]["count"]) == int(b["optimizer"]["count"]) == 12
