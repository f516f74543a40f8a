"""Shared helpers of the recipe-option parity tests
(tests/test_torch_accum_ema.py, test_torch_scan_steps.py): the JAX
``Trainer`` and the port's ``Trainer`` on the same seeded weights (carried
across by deep_vision_tpu_torch/convert.py) and the same numpy batches, on
the CPU.

LeNet-5 (no BatchNorm, no dropout) with SGD (lr 0.05, momentum 0.9) is
the BN-free model: an SGD step is smooth in the gradient, so two runs
that round differently stay close (Adam's first step, about lr·sign(g),
is not).  A one-block ResNet (``_torch_port``) at 16² is the BatchNorm
model."""

import tempfile

import numpy as np

import jax
import jax.numpy as jnp

import _torch_port as tp
from deep_vision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deep_vision_tpu.core.config import TrainConfig as JaxTrainConfig
from deep_vision_tpu.core.trainer import Trainer as JaxTrainer
from deep_vision_tpu.models import lenet as j_lenet
from deep_vision_tpu.parallel import make_mesh, replicate
from deep_vision_tpu.tasks.classification import (
    ClassificationTask as JaxClassificationTask,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core import config as port_config
from deep_vision_tpu_torch.core import optim as port_optim
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.models import lenet
from deep_vision_tpu_torch.tasks.classification import ClassificationTask

CLASSES, LR, MOMENTUM = 10, 0.05, 0.9
#: the BatchNorm model: ResNet stages (1,), BasicBlock, 16² RGB
BN_STAGES, BN_SIZE = (1,), 16


def lenet_variables(seed=5):
    return tp.seeded_variables(j_lenet.LeNet5(), (32, 32, 1), seed=seed)


def bn_variables(seed=5):
    return tp.seeded_variables(tp.jax_model(BN_STAGES, "BasicBlock", CLASSES),
                               (BN_SIZE, BN_SIZE, 3), seed=seed)


def batches(n, batch, seed=0, bn=False):
    """``n`` seeded float batches (host-normalized: both trainers' lack
    of a preprocess passes them through)."""
    rng = np.random.RandomState(seed)
    shape = (BN_SIZE, BN_SIZE, 3) if bn else (32, 32, 1)
    return [{"image": rng.randn(batch, *shape).astype(np.float32),
             "label": rng.randint(0, CLASSES, batch).astype(np.int32)}
            for _ in range(n)]


def _fields(bn=False, accum=1, ema=0.0, scan=1, batch=16):
    return dict(name="recipes", batch_size=batch,
                image_size=BN_SIZE if bn else 32, channels=3 if bn else 1,
                num_classes=CLASSES, total_epochs=1, log_every_steps=1,
                grad_accum_steps=accum, ema_decay=ema, scan_steps=scan)


def jax_trainer(work, variables, bn=False, **kw):
    """(JAX Trainer, its state at ``variables``)."""
    model = tp.jax_model(BN_STAGES, "BasicBlock", CLASSES) if bn \
        else j_lenet.LeNet5()
    cfg = JaxTrainConfig(model=lambda: model, optimizer=JaxOptimizerConfig(
        name="sgd", learning_rate=LR, momentum=MOMENTUM),
        **_fields(bn, **kw))
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    trainer = JaxTrainer(cfg, model, JaxClassificationTask(CLASSES),
                         mesh=mesh, workdir=work)
    sample = batches(1, cfg.batch_size, bn=bn)[0]
    state = trainer.init_state(sample)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(
        params=params, opt_state=trainer.tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.array, params)
        if kw.get("ema") else {})
    if bn:
        state = state.replace(batch_stats=jax.tree_util.tree_map(
            jnp.asarray, variables["batch_stats"]))
    return trainer, replicate(state, mesh)


def port_model(variables, bn=False):
    if bn:
        model = tp.port_model(BN_STAGES, "BasicBlock", CLASSES)
        convert.load_into(model, variables)
    else:
        model = lenet.LeNet5()
        convert.load_classifier(model, variables)
    return model


def port_trainer(work, variables, bn=False, **kw):
    """(the port's Trainer on the CPU, its state at ``variables``)."""
    cfg = port_config.TrainConfig(
        model=(lambda: tp.port_model(BN_STAGES, "BasicBlock", CLASSES))
        if bn else lenet.LeNet5,
        optimizer=port_optim.OptimizerConfig(
            name="sgd", learning_rate=LR, momentum=MOMENTUM),
        **_fields(bn, **kw))
    model = port_model(variables, bn)
    trainer = Trainer(cfg, model, ClassificationTask(CLASSES), workdir=work,
                      device="cpu")
    return trainer, trainer.state_for(model)


def to_port(tree, bn=False, model=None):
    """A flax ``{"params": ..., ["batch_stats": ...]}`` tree → the port's
    ``state_dict`` (numpy)."""
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    if bn:
        return convert.flax_to_torch(tree, stage_sizes=BN_STAGES,
                                     block="BasicBlock")
    return convert.classifier_from_flax(tree, model or lenet.LeNet5())


def jax_steps(variables, data, bn=False, **kw):
    """The JAX Trainer's steps over ``data``: (metrics a step, the final
    host state)."""
    with tempfile.TemporaryDirectory() as work:
        trainer, state = jax_trainer(work, variables, bn, **kw)
        metrics = []
        for b in data:
            state, m = trainer.train_step(state, {k: np.array(v)
                                                  for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, jax.device_get(state)


def numpy_sd(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def rel_l2(got: dict, want: dict, keys=None) -> float:
    """‖got − want‖ / ‖want‖ over ``keys`` (default: all of ``want``)."""
    keys = list(keys if keys is not None else want)
    num = sum(float(np.sum((np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)) ** 2))
              for k in keys)
    den = sum(float(np.sum(np.asarray(want[k], np.float64) ** 2))
              for k in keys)
    return (num / max(den, 1e-30)) ** 0.5
