"""Two YOLOv3 steps of the port's Trainer against two of the JAX
Trainer, on the CPU at the ``yolov3_toy`` size (width 0.125, one residual
block per stage, 3 classes, 64×64, batch 8, float32; Adam lr 1e-3 with
global-norm clipping at 10), from the same seeded weights and batches.
The reference runs its Pallas ``best_iou_max`` in interpret mode.

Bounds: the first loss within 1e-4 relative (as in
tests/test_torch_yolo_step.py).  The second within 1e-2 relative:
Adam's first update is lr·sign(g) on every element, so the gradient's
rounding noise flips whole elements by 2·lr, and the reference moves
its own second loss by 4.5e-3 when one pixel of the first batch moves by
one grey level (measured on the CPU; the port reads 1.7e-3).  A port run
at twice the learning rate must break that bound.
"""

import tempfile

import numpy as np

import jax
import jax.numpy as jnp

import _torch_yolo as ty
from deep_vision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deep_vision_tpu.core.config import TrainConfig as JaxTrainConfig
from deep_vision_tpu.core.trainer import Trainer as JaxTrainer
from deep_vision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deep_vision_tpu.ops.preprocess import (
    make_scale_preprocess as jax_make_scale_preprocess,
)
from deep_vision_tpu.parallel import make_mesh, replicate
from deep_vision_tpu.tasks.detection import YoloTask as JaxYoloTask


def _jax_two_steps():
    jm = JaxYoloV3(**ty.TOY)
    cfg = JaxTrainConfig(
        name="parity", model=lambda: jm, task="detection",
        batch_size=ty.BATCH, image_size=ty.SIZE, num_classes=3,
        optimizer=JaxOptimizerConfig(name="adam", learning_rate=ty.LR,
                                     grad_clip_norm=10.0))
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    variables = ty.variables()
    with tempfile.TemporaryDirectory() as work:
        trainer = JaxTrainer(cfg, jm, JaxYoloTask(3, use_pallas=True),
                             mesh=mesh, workdir=work,
                             preprocess_fn=jax_make_scale_preprocess())
        batches = ty.batches()
        state = trainer.init_state(batches[0])
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = replicate(state.replace(
            params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]),
            opt_state=trainer.tx.init(params)), mesh)
        losses = []
        for b in batches:
            state, m = trainer.train_step(state, {k: np.array(v)
                                                  for k, v in b.items()})
            losses.append(float(m["loss"]))
    return losses


def _port_two_steps(lr=ty.LR):
    with tempfile.TemporaryDirectory() as work:
        trainer, state = ty.port_trainer(work)
        state.opt.set_learning_rate(lr)
        losses = []
        for b in ty.batches():
            state, m = trainer.train_step(state, b)
            losses.append(float(m["loss"]))
        assert int(state.bad_steps) == 0 and int(state.opt.count) == 2
    return losses


def test_two_trainer_steps_match_jax_trainer():
    want = _jax_two_steps()
    got = _port_two_steps()
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    assert abs(got[1] - want[1]) <= 1e-2 * abs(want[1])
    # control: twice the learning rate breaks the second step's bound
    fast = _port_two_steps(2 * ty.LR)
    assert abs(fast[1] - want[1]) > 1e-2 * abs(want[1]), (fast, want)
