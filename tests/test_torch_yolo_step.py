"""One YOLOv3 train step of the port's Trainer against the JAX reference,
on the CPU at the ``yolov3_toy`` size (width 0.125, one residual block
per stage, 3 classes, 64×64, batch 8, float32), from the same seeded
weights (every BatchNorm scale non-zero) and batch.

The reference's loss runs its Pallas ``best_iou_max`` in interpret mode
(``YoloTask(use_pallas=True)``) under ``jax.value_and_grad`` as its
Trainer builds it; the port's runs the plain version of its CUDA kernel
inside ``Trainer.train_step``, whose gradients are read where they reach
the optimizer.  Gradients and not the Adam update are compared: Adam's
first update is lr·sign(g) on every element, so a parameter whose
gradient is at rounding level moves by ±lr on either side.

Bounds, with what they rest on: float32 sums run in other orders through
some 75 convolutions and BatchNorms, and a leaky-ReLU gate that rounding
flips changes its element's gradient tenfold.  Measured on the CPU: the
port against the reference reads 8.5e-6 relative on the loss, 1.6e-5 on
the worst per-scale component, 1.0e-3 on the gradients in L2 over the
model and 2.1e-2 on the worst tensor; the reference against itself with
the input moved by 1e-7 reads 9e-7, 2.8e-6, 1.6e-4 and 5.4e-4, and with
one pixel moved by one grey level 2.5e-5 on the loss.  The bounds: loss
and components 1e-4 relative, gradients 5e-3 in L2 and 1e-1 per tensor.
The same step with each image's ground-truth boxes handed to the ignore
mask of the next image must break the loss bound.
"""

import functools
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

import _torch_yolo as ty
from deep_vision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deep_vision_tpu.ops.preprocess import (
    make_scale_preprocess as jax_make_scale_preprocess,
)
from deep_vision_tpu.tasks.detection import YoloTask as JaxYoloTask
from deep_vision_tpu_torch import convert

def _grads_to_flax(model, grads):
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    sd.update(dict(zip(names, grads)))
    return convert.flatten_tree(
        convert.yolo_to_flax(sd, ty.TOY["blocks"])["params"])


@functools.cache
def _jax_step_one():
    """The reference's loss, aux and gradients for batch 0, as its Trainer
    computes them (train-mode apply, batch statistics mutable)."""
    model = JaxYoloV3(**ty.TOY)
    task = JaxYoloTask(3, use_pallas=True)
    variables = ty.variables()
    batch = jax_make_scale_preprocess()(
        {k: jnp.asarray(v) for k, v in ty.batches()[0].items()}, None, True)

    @jax.jit
    def value_and_grad(params):
        def loss_fn(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                batch["image"], train=True, mutable=["batch_stats"])
            return task.loss(out, batch)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (loss, aux), grads = value_and_grad(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    return float(loss), {k: float(v) for k, v in aux.items()}, \
        convert.flatten_tree(jax.tree_util.tree_map(np.asarray, grads))


def _port_step(batch):
    """The port's loss metrics and the gradients its optimizer got."""
    with tempfile.TemporaryDirectory() as work:
        trainer, state = ty.port_trainer(work)
        seen = {}
        apply = state.apply_gradients_if_finite

        def spy(loss, grads, stats_before):
            seen["grads"] = [g.clone() for g in grads]
            return apply(loss, grads, stats_before)

        state.apply_gradients_if_finite = spy
        state, m = trainer.train_step(state, batch)
    return ({k: float(v) for k, v in m.items()},
            _grads_to_flax(state.model, seen["grads"]))


def _loss_faults(got: dict, loss: float, aux: dict) -> list:
    faults = [k for k, v in aux.items()
              if abs(got[k] - v) > 1e-4 * max(abs(v), 1e-2)]
    if abs(got["loss"] - loss) > 1e-4 * abs(loss):
        faults.append("loss")
    return faults


def test_one_step_loss_and_gradients_match_jax():
    want_loss, want_aux, want_grads = _jax_step_one()
    got, grads = _port_step(ty.batches()[0])
    assert not _loss_faults(got, want_loss, want_aux)
    # the ignore mask acts (at 64² the small-anchor scale 0 may not
    # reach IoU 0.5 with these 0.15-0.5 wide boxes)
    assert sum(got[f"ignored_{s}"] for s in range(3)) > 0, got
    assert set(grads) == set(want_grads)
    num = sum(float(np.sum((grads[k] - w) ** 2))
              for k, w in want_grads.items())
    den = sum(float(np.sum(w ** 2)) for w in want_grads.values())
    per = {k: float(np.linalg.norm(grads[k] - w)
                    / max(np.linalg.norm(w), 1e-30))
           for k, w in want_grads.items()}
    assert (num / den) ** 0.5 <= 5e-3, (num / den) ** 0.5
    assert max(per.values()) <= 1e-1, max(per.items(), key=lambda kv: kv[1])
    # control: each image's boxes given to the next image's ignore mask
    rolled = dict(ty.batches()[0])
    for k in ("boxes", "boxes_mask"):
        rolled[k] = np.roll(rolled[k], 1, axis=0)
    wrong, _ = _port_step(rolled)
    assert _loss_faults(wrong, want_loss, want_aux)
