"""``--grad-accum`` and ``--ema-decay`` composed with the pipeline on the
CPU: one SGD trainer step of the port's pipelined Stacked Hourglass (two
stages over ``pipe=2``, two microbatches) with ``grad_accum_steps=2`` and
``ema_decay=0.9`` against the reference's order of splits from the same
seeded weights (tests/_torch_pipe.py): the batch of 8 splits interleaved
into two parts (rows ``a, a+2, …``), each part runs the pipeline in two
contiguous microbatches through the reference's ``PipelinedModel``
(``jax.value_and_grad``, the statistics threaded from part to part), the
update is ``p − lr·(g₁ + g₂)/2``, and the EMA moves by
``min(0.9, 2/11)`` from the start.  The loss within 1e-5 relative; the
update of the parameters, that of the BatchNorm statistics and the
EMA's move each within 1e-3 of its L2 norm; a contiguous first split
(the pipeline's own) misses the parameters' bound."""

import functools
import tempfile

import numpy as np

import jax
import jax.numpy as jnp

import _torch_pipe as tpp
from deep_vision_tpu.parallel.pipelined import (
    PipelinedModel as JaxPipelinedModel,
)
from deep_vision_tpu.tasks.pose import PoseTask as JaxPoseTask
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core import trainer as trainer_mod
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.tasks.pose import PoseTask

BATCH, LR, STACKS, PIPE, MICRO, ACCUM, DECAY = 8, 1e-2, 2, 2, 2, 2, 0.9


@functools.cache
def _want():
    jmono, _ = tpp.hourglass(STACKS)
    jpm = JaxPipelinedModel.for_model(jmono, tpp.jax_mesh(1, PIPE), MICRO)
    v = tpp.variables("hourglass", STACKS)[0]
    task = JaxPoseTask()

    def loss_fn(params, stats, b):
        out, upd = jpm.apply({"params": params, "batch_stats": stats},
                             b["image"], train=True, mutable=["batch_stats"])
        return task.loss(out, b)[0], upd["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    batch = tpp.pose_batch(BATCH)
    stats, losses, gsum = v["batch_stats"], [], None
    for a in range(ACCUM):
        part = {k: jnp.asarray(x[a::ACCUM]) for k, x in batch.items()}
        (loss, stats), g = step(v["params"], stats, part)
        losses.append(float(loss))
        gsum = g if gsum is None else jax.tree_util.tree_map(
            jnp.add, gsum, g)
    params = jax.tree_util.tree_map(
        lambda p, g: np.asarray(p - LR * (g / ACCUM)), v["params"], gsum)
    d = np.float32(min(DECAY, 2.0 / 11.0))
    ema = jax.tree_util.tree_map(
        lambda e, p: np.asarray(d * e + (np.float32(1) - d) * p),
        v["params"], params)
    pm = tpp.port_pipelined("hourglass", STACKS, tpp.port_mesh(1, PIPE))
    stats = jax.tree_util.tree_map(np.asarray, stats)
    return (float(np.mean(np.float32(losses))),
            convert.pipelined_from_flax({"params": params,
                                         "batch_stats": stats}, pm),
            convert.pipelined_from_flax({"params": ema,
                                         "batch_stats": stats}, pm),
            tpp.numpy_sd(pm))


def _port_step():
    pm = tpp.port_pipelined("hourglass", STACKS, tpp.port_mesh(1, PIPE),
                            MICRO)
    cfg = tpp.train_config("hourglass", LR, BATCH, grad_accum_steps=ACCUM,
                           ema_decay=DECAY)
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(cfg, pm, PoseTask(), workdir=work, device="cpu",
                          mesh=pm.mesh)
        state = trainer.state_for(pm)
        state, m = trainer.train_step(state, tpp.pose_batch(BATCH))
        ema = {k: v.numpy().copy() for k, v in state.ema_named().items()}
        return float(m["loss"]), tpp.numpy_sd(state.model), ema


def test_accumulated_pipelined_step_with_ema_matches_the_reference(
        monkeypatch):
    want_loss, want, want_ema, init = _want()
    loss, got, ema = _port_step()
    assert abs(loss - want_loss) <= tpp.LOSS_RTOL * abs(want_loss)
    tpp.assert_step(got, want, init)
    params = {k: want_ema[k] for k in ema}
    tpp.assert_step(ema, params, {k: init[k] for k in ema})
    # control: grad-accum split contiguous, as the pipeline splits
    monkeypatch.setattr(
        trainer_mod, "interleaved_split",
        lambda batch, parts: [{k: v.reshape(parts, -1, *v.shape[1:])[a]
                               for k, v in batch.items()}
                              for a in range(parts)])
    _, contiguous, _ = _port_step()
    errs = tpp.step_errors(contiguous, want, init)
    assert errs["params"] > tpp.STEP_BOUND, errs
