"""One trainer step of the port's pipelined Stacked Hourglass against the
reference's, on the CPU: four stages over ``pipe=4`` (four CPU places;
the reference on ``{data: 1, pipe: 4}`` of conftest's virtual devices),
two contiguous microbatches of a batch of 8, plain SGD, from the same
seeded weights (tests/_torch_pipe.py).  The reference's step is one
``jax.value_and_grad`` through its ``PipelinedModel.apply`` with
``p − lr·g``; the port's is ``Trainer.train_step``.

Bounds (``_torch_pipe``): the loss within 1e-5 relative, the update of
the parameters within 1e-3 of its L2 norm, and apart the update of the
BatchNorm statistics.  Controls, each of which must miss the
parameters' bound: the port at one microbatch, which normalizes each
stage by the whole batch, not by its microbatch; and the port with its
hand-offs detached, a gradient fault whose forward and statistics are
right."""

import functools
import tempfile

import numpy as np

import _torch_pipe as tpp
from deep_vision_tpu.tasks.pose import PoseTask as JaxPoseTask
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.tasks.pose import PoseTask

BATCH, LR, STACKS, PIPE, MICRO = 8, 1e-2, 4, 4, 2


@functools.cache
def _want():
    return tpp.jax_step("hourglass", STACKS, 1, PIPE, MICRO,
                        tpp.pose_batch(BATCH), LR, JaxPoseTask())


def _port_step(micro: int, detach: bool = False):
    pm = tpp.port_pipelined("hourglass", STACKS, tpp.port_mesh(1, PIPE),
                            micro)
    if detach:
        tpp.detached_hand_offs(pm)
    init = tpp.numpy_sd(pm)
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(tpp.train_config("hourglass", LR, BATCH), pm,
                          PoseTask(), workdir=work, device="cpu",
                          mesh=pm.mesh)
        state = trainer.state_for(pm)
        state, m = trainer.train_step(state, tpp.pose_batch(BATCH))
        assert int(state.bad_steps) == 0
        return float(m["loss"]), tpp.numpy_sd(state.model), init


def test_pipelined_step_matches_the_reference_step():
    want_loss, after = _want()
    loss, got, init = _port_step(MICRO)
    assert abs(loss - want_loss) <= tpp.LOSS_RTOL * abs(want_loss)
    want = convert.pipelined_from_flax(after, _port_model())
    tpp.assert_step(got, want, init)
    # the stages' statistics moved once a microbatch: twice
    k = "stages.3.bn.running_mean"
    assert not np.allclose(got[k], init[k])
    # the last stage's re-injection convs get no gradient: unchanged
    for name in ("reinject_features", "reinject_heat"):
        key = f"stages.{STACKS - 1}.{name}.weight"
        np.testing.assert_array_equal(got[key], init[key])
    # control: whole-batch statistics in the stages miss the bound
    _, whole, _ = _port_step(1)
    errs = tpp.step_errors(whole, want, init)
    assert errs["params"] > tpp.STEP_BOUND, errs
    # control: detached hand-offs keep the statistics and miss the
    # parameters' bound (later stages' losses no longer reach earlier
    # stages and the stem)
    _, cut, _ = _port_step(MICRO, detach=True)
    errs = tpp.step_errors(cut, want, init)
    assert errs["stats"] <= tpp.STEP_BOUND < errs["params"], errs


def _port_model():
    return tpp.port_pipelined("hourglass", STACKS, tpp.port_mesh(1, PIPE))
