"""One trainer step of the port's pipelined CenterNet against the
reference's, on the CPU: two order-2 stacks over ``pipe=2`` (two CPU
places; the reference on ``{data: 1, pipe: 2}``), two contiguous
microbatches of a batch of 8 seeded synthetic scenes (the Queue 3 trap:
at batch 2 the 1×1 bottom BatchNorm of the hourglass makes the step
chaotic), plain SGD, from the same seeded weights (tests/_torch_pipe.py);
the loss and its components within 1e-5 relative, the update of the
parameters within 1e-3 of its L2 norm and apart that of the BatchNorm
statistics, and the port at one microbatch (whole-batch statistics in
the stages) missing the parameters' bound."""

import functools
import tempfile

import _torch_pipe as tpp
from deep_vision_tpu.tasks.centernet import CenterNetTask as JaxCenterNetTask
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.tasks.centernet import CenterNetTask

BATCH, LR, STACKS, PIPE, MICRO = 8, 1e-2, 2, 2, 2


@functools.cache
def _want():
    return tpp.jax_step("centernet", STACKS, 1, PIPE, MICRO,
                        tpp.centernet_batch(BATCH), LR,
                        JaxCenterNetTask(tpp.CLASSES))


def _port_step(micro: int):
    pm = tpp.port_pipelined("centernet", STACKS, tpp.port_mesh(1, PIPE),
                            micro)
    init = tpp.numpy_sd(pm)
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(tpp.train_config("centernet", LR, BATCH), pm,
                          CenterNetTask(tpp.CLASSES), workdir=work,
                          device="cpu", mesh=pm.mesh)
        state = trainer.state_for(pm)
        state, m = trainer.train_step(state, tpp.centernet_batch(BATCH))
        assert int(state.bad_steps) == 0
        return {k: float(v) for k, v in m.items()}, \
            tpp.numpy_sd(state.model), init


def test_pipelined_centernet_step_matches_the_reference_step():
    want_loss, after = _want()
    metrics, got, init = _port_step(MICRO)
    assert abs(metrics["loss"] - want_loss) <= \
        tpp.LOSS_RTOL * abs(want_loss)
    assert {f"heat_{s}" for s in range(STACKS)} <= set(metrics)
    pm = tpp.port_pipelined("centernet", STACKS, tpp.port_mesh(1, PIPE))
    want = convert.pipelined_from_flax(after, pm)
    tpp.assert_step(got, want, init)
    _, whole, _ = _port_step(1)
    errs = tpp.step_errors(whole, want, init)
    assert errs["params"] > tpp.STEP_BOUND, errs
