"""Pipeline parallelism composed with data parallelism on the CPU: two
gloo ranks, each holding a pipe grid of two CPU places, take one SGD
step of the pipelined Stacked Hourglass (two stages, two microbatches a
rank, a global batch of 8) against the reference's step on
``{data: 2, pipe: 2}`` from the same seeded weights
(tests/_torch_pipe.py): the loss within 1e-5 relative and the update of
the parameters within 1e-3 of its L2 norm, and apart that of the
BatchNorm statistics, on both ranks, which end bit-identical.

The two BatchNorm regimes are what this holds: the stem normalizes by
the global batch across the ranks, each stage by its microbatch of the
rank's own rows, with the stages' running statistics averaged over the
ranks after the forward.  Controls, each of which must miss the
parameters' bound: the stages normalizing across the ranks, and the
stem normalizing by the rank's rows alone."""

import functools

import _torch_pipe as tpp
from _torch_dist_worker import run_ranks
from deep_vision_tpu.tasks.pose import PoseTask as JaxPoseTask
from deep_vision_tpu_torch import convert

BATCH, LR, STACKS, PIPE, MICRO = 8, 1e-2, 2, 2, 2
ARCH = dict(num_stack=STACKS, num_heatmap=tpp.HEAT, filters=8, order=1)


@functools.cache
def _want():
    loss, after = tpp.jax_step("hourglass", STACKS, 2, PIPE, MICRO,
                               tpp.pose_batch(BATCH), LR, JaxPoseTask())
    pm = tpp.port_pipelined("hourglass", STACKS, tpp.port_mesh(1, PIPE))
    return loss, convert.pipelined_from_flax(after, pm), tpp.numpy_sd(pm)


def test_two_ranks_of_pipe_grids_match_the_reference_step():
    want_loss, want, init = _want()
    call = {"family": "hourglass", "arch": ARCH,
            "variables": tpp.variables("hourglass", STACKS)[0],
            "batches": [tpp.pose_batch(BATCH)], "lr": LR, "pipe": PIPE,
            "micro": MICRO}
    ranks = run_ranks(2, [("pipelined_steps", call),
                          ("pipelined_steps",
                           dict(call, control="stages_across_ranks")),
                          ("pipelined_steps",
                           dict(call, control="stem_local"))])
    for rank in ranks:
        got = rank[0]
        loss = got["metrics"][0]["loss"]
        assert abs(loss - want_loss) <= tpp.LOSS_RTOL * abs(want_loss)
        tpp.assert_step(got["state"], want, init)
        for control in rank[1:]:
            errs = tpp.step_errors(control["state"], want, init)
            assert errs["params"] > tpp.STEP_BOUND, errs
    for k, v in ranks[0][0]["state"].items():
        assert (v == ranks[1][0]["state"][k]).all(), k
