"""Data-parallel training of the port (``parallel/``, ``core/trainer.py``
under a mesh, cross-rank BatchNorm in ``models/common.py``) against the
JAX ``Trainer`` on a ``{"data": 2}`` mesh of two of conftest's virtual
CPU devices.  The port runs as two gloo ranks on the CPU
(``tests/_torch_dist_worker.py``), each fed the rows of the global batch
that the reference's ``shard_batch`` puts on its device.

The model is the one-stage-a-level bottleneck ResNet of
tests/test_torch_train.py (32², 10 classes, SGD lr 0.1, momentum 0.9,
weight decay 1e-4), global batch 8 (4 a rank), float32 images, the last
BatchNorm scale of every block at 1e-2 (a one-step check from non-zero
last scales, so every residual branch trains).

Bounds, each with its reason and a control that must fail it:

- One step: the loss within 1e-5 relative; the update of the parameters
  and running statistics within 1e-4 of its L2 norm over the model
  (two ranks sum the statistics and gradients in another order than
  XLA; measured 1.7e-6).  Control: the same two ranks with rank-local
  BatchNorm statistics (the layers' mesh taken away) miss the update
  bound by orders of magnitude (they read 0.51).
- ``grad_accum_steps = 2`` under the mesh: the same bounds (each
  device's microbatch is the interleaved split of its own rows, and the
  statistics are the global microbatch's).
- Both ranks' weights are bit-identical after every step; a group of
  one rank is bit-identical to no group at all (same thread count, same
  code); a NaN shard on one rank skips the step on both.
- Eval: loss, top-1, top-5 and count sums all-reduced, within 1e-5
  relative of the reference's mesh ``evaluate``.
- A SIGTERM that reaches one rank stops both at the same step boundary
  with one checkpoint.
- A checkpoint written by rank 0 alone (the other rank writes nothing)
  resumes at world sizes 1 and 2 to the saved weights bit for bit; the
  two resumed runs' next epoch agree within 1e-5 relative in L2 (one
  process on the global batch against two ranks on its halves).
"""

import functools
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
import jax.numpy as jnp

import _torch_port as tp
from _torch_dist_worker import run_ranks
from deep_vision_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deep_vision_tpu.core.config import TrainConfig as JaxTrainConfig
from deep_vision_tpu.core.trainer import Trainer as JaxTrainer
from deep_vision_tpu.parallel import make_mesh, replicate
from deep_vision_tpu.tasks.classification import (
    ClassificationTask as JaxClassificationTask,
)
from deep_vision_tpu_torch import convert

STAGES, BLOCK, CLASSES, SIZE, BATCH, LR = (1, 1, 1, 1), "BottleneckBlock", \
    10, 32, 8, 0.1
LOSS_BOUND, UPDATE_BOUND, EVAL_BOUND = 1e-5, 1e-4, 1e-5


@functools.cache
def _variables():
    v = tp.seeded_variables(tp.jax_model(STAGES, BLOCK, CLASSES),
                            (SIZE, SIZE, 3))
    for name, block in v["params"].items():
        if name.startswith(BLOCK):
            block["BatchNorm_2"]["scale"] = np.full_like(
                block["BatchNorm_2"]["scale"], 1e-2)
    return v


def _batch(seed, weight=False):
    b = {"image": tp.images(BATCH, SIZE, seed=seed).astype(np.float32)
         / np.float32(255.0),
         "label": (np.arange(BATCH, dtype=np.int32) * 3 + seed) % CLASSES}
    if weight:
        b["weight"] = np.ones(BATCH, np.float32)
        b["weight"][-2:] = 0.0  # padded filler rows
    return b


def _to_torch(params, stats):
    return convert.flax_to_torch({"params": params, "batch_stats": stats},
                                 stage_sizes=STAGES, block=BLOCK)


@functools.cache
def _jax(accum=1):
    """One step of the JAX Trainer on the data=2 mesh: (metrics, state
    after it in the port's names) and its mesh evaluate of the val
    batch."""
    model = tp.jax_model(STAGES, BLOCK, CLASSES)
    variables = _variables()
    cfg = JaxTrainConfig(
        name="dp", model=lambda: model, batch_size=BATCH, image_size=SIZE,
        num_classes=CLASSES, grad_accum_steps=accum,
        optimizer=JaxOptimizerConfig(name="sgd", learning_rate=LR,
                                     momentum=0.9, weight_decay=1e-4))
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    with tempfile.TemporaryDirectory() as work:
        trainer = JaxTrainer(cfg, model, JaxClassificationTask(CLASSES),
                             mesh=mesh, workdir=work)
        state = trainer.init_state(_batch(10))
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = replicate(state.replace(
            params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]),
            opt_state=trainer.tx.init(params)), mesh)
        evals = trainer.evaluate(state, [_batch(30, weight=True)])
        state, m = trainer.train_step(state, _batch(10))
        host = jax.device_get(state)
    return ({k: float(v) for k, v in m.items()},
            _to_torch(host.params, host.batch_stats), evals)


def _step(**kw):
    return ("steps", dict(kind="resnet", variables=_variables(),
                          batches=[_batch(10)], lr=LR, **kw))


@functools.cache
def _ranks():
    """Every port run: two ranks, one rank, and no group (the groups run
    two at a time while the reference compiles)."""
    work = tempfile.mkdtemp(prefix="dvt-dp-")
    fit = dict(variables=_variables(), batches=[_batch(10), _batch(11)],
               val=[_batch(30, weight=True)], lr=LR)

    def first():
        return run_ranks(2, [
            _step(), _step(local_stats=True), _step(accum=2),
            _step(nan=True),
            ("evaluate", dict(kind="resnet", variables=_variables(),
                              batches=[_batch(30, weight=True)])),
            ("fit", dict(workdir=os.path.join(work, "a"), epochs=1, **fit)),
            ("preempt", dict(variables=_variables(), lr=LR,
                             batches=[_batch(10), _batch(11), _batch(12)],
                             workdir=os.path.join(work, "p"), signalled=1)),
        ])

    def one():
        return run_ranks(1, [
            _step(), _step(accum=2),
            ("fit", dict(workdir=os.path.join(work, "a"), epochs=2, **fit)),
        ])

    def resumed():
        return run_ranks(2, [
            ("fit", dict(workdir=os.path.join(work, "b"), epochs=2, **fit)),
        ])

    try:
        with ThreadPoolExecutor(2) as pool:
            none = pool.submit(run_ranks, 0, [_step(), _step(accum=2)])
            two = pool.submit(first)
            _jax(), _jax(accum=2)
            two = two.result()
            shutil.copytree(os.path.join(work, "a"), os.path.join(work, "b"))
            one, resumed = pool.submit(one), pool.submit(resumed)
            return {"two": two, "one": one.result(),
                    "resumed": resumed.result(), "none": none.result()}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _update_err(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want − init‖ over parameters and statistics."""
    init = _to_torch(_variables()["params"], _variables()["batch_stats"])
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
    return (num / den) ** 0.5


def _bitwise(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_two_ranks_match_the_jax_mesh_step_and_local_stats_fail():
    two = _ranks()["two"]
    metrics, want, _ = _jax()
    for rank in (0, 1):
        got = two[rank][0]
        assert abs(got["metrics"][0]["loss"] - metrics["loss"]) <= \
            LOSS_BOUND * abs(metrics["loss"])
        assert got["metrics"][0]["top1"] == metrics["top1"]
        assert got["bad_steps"] == 0 and got["step"] == 1
        err = _update_err(got["states"][0], want)
        assert err <= UPDATE_BOUND, err
    # control: rank-local BatchNorm statistics train another model
    local = two[0][1]
    assert _update_err(local["states"][0], want) > 100 * UPDATE_BOUND


def test_grad_accum_under_the_mesh_matches_the_jax_mesh_step():
    metrics, want, _ = _jax(accum=2)
    got = _ranks()["two"][0][2]
    assert abs(got["metrics"][0]["loss"] - metrics["loss"]) <= \
        LOSS_BOUND * abs(metrics["loss"])
    assert _update_err(got["states"][0], want) <= UPDATE_BOUND


def test_ranks_hold_bitwise_equal_weights():
    two = _ranks()["two"]
    for call in (0, 2, 3):  # (call 1, the control, keeps local statistics)
        a, b = two[0][call], two[1][call]
        assert _bitwise(a["states"][-1], b["states"][-1]), call
        for ma, mb in zip(a["metrics"], b["metrics"]):
            assert all(np.array_equal(ma[k], mb[k], equal_nan=True)
                       for k in ma), call
    assert _bitwise(two[0][5]["final"], two[1][5]["final"])


def test_one_rank_group_is_bit_identical_to_no_group():
    one, none = _ranks()["one"][0], _ranks()["none"][0]
    for call in (0, 1):
        assert one[call]["metrics"] == none[call]["metrics"]
        assert _bitwise(one[call]["states"][0], none[call]["states"][0])
        assert _bitwise(one[call]["momentum"], none[call]["momentum"])


def test_a_nan_on_one_rank_skips_the_step_on_both():
    init = _to_torch(_variables()["params"], _variables()["batch_stats"])
    two = _ranks()["two"]
    for rank in (0, 1):
        got = two[rank][3]
        assert got["bad_steps"] == 1 and got["step"] == 1
        assert got["metrics"][0]["bad_steps"] == 1.0
        assert not np.isfinite(got["metrics"][0]["loss"])
        # parameters and running statistics kept their values
        state = got["states"][0]
        for k, v in init.items():
            np.testing.assert_array_equal(state[k], v, err_msg=k)


def test_eval_sums_match_the_jax_mesh_evaluate():
    _, _, want = _jax()
    two = _ranks()["two"]
    for rank in (0, 1):
        got = two[rank][4]
        assert set(got) == set(want)
        for k, w in want.items():
            assert abs(got[k] - w) <= EVAL_BOUND * max(abs(w), 1.0), \
                (k, got[k], w)


def test_rank0_checkpoint_resumes_at_world_sizes_one_and_two():
    runs = _ranks()
    first = runs["two"]
    # rank 0 wrote every checkpoint file; rank 1 none
    assert first[0][5]["writes"] >= 1 and first[1][5]["writes"] == 0
    assert first[0][5]["step"] == 2 and first[0][5]["restored"] is None
    saved = first[0][5]["final"]
    one, two = runs["one"][0][2], runs["resumed"]
    assert _bitwise(one["restored"], saved)
    assert _bitwise(two[0][0]["restored"], saved)
    assert _bitwise(two[1][0]["restored"], saved)
    assert one["step"] == two[0][0]["step"] == 4
    assert _bitwise(two[0][0]["final"], two[1][0]["final"])
    a, b = one["final"], two[0][0]["final"]
    keys = [k for k in a if not k.endswith("num_batches_tracked")]
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((a[k] - saved[k]) ** 2)) for k in keys)
    assert (num / den) ** 0.5 <= 1e-5
    np.testing.assert_allclose(one["losses"], two[0][0]["losses"],
                               rtol=1e-5)


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_step():
    two = _ranks()["two"]
    for rank in (0, 1):
        got = two[rank][6]
        # rank 1 alone was signalled after step 1; the flag is agreed at
        # the step boundary, so both stop there and save it (as epoch 0)
        assert got["preempted"] and got["step"] == 1, got
        assert got["checkpoints"] == [1], got
