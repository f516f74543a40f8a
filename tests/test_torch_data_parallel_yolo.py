"""Data-parallel YOLOv3 training of the port against the JAX ``Trainer``
on a ``{"data": 2}`` mesh of two virtual CPU devices: two gloo ranks on
the CPU (``tests/_torch_dist_worker.py``), each fed its device's rows of
the global batch.  (Apart from tests/test_torch_data_parallel.py
because the reference's step and eval take most of a minute to
compile.)

``yolov3_toy`` (64², width 0.125, 3 classes, global batch 8, Adam 1e-3
with global-norm clipping at 10).  The reference runs its Pallas
``best_iou_max`` in interpret mode through its data-axis ``shard_map``
(``best_iou_max_sharded``); the port's loss runs ``best_iou_max`` on
each rank's shard.

Bounds: the loss within 1e-4 relative (tests/test_torch_yolo_step.py's
bound).  Adam's first update is about lr·sign(g), so an element whose
gradient is rounding noise takes either sign (``_torch_port.
adam_step_errors``): the reference's own step on one device and on two
part by 7.4e-3 of the update's L2 norm with 1.1e-3 of the held elements
flipped (measured on the CPU), and the port's two ranks read 7.2e-3 and
1.1e-3 against the two-device step.  So the update against the
reference within 1e-2, at most 2e-3 flipped and no element more than
2·lr off; and against the port's own one-process step on the whole
batch within 2e-4 (measured 3.8e-5), which holds the ranks' reductions
tightly.  Control: rank-local BatchNorm statistics miss the loss bound.  Eval over the ranks' shards of two
batches: the loss sums within 1e-5 relative of the reference's mesh
``evaluate``, and its mAP (rank 0's, over every rank's gathered
outputs, broadcast to the other) within 1e-6.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import _torch_port as tp
import _torch_yolo as ty
from _torch_dist_worker import run_ranks
from deep_vision_tpu.data.detection import synthetic_detection_dataset
from deep_vision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deep_vision_tpu.tasks.detection import YoloTask as JaxYoloTask
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.data.detection import DetectionLoader


@functools.cache
def _val():
    samples = synthetic_detection_dataset(16, ty.SIZE, 3, seed=21)
    return list(DetectionLoader(samples, ty.BATCH, 3, ty.SIZE, train=False,
                                device_normalize=True))


@functools.cache
def _runs():
    """The ranks' runs (in a thread) beside the reference's mesh step."""
    step = dict(kind="yolo", variables=ty.variables(),
                batches=[ty.batches()[0]], lr=ty.LR)
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(run_ranks, 2, [
            ("steps", step), ("steps", dict(step, local_stats=True)),
            ("evaluate", dict(kind="yolo", variables=ty.variables(),
                              batches=_val())),
        ])
        alone = pool.submit(run_ranks, 0, [("steps", step)])
        ref = tp.jax_trainer_step(
            JaxYoloV3(**ty.TOY), ty.variables(),
            JaxYoloTask(3, use_pallas=True), ty.batches()[0], "detection",
            ty.SIZE, ty.LR, data=2, val=_val(), clip=10.0)
        return ranks.result(), alone.result()[0][0], ref


def _to_torch(variables):
    return convert.yolo_from_flax(variables, ty.TOY["blocks"])


def test_two_ranks_match_the_jax_mesh_step_and_local_stats_fail():
    ranks, alone, (want_loss, after, _) = _runs()
    want, init = _to_torch(after), _to_torch(ty.variables())
    for rank in (0, 1):
        got = ranks[rank][0]
        loss = got["metrics"][0]["loss"]
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss), (loss,
                                                                want_loss)
        errs = tp.adam_step_errors(got["states"][0], want, init, ty.LR)
        assert errs["total"] <= 1e-2, errs
        assert errs["flipped"] <= 2e-3, errs
        assert errs["max"] <= 2 * ty.LR * (1 + 1e-4), errs
        own = tp.adam_step_errors(got["states"][0], alone["states"][0],
                                  init, ty.LR)
        assert own["total"] <= 2e-4, own
    local = ranks[0][1]["metrics"][0]["loss"]
    assert abs(local - want_loss) > 1e-4 * abs(want_loss), (local,
                                                            want_loss)


def test_eval_sums_and_map_match_the_jax_mesh_evaluate():
    ranks, _, (_, _, want) = _runs()
    for rank in (0, 1):
        got = ranks[rank][2]
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k, w in want.items():
            bound = 1e-6 if k.startswith("mAP") else 1e-5 * max(abs(w), 1.0)
            assert abs(got[k] - w) <= bound, (k, got[k], w)
