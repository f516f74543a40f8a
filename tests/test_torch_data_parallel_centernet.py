"""Data-parallel CenterNet training of the port against the JAX
``Trainer`` on a ``{"data": 2}`` mesh of two virtual CPU devices: two
gloo ranks on the CPU (``tests/_torch_dist_worker.py``), each fed its
device's rows of a global batch whose halves hold different object
counts.

The reference divides the wh and offset L1 sums by the global batch's
object count (``deep_vision_tpu/tasks/centernet.py``); each rank of the
port divides its sums by the all-reduced count and multiplies by the
ranks, so the ranks' mean is that loss.  The model is a one-stack
order-1 CenterNet (filters (16, 16), 3 classes, 64², global batch 8,
Adam 2.5e-4), cut from ``centernet_toy``'s order 3 because the
reference's order-3 step takes over a minute to compile on a mesh.

Bounds (tests/test_torch_centernet_step.py's): the loss within 1e-5
relative; the update within 1e-3 of its L2 norm over the model.
Control: each rank dividing by its own shard's count misses the loss
bound.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax.numpy as jnp

import _torch_port as tp
from _torch_dist_worker import run_ranks
from deep_vision_tpu.data.detection import synthetic_detection_dataset
from deep_vision_tpu.models.centernet import CenterNet as JaxCenterNet
from deep_vision_tpu.tasks.centernet import CenterNetTask as JaxCenterNetTask
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.data.detection import CenterNetLoader

SIZE, BATCH, LR = 64, 8, 2.5e-4
ARCH = dict(num_stack=1, order=1, filters=(16, 16))


@functools.cache
def _variables():
    """Seeded weights as tests/test_torch_centernet_step.py makes them:
    the heads' output convs scaled by 1/10 and the heatmap's bias at the
    −2.19 prior, so that the focal loss is not saturated."""
    v = tp.seeded_variables(
        JaxCenterNet(num_classes=3, dtype=jnp.float32, **ARCH),
        (SIZE, SIZE, 3), seed=3)
    for key, head in v["params"].items():
        if key.startswith("DetectionHead_"):
            head["Conv_1"]["kernel"] = head["Conv_1"]["kernel"] * 0.1
            if int(key.rsplit("_", 1)[1]) % 3 == 0:
                head["Conv_1"]["bias"] = np.full_like(
                    head["Conv_1"]["bias"], -2.19)
    return v


@functools.cache
def _batch():
    loader = CenterNetLoader(
        synthetic_detection_dataset(BATCH, SIZE, 3, seed=11), BATCH, 3,
        SIZE, train=False, device_normalize=True)
    batch = next(iter(loader))
    batch.pop("weight")
    return batch


@functools.cache
def _runs():
    step = dict(kind="centernet", variables=_variables(),
                batches=[_batch()], lr=LR, arch=ARCH)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, 2, [
            ("steps", step), ("steps", dict(step, local_count=True))])
        ref = tp.jax_trainer_step(
            JaxCenterNet(num_classes=3, dtype=jnp.float32, **ARCH),
            _variables(), JaxCenterNetTask(3), _batch(), "centernet", SIZE,
            LR, data=2)
        return ranks.result(), ref


def _to_torch(v):
    return convert.centernet_from_flax(v, ARCH["num_stack"], ARCH["order"],
                                       ARCH["filters"])


def test_global_object_count_matches_the_jax_mesh_step():
    mask = _batch()["obj_mask"]
    half = BATCH // 2
    assert float(mask[:half].sum()) != float(mask[half:].sum())
    ranks, (want_loss, after) = _runs()
    want, init = _to_torch(after), _to_torch(_variables())
    for rank in (0, 1):
        got = ranks[rank][0]
        loss = got["metrics"][0]["loss"]
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss,
                                                                want_loss)
        errs = tp.adam_step_errors(got["states"][0], want, init, LR)
        assert errs["total"] <= 1e-3, errs
    # control: each rank normalizing by its own shard's objects
    local = ranks[0][1]["metrics"][0]["loss"]
    assert abs(local - want_loss) > 1e-5 * abs(want_loss), (local,
                                                            want_loss)
