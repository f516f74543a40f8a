"""One Stacked Hourglass trainer step of the port against one of the JAX
``Trainer``, on the CPU, from the same seeded weights and batch: two
stacks of the order-1 hourglass at 8 filters, 8 heatmaps, 64×64, batch
4, float32, Adam 1e-3 (``hourglass_toy``'s recipe; its four order-2
stacks take the reference's step nine minutes to compile on the CPU,
this model under a minute).  Apart from tests/test_torch_pose.py for
that compile.

Bounds, as in tests/test_torch_centernet_step.py: the loss within 1e-5
relative; the update of the parameters and BatchNorm statistics within
1e-3 of its L2 norm over the model; no parameter element more than 2·lr
off, and at most 1e-3 of the held ones more than lr/100 off (measured:
1.6e-4; ``_torch_port.adam_step_errors`` says which are held and
why).  The port at twice the learning rate must miss the L2
bound.  The seeded heatmap convs are scaled by 1e-3, so that the
heatmaps start near the targets' scale rather than at 1e5.
"""

import functools
import tempfile

import jax.numpy as jnp

import _torch_port as tp
from deep_vision_tpu.data.pose import synthetic_pose_dataset
from deep_vision_tpu.models.hourglass import StackedHourglass as JaxHourglass
from deep_vision_tpu.tasks.pose import PoseTask as JaxPoseTask
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.data.pose import PoseLoader
from deep_vision_tpu_torch.models.hourglass import StackedHourglass
from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
from deep_vision_tpu_torch.tasks.pose import PoseTask

SIZE, BATCH, KP, LR = 64, 4, 8, 1e-3
TOY = dict(num_stack=2, num_heatmap=KP, filters=8, order=1)


@functools.cache
def _variables():
    v = tp.seeded_variables(JaxHourglass(dtype=jnp.float32, **TOY),
                            (SIZE, SIZE, 3), seed=3)
    for s in range(TOY["num_stack"]):  # each stack's heatmap conv
        conv = v["params"][f"Conv_{2 + 4 * s}"]
        conv["kernel"] = conv["kernel"] * 1e-3
    return v


@functools.cache
def _batch():
    loader = PoseLoader(synthetic_pose_dataset(BATCH, SIZE, KP, seed=11),
                        BATCH, SIZE, SIZE // 4, KP, train=False,
                        device_normalize=True)
    batch = next(iter(loader))
    batch.pop("weight")
    return batch


def _to_torch(variables):
    return convert.stacked_hourglass_from_flax(
        variables, TOY["num_stack"], KP, TOY["filters"], 1, TOY["order"])


def _port_step(lr=LR):
    cfg = get_config("hourglass_toy")
    model = StackedHourglass(**TOY)
    convert.load_stacked_hourglass(model, _variables())
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(cfg, model, PoseTask(), workdir=work,
                          preprocess_fn=make_scale_preprocess(),
                          device="cpu")
        state = trainer.state_for(model)
        state.opt.set_learning_rate(lr)
        state, m = trainer.train_step(state, _batch())
        assert int(state.bad_steps) == 0 and int(state.opt.count) == 1
        return float(m["loss"]), {k: v.numpy().copy() for k, v in
                                  state.model.state_dict().items()}


def test_trainer_step_matches_jax_trainer():
    want_loss, after = tp.jax_trainer_step(
        JaxHourglass(dtype=jnp.float32, **TOY), _variables(), JaxPoseTask(),
        _batch(), "pose", SIZE, LR)
    want, init = _to_torch(after), _to_torch(_variables())
    loss, got = _port_step()
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    errs = tp.adam_step_errors(got, want, init, LR)
    assert errs["total"] <= 1e-3, errs
    assert errs["max"] <= 2 * LR * (1 + 1e-4), errs
    assert errs["flipped"] <= 1e-3, errs
    # control: twice the learning rate misses the update bound
    _, fast = _port_step(2 * LR)
    assert tp.adam_step_errors(fast, want, init, LR)["total"] > 1e-3
