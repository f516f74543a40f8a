"""One CenterNet trainer step of the port against one of the JAX
``Trainer``, on the CPU at the ``centernet_toy`` size (one order-3 stack,
3 classes, 64×64, batch 4, float32, Adam 2.5e-4), from the same seeded
weights and batch.  (Apart from tests/test_torch_centernet_train.py
because compiling the reference's step takes most of a minute.)

Bounds: the loss within 1e-5 relative; the update of the parameters and
BatchNorm statistics within 1e-3 of its L2 norm over the model; no
parameter element more than 2·lr off, and at most 1e-3 of the held ones
more than lr/100 off (``_torch_port.adam_step_errors``: the elements
whose reference update is at least lr/2, but the biases of the convs
whose output goes straight into a training BatchNorm, whose gradient is
zero in exact arithmetic).  Adam's first update is lr·g/(|g| + eps),
about lr·sign(g): an element whose gradient is rounding noise takes
either sign (measured: 1.6e-4 of the held elements).  The port at twice
the learning rate must miss the L2 bound (its update is twice as
long).
"""

import functools
import tempfile

import numpy as np

import jax.numpy as jnp

import _torch_port as tp
from deep_vision_tpu.data.detection import synthetic_detection_dataset
from deep_vision_tpu.models.centernet import CenterNet as JaxCenterNet
from deep_vision_tpu.tasks.centernet import CenterNetTask as JaxCenterNetTask
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.data.detection import CenterNetLoader
from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
from deep_vision_tpu_torch.tasks.centernet import CenterNetTask

SIZE, BATCH, CLASSES, LR = 64, 4, 3, 2.5e-4
TOY = dict(num_classes=CLASSES, num_stack=1, order=3,
           filters=(16, 16, 24, 24))


@functools.cache
def _variables():
    """Seeded flax weights of centernet_toy (non-zero BN scales); the
    heads' output convs scaled by 1/10 and the heatmap's bias at the
    −2.19 prior, so that the focal loss is not saturated."""
    v = tp.seeded_variables(JaxCenterNet(dtype=jnp.float32, **TOY),
                            (SIZE, SIZE, 3), seed=3)
    for key, head in v["params"].items():
        if key.startswith("DetectionHead_"):
            head["Conv_1"]["kernel"] = head["Conv_1"]["kernel"] * 0.1
            if int(key.rsplit("_", 1)[1]) % 3 == 0:  # the heatmap
                head["Conv_1"]["bias"] = np.full_like(
                    head["Conv_1"]["bias"], -2.19)
    return v


@functools.cache
def _batch():
    loader = CenterNetLoader(
        synthetic_detection_dataset(BATCH, SIZE, CLASSES, seed=11), BATCH,
        CLASSES, SIZE, train=False, device_normalize=True)
    batch = next(iter(loader))
    batch.pop("weight")
    return batch


def _to_torch(variables):
    return convert.centernet_from_flax(variables, TOY["num_stack"],
                                       TOY["order"], TOY["filters"])


def _port_step(lr=LR):
    cfg = get_config("centernet_toy")
    model = cfg.model()
    convert.load_centernet(model, _variables())
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(cfg, model, CenterNetTask(CLASSES), workdir=work,
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
        JaxCenterNet(dtype=jnp.float32, **TOY), _variables(),
        JaxCenterNetTask(CLASSES), _batch(), "centernet", SIZE, LR)
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
