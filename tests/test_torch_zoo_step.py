"""One trainer step of ``mobilenet1`` (RMSprop, depthwise convs) and of
``inception1`` (LRN, two aux heads, dropout) in the port against one of
the JAX ``Trainer``, on the CPU at float32, from the same seeded weights
(non-zero BatchNorm scales) and the same host-normalized batch (float
batches pass both trainers' preprocessing untouched), with each
config's optimizer at its learning rate.  Dropout is held through its
masks: inside the reference's jitted step every flax ``Dropout`` applies
a seeded numpy mask (``_torch_zoo.FlaxMasks``), and the port's Dropouts
apply the same masks through forward hooks.

Bounds: the loss within 1e-5 relative; the update of the parameters and
BatchNorm statistics within 1e-3 of its L2 norm over the model (an
RMSprop step with eps 1.0 and an SGD step are smooth in the gradient, so
the update carries the gradients' float32 rounding: measured 1e-6–1e-5);
the port at twice the learning rate must miss that bound.

MobileNet runs its stem and first 4 depthwise-separable blocks (both
strides), the same modules at a cut depth, on both sides: at its full 13
blocks the step is chaotic at this size.  The forwards drift apart by
float32 rounding, 1e-6 after the first BatchNorm and about 1.3× a layer
(1.5e-4 of the activations at the last one), until a ReLU input within
that distance of 0 takes the other side, and one such flip among the
last layer's 16,384 moves every earlier gradient by about 1% (measured:
the update 1.7e-3 to 3.4e-2 apart over batches 4-32 at full depth,
1e-6 to 1.2e-5 at 4 blocks).  The full depth is held in eval mode by
tests/test_torch_classifiers.py.  (Apart from
the other zoo tests because compiling the reference's step takes most of
the time.)
"""

import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import linen as fnn

import _torch_port as tp
import _torch_zoo as tz
from deep_vision_tpu.core.config import TrainConfig as JaxTrainConfig
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.trainer import Trainer as JaxTrainer
from deep_vision_tpu.models import mobilenet as j_mobilenet
from deep_vision_tpu.parallel import make_mesh, replicate
from deep_vision_tpu.tasks.classification import (
    ClassificationTask as JaxClassificationTask,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.models import mobilenet
from deep_vision_tpu_torch.tasks.classification import ClassificationTask

BATCH = 4
#: config → (size, the number of dropout calls in a train forward)
CASES = {"mobilenet1": (64, 1), "inception1": (128, 3)}
MASK_SEED = 100
MOBILENET_BLOCKS = 4


@pytest.fixture(autouse=True)
def _cut_mobilenet(monkeypatch):
    """MobileNet at its first MOBILENET_BLOCKS blocks on both sides."""
    monkeypatch.setattr(j_mobilenet, "_PLAN",
                        j_mobilenet._PLAN[:MOBILENET_BLOCKS])
    monkeypatch.setattr(mobilenet, "PLAN", mobilenet.PLAN[:MOBILENET_BLOCKS])


def _port_model(name):
    return tz.MODELS[name][1](CASES[name][0])


def _setup(name):
    size, _ = CASES[name]
    jax_model = tz.MODELS[name][0]()
    variables = tp.seeded_variables(jax_model, (size, size, 3), seed=5)
    rng = np.random.RandomState(6)
    batch = {"image": rng.randn(BATCH, size, size, 3).astype(np.float32),
             "label": rng.randint(0, tz.CLASSES, BATCH).astype(np.int32)}
    return jax_model, variables, batch


def _jax_step(name, jax_model, variables, batch):
    size, _ = CASES[name]
    ref = jax_get_config(name)
    cfg = JaxTrainConfig(name="parity", model=lambda: jax_model,
                         batch_size=BATCH, image_size=size,
                         num_classes=tz.CLASSES, optimizer=ref.optimizer)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    masks = tz.FlaxMasks(seed=MASK_SEED)
    with tempfile.TemporaryDirectory() as work, \
            fnn.intercept_methods(masks):
        trainer = JaxTrainer(cfg, jax_model,
                             JaxClassificationTask(tz.CLASSES), mesh=mesh,
                             workdir=work)
        state = trainer.init_state(batch)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = state.replace(params=params,
                              opt_state=trainer.tx.init(params))
        if "batch_stats" in variables:
            state = state.replace(batch_stats=jax.tree_util.tree_map(
                jnp.asarray, variables["batch_stats"]))
        state = replicate(state, mesh)
        state, m = trainer.train_step(state, {k: np.array(v)
                                              for k, v in batch.items()})
        host = jax.device_get(state)
    after = {"params": host.params}
    if "batch_stats" in variables:
        after["batch_stats"] = host.batch_stats
    return float(m["loss"]), after, masks.masks


def _port_step(name, variables, batch, masks, lr_scale=1.0):
    size, _ = CASES[name]
    cfg = get_config(name)
    cfg.image_size, cfg.num_classes = size, tz.CLASSES
    model = _port_model(name)
    convert.load_classifier(model, variables)
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(cfg, model, ClassificationTask(tz.CLASSES),
                          workdir=work, device="cpu")
        state = trainer.state_for(model)
        state.opt.set_learning_rate(cfg.optimizer.learning_rate * lr_scale)
        handles, calls = tz.replay_masks(model, masks)
        # the trainer sets its own generator each step; the hooks
        # replace what it draws
        state, m = trainer.train_step(state, batch)
        for h in handles:
            h.remove()
        assert len(calls) == len(masks) and int(state.bad_steps) == 0
        return float(m["loss"]), {k: v.numpy().copy() for k, v in
                                  state.model.state_dict().items()}


def _update_error(got, want, init):
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
    return (num / den) ** 0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_step_matches_jax_trainer(name):
    jax_model, variables, batch = _setup(name)
    want_loss, after, masks = _jax_step(name, jax_model, variables, batch)
    assert len(masks) == CASES[name][1]
    model = _port_model(name)
    want = convert.classifier_from_flax(after, model)
    init = convert.classifier_from_flax(variables, model)
    loss, got = _port_step(name, variables, batch, masks)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    err = _update_error(got, want, init)
    assert err <= 1e-3, err
    # every parameter moved in the reference, so every branch and head
    # got a gradient
    moved = [k for k in want if not k.endswith("num_batches_tracked")
             and not np.array_equal(want[k], init[k])]
    assert len(moved) == len([k for k in want
                              if not k.endswith("num_batches_tracked")])
    # control: twice the learning rate misses the bound
    _, fast = _port_step(name, variables, batch, masks, lr_scale=2.0)
    assert _update_error(fast, want, init) > 1e-3
