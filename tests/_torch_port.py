"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same seeded weights in flax layout for the JAX reference and, through
deep_vision_tpu_torch/convert.py, for the port.

The weights have non-zero BatchNorm scales and positive running
variances on purpose: the reference's init zeroes the last BN scale of
every block, and a forward at that init tests nothing inside the
residual branches."""

import re

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deep_vision_tpu.models import resnet as jax_resnet
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models import resnet as port_resnet

# The tier-1 lane runs test files in parallel processes; two intra-op
# threads keep these small CPU forwards from crowding the timing-
# sensitive serving tests that share the machine.
torch.set_num_threads(2)

BLOCKS = {"BottleneckBlock": (jax_resnet.BottleneckBlock,
                              port_resnet.BottleneckBlock),
          "BasicBlock": (jax_resnet.BasicBlock, port_resnet.BasicBlock)}
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def jax_model(stage_sizes, block="BottleneckBlock", num_classes=10,
              dtype=jnp.float32):
    return jax_resnet.ResNet(stage_sizes=tuple(stage_sizes),
                             block_cls=BLOCKS[block][0],
                             num_classes=num_classes, dtype=dtype)


def port_model(stage_sizes, block="BottleneckBlock", num_classes=10,
               dtype=jnp.float32):
    return port_resnet.ResNet(tuple(stage_sizes), BLOCKS[block][1],
                              num_classes, TORCH_DTYPE[dtype])


def seeded_variables(model, input_shape, seed=0):
    """A flax variables tree of numpy float32 arrays for ``model``."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, *input_shape)), train=False))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(s.shape)
        if name == "kernel" and len(shape) == 4:   # conv, He fan-out
            std = np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
            a = rng.randn(*shape) * std
        elif name == "kernel":                     # dense
            a = rng.randn(*shape) / np.sqrt(shape[0])
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:                                      # bias, mean
            a = rng.randn(*shape) * 0.1
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load_port(model, variables):
    convert.load_into(model, variables)
    return model.eval()


def images(n, size, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               np.uint8)


#: the biases of the convs whose output goes straight into a training
#: BatchNorm in the hourglass families (each PreActBottleneck's conv1
#: and conv2, the stem conv, and a stack's conv in CenterNet or linear
#: layer in the Stacked Hourglass): the normalization removes any
#: per-channel constant, so their gradient is zero in exact arithmetic
#: and rounding noise in any framework
BN_FED_BIAS = re.compile(r"(conv1|conv2|stem_conv|^stacks\.\d+\.conv"
                         r"|^stacks\.\d+\.linear)\.bias$")


def adam_step_errors(got: dict, want: dict, init: dict, lr: float) -> dict:
    """One Adam step's state against another's, both from ``init``
    (numpy state_dicts): ``total``, ‖got−want‖ / ‖want−init‖ over every
    tensor (BatchNorm statistics included); ``max``, the largest
    |got−want| of a parameter; ``flipped``, the share of the held
    parameter elements off by more than lr/100.  Adam's first update is
    lr·g/(|g| + eps), about lr·sign(g): an element whose gradient is
    within rounding of 0 may take the other sign, 2·lr away.  Held are
    the elements whose reference update is at least lr/2 (a gradient
    above Adam's eps; under it the update is a ratio of rounding-level
    numbers, as for every bias on the stacked hourglass's residual
    stream, which each stack's BatchNorm after a 1×1 conv cancels), but
    not the ``BN_FED_BIAS`` biases."""
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
    params = [k for k in keys
              if not k.endswith(("running_mean", "running_var"))]
    off = held = 0
    for k in params:
        if BN_FED_BIAS.search(k):
            continue
        mask = np.abs(want[k] - init[k]) >= lr / 2
        held += int(mask.sum())
        off += int(np.sum((np.abs(got[k] - want[k]) > lr / 100) & mask))
    return {"total": (num / den) ** 0.5,
            "max": max(float(np.abs(got[k] - want[k]).max())
                       for k in params),
            "flipped": off / max(held, 1), "held": held}


def jax_trainer_step(jax_model, variables, task, batch, task_name: str,
                     size: int, lr: float):
    """One step of the JAX ``Trainer`` (Adam at ``lr``, the [0, 1] scale
    preprocess) on ``batch`` from the flax ``variables``: (loss, the
    host variables after the step)."""
    import tempfile

    from deep_vision_tpu.core.config import OptimizerConfig
    from deep_vision_tpu.core.config import TrainConfig
    from deep_vision_tpu.core.trainer import Trainer
    from deep_vision_tpu.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu.parallel import make_mesh, replicate

    cfg = TrainConfig(name="parity", model=lambda: jax_model, task=task_name,
                      batch_size=len(batch["image"]), image_size=size,
                      optimizer=OptimizerConfig(name="adam",
                                                learning_rate=lr))
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(cfg, jax_model, task, mesh=mesh, workdir=work,
                          preprocess_fn=make_scale_preprocess())
        state = trainer.init_state(batch)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = replicate(state.replace(
            params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]),
            opt_state=trainer.tx.init(params)), mesh)
        # the step donates its arguments: hand it a copy of the batch
        state, m = trainer.train_step(state, {k: np.array(v)
                                              for k, v in batch.items()})
        host = jax.device_get(state)
    return float(m["loss"]), {"params": host.params,
                              "batch_stats": host.batch_stats}
