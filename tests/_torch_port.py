"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same seeded weights in flax layout for the JAX reference and, through
deep_vision_tpu_torch/convert.py, for the port.

The weights have non-zero BatchNorm scales and positive running
variances on purpose: the reference's init zeroes the last BN scale of
every block, and a forward at that init tests nothing inside the
residual branches."""

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
