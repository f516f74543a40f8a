"""Shared helpers of the classifier-zoo parity tests
(tests/test_torch_classifiers.py, test_torch_zoo_train.py,
test_torch_zoo_step.py): the reference's and the port's model of each
zoo family at a small input size, and dropout masks shared between them.

Dropout cannot match across the two packages' generators, so the tests
hold it through its mask: :class:`FlaxMasks` intercepts every flax
``Dropout`` call (``flax.linen.intercept_methods``) and applies a
seeded numpy mask drawn from the call's static shape (the forwards are
jitted, where flax's own mask would be a tracer), recording it; :func:`replay_masks`
installs forward hooks on the port's ``Dropout`` modules that apply the
same masks in call order.  Neither package changes for that."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import _torch_port as tp
from deep_vision_tpu.models import alexnet as j_alexnet
from deep_vision_tpu.models import inception as j_inception
from deep_vision_tpu.models import lenet as j_lenet
from deep_vision_tpu.models import mobilenet as j_mobilenet
from deep_vision_tpu.models import resnet as j_resnet
from deep_vision_tpu.models import shufflenet as j_shufflenet
from deep_vision_tpu.models import vgg as j_vgg
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models import alexnet, inception, lenet
from deep_vision_tpu_torch.models import mobilenet, resnet, shufflenet, vgg
from deep_vision_tpu_torch.models.common import (
    Dropout,
    SequentialClassifier,
    set_dropout_generator,
)

CLASSES = 10

#: name → (flax model, port model factory(size), test size, channels).
#: Full widths; sizes small but with a last feature map above 1×1 where
#: a dense layer flattens it (AlexNet 3×3 at 127², VGG 2×2 at 64², the
#: Inception V1 aux heads 2×2 at 128²), and Inception V1 also at 100²,
#: whose SAME max-pools meet the odd sizes 25, 13 and 7.
MODELS = {
    "lenet5": (lambda: j_lenet.LeNet5(), lambda s: lenet.LeNet5(), 32, 1),
    "lenet5_nano": (lambda: j_lenet.LeNet5Nano(),
                    lambda s: lenet.LeNet5Nano(), 32, 1),
    "lenet5_big": (lambda: j_lenet.LeNet5Big(),
                   lambda s: lenet.LeNet5Big(), 32, 1),
    "alexnet1": (lambda: j_alexnet.AlexNetV1(num_classes=CLASSES),
                 lambda s: alexnet.AlexNetV1(CLASSES, image_size=s), 127, 3),
    "alexnet2": (lambda: j_alexnet.AlexNetV2(num_classes=CLASSES),
                 lambda s: alexnet.AlexNetV2(CLASSES, image_size=s), 127, 3),
    "vgg16": (lambda: j_vgg.VGG16(num_classes=CLASSES),
              lambda s: vgg.VGG16(CLASSES, image_size=s), 64, 3),
    "vgg19": (lambda: j_vgg.VGG19(num_classes=CLASSES),
              lambda s: vgg.VGG19(CLASSES, image_size=s), 64, 3),
    "inception1": (lambda: j_inception.InceptionV1(num_classes=CLASSES),
                   lambda s: inception.InceptionV1(CLASSES, image_size=s),
                   128, 3),
    "inception1_odd": (lambda: j_inception.InceptionV1(num_classes=CLASSES),
                       lambda s: inception.InceptionV1(CLASSES,
                                                       image_size=s),
                       100, 3),
    "inception3": (lambda: j_inception.InceptionV3(num_classes=CLASSES),
                   lambda s: inception.InceptionV3(CLASSES), 139, 3),
    "mobilenet1": (lambda: j_mobilenet.MobileNetV1(num_classes=CLASSES),
                   lambda s: mobilenet.MobileNetV1(num_classes=CLASSES),
                   64, 3),
    "shufflenet1": (lambda: j_shufflenet.ShuffleNetV1(num_classes=CLASSES),
                    lambda s: shufflenet.ShuffleNetV1(num_classes=CLASSES),
                    64, 3),
    "resnet50v2": (lambda: j_resnet.ResNet50V2(num_classes=CLASSES),
                   lambda s: resnet.ResNet50V2(CLASSES), 64, 3),
}


class FlaxMasks:
    """``flax.linen.intercept_methods`` interceptor for ``Dropout``: call
    ``k`` applies the keep mask drawn by numpy's ``RandomState(seed +
    k)``, recorded in ``self.masks``."""

    def __init__(self, seed: int):
        self.seed = seed
        self.masks = []

    def __call__(self, next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout) or \
                context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        rate = context.module.rate
        deterministic = fnn.merge_param(
            "deterministic", context.module.deterministic,
            kwargs.get("deterministic"))
        if deterministic or rate == 0.0:
            return next_fun(*args, **kwargs)
        keep_prob = 1.0 - rate
        rng = np.random.RandomState(self.seed + len(self.masks))
        mask = rng.uniform(size=x.shape) < keep_prob
        self.masks.append(mask)
        return jax.lax.select(jnp.asarray(mask), x / keep_prob,
                              jnp.zeros_like(x))


def port_masks(model: torch.nn.Module, masks) -> list:
    """flax's masks in the port's layout: a Dropout that reads a
    flattened feature map (AlexNet's first) sees it flattened NHWC in
    flax and NCHW in the port, so its mask is permuted; the others act
    on dense features and pass as they are."""
    masks = [np.asarray(m) for m in masks]
    if isinstance(model, SequentialClassifier) and \
            isinstance(model.classifier[0], Dropout):
        h, w = model.flatten_hw
        b, n = masks[0].shape
        masks[0] = masks[0].reshape(b, h, w, n // (h * w)) \
            .transpose(0, 3, 1, 2).reshape(b, n)
    return masks


def replay_masks(model: torch.nn.Module, masks) -> list:
    """Forward hooks on ``model``'s Dropouts applying flax's ``masks``
    (numpy bools, in :func:`port_masks`' layout) in call order; returns
    the handles and the list of calls.  A generator is set so that the
    port's own draw runs (and is then replaced)."""
    calls = []
    masks = port_masks(model, masks)
    set_dropout_generator(model, torch.Generator().manual_seed(0))

    def hook(mod, inputs, out):
        if not mod.training or mod.rate == 0.0:
            return out
        m = torch.from_numpy(masks[len(calls)])
        calls.append(mod)
        x = inputs[0]
        return torch.where(m.to(x.device), x / (1.0 - mod.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    return [m.register_forward_hook(hook) for m in model.modules()
            if isinstance(m, Dropout)], calls


@functools.cache
def variables(name, seed=0):
    """Seeded flax variables of ``MODELS[name]`` at its test size."""
    jax_factory, _, size, ch = MODELS[name]
    return tp.seeded_variables(jax_factory(), (size, size, ch), seed=seed)


def port(name, flax_variables=None):
    """The port's model of ``name`` with ``flax_variables`` (default
    :func:`variables`)."""
    _, factory, size, _ = MODELS[name]
    model = factory(size)
    convert.load_classifier(model, flax_variables or variables(name))
    return model


def inputs(name, n=2, seed=1):
    _, _, size, ch = MODELS[name]
    return np.random.RandomState(seed).randn(n, size, size, ch) \
        .astype(np.float32)


def flax_eval(name, flax_variables, x):
    """The reference's jitted eval forward → numpy logits."""
    jm = MODELS[name][0]()
    return np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        flax_variables, jnp.asarray(x)))


def flax_train(jm, flax_variables, x, masks):
    """The reference's jitted training forward under ``masks`` (a seeded
    :class:`FlaxMasks`, whose masks are numpy constants at trace time):
    (outputs, the mutated batch_stats collection)."""
    with fnn.intercept_methods(masks):
        return jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(flax_variables,
                                                       jnp.asarray(x))
