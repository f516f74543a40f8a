"""Classifier experiments (``deep_vision_tpu/zoo/classifiers.py``), bf16
compute with float32 parameters, 1000 classes:

- alexnet1/2: SGD lr 0.01 momentum 0.9 wd 5e-4, batch 128, 224²,
  plateau(max, 0.1, patience 10), 200 epochs;
- vgg16/19: the same SGD, StepLR(10, 0.5);
- inception1: SGD lr 0.01 momentum 0.9 wd 2e-4, the sqrt-poly decay over
  60 epochs;
- inception3 (299²) and mobilenet1: RMSprop lr 0.045, decay 0.9, eps 1.0
  (momentum 0.9, the config's default), StepLR(2, 0.94);
- shufflenet1: SGD lr 0.1 momentum 0.9 wd 4e-5, batch 256, 240 epochs,
  linear decay from epoch 1.

Models whose dense width depends on the input (AlexNet, VGG, Inception
V1's aux heads) are built at the config's ``image_size`` when the
constructor runs, so an ``--image-size`` override reaches them."""

import torch

from deep_vision_tpu_torch.core.config import (
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
    register_config,
)
from deep_vision_tpu_torch.models import (
    alexnet,
    inception,
    mobilenet,
    shufflenet,
    vgg,
)

_BF16 = torch.bfloat16


def _cfg(name, model_fn, *, batch=128, epochs=200, opt=None, sched=None,
         image_size=224):
    cfg = TrainConfig(
        name=name, model=None, task="classification",
        batch_size=batch, total_epochs=epochs,
        optimizer=opt or OptimizerConfig(name="sgd", learning_rate=0.01,
                                         momentum=0.9, weight_decay=5e-4),
        scheduler=sched or SchedulerConfig(
            name="plateau", kwargs=dict(mode="max", factor=0.1, patience=10)),
        image_size=image_size, num_classes=1000)
    cfg.model = lambda: model_fn(cfg)
    return cfg


def _rmsprop():
    return OptimizerConfig(name="rmsprop", learning_rate=0.045,
                           rms_decay=0.9, eps=1.0)


def _step(step_size, gamma):
    return SchedulerConfig(name="step",
                           kwargs=dict(step_size=step_size, gamma=gamma))


@register_config("alexnet1")
def alexnet1():
    return _cfg("alexnet1", lambda c: alexnet.AlexNetV1(
        dtype=_BF16, image_size=c.image_size))


@register_config("alexnet2")
def alexnet2():
    return _cfg("alexnet2", lambda c: alexnet.AlexNetV2(
        dtype=_BF16, image_size=c.image_size))


@register_config("vgg16")
def vgg16():
    return _cfg("vgg16", lambda c: vgg.VGG16(dtype=_BF16,
                                             image_size=c.image_size),
                sched=_step(10, 0.5))


@register_config("vgg19")
def vgg19():
    return _cfg("vgg19", lambda c: vgg.VGG19(dtype=_BF16,
                                             image_size=c.image_size),
                sched=_step(10, 0.5))


@register_config("inception1")
def inception1():
    return _cfg("inception1", lambda c: inception.InceptionV1(
        dtype=_BF16, image_size=c.image_size),
        opt=OptimizerConfig(name="sgd", learning_rate=0.01, momentum=0.9,
                            weight_decay=2e-4),
        sched=SchedulerConfig(name="sqrt_poly", kwargs=dict(horizon=60)))


@register_config("inception3")
def inception3():
    return _cfg("inception3", lambda c: inception.InceptionV3(dtype=_BF16),
                image_size=299, opt=_rmsprop(), sched=_step(2, 0.94))


@register_config("mobilenet1")
def mobilenet1():
    return _cfg("mobilenet1", lambda c: mobilenet.MobileNetV1(dtype=_BF16),
                opt=_rmsprop(), sched=_step(2, 0.94))


@register_config("shufflenet1")
def shufflenet1():
    return _cfg("shufflenet1",
                lambda c: shufflenet.ShuffleNetV1(dtype=_BF16),
                batch=256, epochs=240,
                opt=OptimizerConfig(name="sgd", learning_rate=0.1,
                                    momentum=0.9, weight_decay=4e-5),
                sched=SchedulerConfig(name="linear_decay",
                                      kwargs=dict(total_epochs=240,
                                                  decay_start=1)))
