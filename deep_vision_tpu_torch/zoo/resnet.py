"""ResNet experiments: the reference's ``resnet34``/``resnet50``/
``resnet152``/``resnet50v2`` configs (``deep_vision_tpu/zoo/resnet.py``),
bf16 compute with float32 parameters, 224×224×3 input, 1000 classes; SGD
momentum 0.9, weight decay 1e-4, batch 512 (34) / 256 (50, 152, 50 V2),
lr 0.1, ReduceLROnPlateau(max, factor 0.1, patience 10) on val top-1.
``resnet50_modern``: ResNet-50 at batch 1024, lr 0.4 (0.1 × 1024/256),
90 epochs of warmup (5 epochs) + cosine, label smoothing 0.1."""

import torch

from deep_vision_tpu_torch.core.config import (
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
    register_config,
)
from deep_vision_tpu_torch.models import resnet


def _base(name, model_fn, batch_size, lr):
    return TrainConfig(
        name=name, model=model_fn, task="classification",
        batch_size=batch_size, total_epochs=100,
        optimizer=OptimizerConfig(name="sgd", learning_rate=lr, momentum=0.9,
                                  weight_decay=1e-4),
        scheduler=SchedulerConfig(
            name="plateau", kwargs=dict(mode="max", factor=0.1, patience=10)),
        image_size=224, channels=3, num_classes=1000)


@register_config("resnet34")
def resnet34():
    return _base("resnet34", lambda: resnet.ResNet34(dtype=torch.bfloat16),
                 512, 0.1)


@register_config("resnet50")
def resnet50():
    return _base("resnet50", lambda: resnet.ResNet50(dtype=torch.bfloat16),
                 256, 0.1)


@register_config("resnet152")
def resnet152():
    return _base("resnet152", lambda: resnet.ResNet152(dtype=torch.bfloat16),
                 256, 0.1)


@register_config("resnet50v2")
def resnet50v2():
    return _base("resnet50v2",
                 lambda: resnet.ResNet50V2(dtype=torch.bfloat16), 256, 0.1)


@register_config("resnet50_modern")
def resnet50_modern():
    cfg = _base("resnet50_modern",
                lambda: resnet.ResNet50(dtype=torch.bfloat16), 1024, 0.4)
    cfg.total_epochs = 90
    cfg.scheduler = SchedulerConfig(
        name="warmup_cosine", kwargs=dict(total_epochs=90, warmup_epochs=5))
    cfg.label_smoothing = 0.1
    return cfg
