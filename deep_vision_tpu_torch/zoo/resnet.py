"""ResNet experiments: the reference's ``resnet34``/``resnet50``/
``resnet152`` configs (``deep_vision_tpu/zoo/resnet.py``), bf16 compute
with float32 parameters, 224×224×3 input, 1000 classes."""

import torch

from deep_vision_tpu_torch.core.config import TrainConfig, register_config
from deep_vision_tpu_torch.models import resnet


def _base(name, model_fn):
    return TrainConfig(name=name, model=model_fn, task="classification",
                       image_size=224, channels=3, num_classes=1000)


@register_config("resnet34")
def resnet34():
    return _base("resnet34", lambda: resnet.ResNet34(dtype=torch.bfloat16))


@register_config("resnet50")
def resnet50():
    return _base("resnet50", lambda: resnet.ResNet50(dtype=torch.bfloat16))


@register_config("resnet152")
def resnet152():
    return _base("resnet152", lambda: resnet.ResNet152(dtype=torch.bfloat16))
