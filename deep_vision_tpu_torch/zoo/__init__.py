"""Experiment configs; importing the package registers them."""

from deep_vision_tpu_torch.zoo import (  # noqa: F401
    centernet,
    classifiers,
    detection,
    gan,
    lenet,
    pose,
    resnet,
)
