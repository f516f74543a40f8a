"""Experiment configs; importing the package registers them."""

from deep_vision_tpu_torch.zoo import centernet, detection, resnet  # noqa: F401
