"""Pose experiments (``deep_vision_tpu/zoo/pose.py``).  ``hourglass104``:
the Stacked Hourglass-104 of the reference's Hourglass/tensorflow
(4 stacks of the order-4 hourglass at 256 filters, 16 MPII heatmaps),
256×256×3 → 64², bf16 compute with float32 parameters, Adam 1e-3, batch
32, 100 epochs, the LR divided by 10 after 5 epochs without a better
``neg_loss`` (plateau in mode max).  ``hourglass_toy``: 4 stacks of the
order-2 hourglass at 16 filters, 8 heatmaps, 64² → 16², float32, the
test-scale model."""

import torch

from deep_vision_tpu_torch.core.config import (
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
    register_config,
)
from deep_vision_tpu_torch.models.hourglass import StackedHourglass


@register_config("hourglass_toy")
def hourglass_toy():
    return TrainConfig(
        name="hourglass_toy",
        model=lambda: StackedHourglass(num_stack=4, num_heatmap=8,
                                       filters=16, order=2,
                                       dtype=torch.float32),
        task="pose",
        batch_size=16,
        total_epochs=2,
        optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
        image_size=64,
        num_classes=8,
        half_precision=False,
    )


@register_config("hourglass104")
def hourglass104():
    return TrainConfig(
        name="hourglass104",
        model=lambda: StackedHourglass(num_stack=4, num_heatmap=16,
                                       dtype=torch.bfloat16),
        task="pose",
        batch_size=32,
        total_epochs=100,
        optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
        scheduler=SchedulerConfig(
            name="plateau", kwargs=dict(mode="max", factor=0.1, patience=5)),
        image_size=256,
        num_classes=16,  # heatmap channels
    )
