"""CenterNet experiments (``deep_vision_tpu/zoo/centernet.py``).
``centernet``: 2 stacks of the order-5 hourglass with filters (256, 256,
384, 384, 384, 512), 256×256×3 → 64², 80 classes, bf16 compute with
float32 parameters, Adam 2.5e-4 with the epoch-table LR {1: 2.5e-4,
90: 2.5e-5, 120: 2.5e-6}, batch 32, 140 epochs.  ``centernet_toy``: one
order-3 stack with filters (16, 16, 24, 24), 64² → 16², 3 classes,
float32, the test-scale model.  Both train through ``cli.train`` and
serve ``/v1/detect``."""

import torch

from deep_vision_tpu_torch.core.config import (
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
    register_config,
)
from deep_vision_tpu_torch.models.centernet import CenterNet


@register_config("centernet_toy")
def centernet_toy():
    return TrainConfig(
        name="centernet_toy",
        model=lambda: CenterNet(num_classes=3, num_stack=1, order=3,
                                filters=(16, 16, 24, 24),
                                dtype=torch.float32),
        task="centernet",
        batch_size=8,
        total_epochs=60,
        optimizer=OptimizerConfig(name="adam", learning_rate=2.5e-4),
        image_size=64,
        num_classes=3,
        half_precision=False,
    )


@register_config("centernet")
def centernet():
    return TrainConfig(
        name="centernet",
        model=lambda: CenterNet(num_classes=80, dtype=torch.bfloat16),
        task="centernet",
        batch_size=32,
        total_epochs=140,
        optimizer=OptimizerConfig(name="adam", learning_rate=2.5e-4),
        scheduler=SchedulerConfig(
            name="epoch_table",
            kwargs=dict(table={1: 2.5e-4, 90: 2.5e-5, 120: 2.5e-6})),
        image_size=256,
        num_classes=80,
    )
