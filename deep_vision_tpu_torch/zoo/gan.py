"""GAN experiments (``deep_vision_tpu/zoo/gan.py``): ``dcgan`` (MNIST
28²×1, latent 100, Adam 1e-4, batch 256, 100 epochs, a checkpoint every
2) and ``cyclegan`` (256²×3, 9 residual blocks, Adam 2e-4 with b1 0.5,
batch 1, 200 epochs, the learning rate constant for 100 epochs and then
linear to 0, a checkpoint every 2); both bf16 compute with float32
parameters.  ``model`` is the generator, what ``/v1/generate`` serves."""

import torch

from deep_vision_tpu_torch.core.config import (
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
    register_config,
)
from deep_vision_tpu_torch.models import gan as gan_models


@register_config("dcgan")
def dcgan():
    return TrainConfig(
        name="dcgan",
        model=lambda: gan_models.DCGANGenerator(dtype=torch.bfloat16),
        task="gan_dcgan",
        batch_size=256,
        total_epochs=100,
        checkpoint_every_epochs=2,
        optimizer=OptimizerConfig(name="adam", learning_rate=1e-4),
        scheduler=SchedulerConfig(name="constant"),
        image_size=28,
        channels=1,
        num_classes=0,
    )


@register_config("cyclegan")
def cyclegan():
    return TrainConfig(
        name="cyclegan",
        model=lambda: gan_models.CycleGANGenerator(dtype=torch.bfloat16),
        task="gan_cyclegan",
        batch_size=1,
        total_epochs=200,
        checkpoint_every_epochs=2,
        optimizer=OptimizerConfig(name="adam", learning_rate=2e-4, b1=0.5),
        scheduler=SchedulerConfig(
            name="linear_decay",
            kwargs=dict(total_epochs=200, decay_start=100)),
        image_size=256,
        num_classes=0,
    )
