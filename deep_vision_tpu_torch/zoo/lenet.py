"""LeNet-5 experiments on MNIST (``deep_vision_tpu/zoo/lenet.py``):
``lenet5``, and the cascade tiers ``lenet5_nano`` (~12× less compute) and
``lenet5_big`` (~50× more), all 32×32×1, 10 classes, float32, Adam lr
1e-3, batch 64, 50 epochs, ReduceLROnPlateau(max, 0.1, patience 10)."""

from deep_vision_tpu_torch.core.config import (
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
    register_config,
)
from deep_vision_tpu_torch.models.lenet import LeNet5, LeNet5Big, LeNet5Nano


def _lenet(name, model_fn):
    return TrainConfig(
        name=name,
        model=model_fn,
        task="classification",
        batch_size=64,
        total_epochs=50,
        optimizer=OptimizerConfig(name="adam", learning_rate=1e-3),
        scheduler=SchedulerConfig(
            name="plateau", kwargs=dict(mode="max", factor=0.1, patience=10)),
        half_precision=False,
        image_size=32,
        channels=1,
        num_classes=10,
    )


@register_config("lenet5_nano")
def lenet5_nano():
    return _lenet("lenet5_nano", LeNet5Nano)


@register_config("lenet5")
def lenet5():
    return _lenet("lenet5", LeNet5)


@register_config("lenet5_big")
def lenet5_big():
    return _lenet("lenet5_big", LeNet5Big)
