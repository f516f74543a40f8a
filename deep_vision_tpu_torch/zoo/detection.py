"""Detection experiments: the reference's YOLOv3 configs
(``deep_vision_tpu/zoo/detection.py``).  ``yolov3_coco`` (80 classes,
batch 128, the reference's global batch) and ``yolov3_voc`` (20
classes, batch 16): full Darknet-53, 416×416×3, bf16 compute with float32
parameters, Adam lr 1e-3 with global-norm clipping at 10, the epoch-table
LR {1: 1e-3, 40: 1e-4, 60: 1e-5}, 300 epochs.  ``yolov3_toy`` (64²) and
``yolov3_toy416`` (416²) are tiny-width float32 test configs (width
0.125, one residual block per stage, 3 classes)."""

import torch

from deep_vision_tpu_torch.core.config import (
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
    register_config,
)
from deep_vision_tpu_torch.models.yolo import YoloV3


def _yolo(name, num_classes, batch):
    return TrainConfig(
        name=name,
        model=lambda: YoloV3(num_classes=num_classes, dtype=torch.bfloat16),
        task="detection",
        batch_size=batch,
        total_epochs=300,
        optimizer=OptimizerConfig(name="adam", learning_rate=1e-3,
                                  grad_clip_norm=10.0),
        scheduler=SchedulerConfig(
            name="epoch_table",
            kwargs=dict(table={1: 1e-3, 40: 1e-4, 60: 1e-5})),
        image_size=416,
        num_classes=num_classes,
    )


@register_config("yolov3_coco")
def yolov3_coco():
    return _yolo("yolov3_coco", 80, 128)


@register_config("yolov3_voc")
def yolov3_voc():
    return _yolo("yolov3_voc", 20, 16)


def _toy(name, image_size, batch, epochs):
    return TrainConfig(
        name=name,
        model=lambda: YoloV3(num_classes=3, dtype=torch.float32,
                             width=0.125, blocks=(1, 1, 1, 1, 1)),
        task="detection",
        batch_size=batch,
        total_epochs=epochs,
        optimizer=OptimizerConfig(name="adam", learning_rate=1e-3,
                                  grad_clip_norm=10.0),
        image_size=image_size,
        num_classes=3,
        half_precision=False,
    )


@register_config("yolov3_toy416")
def yolov3_toy416():
    return _toy("yolov3_toy416", 416, 4, 60)


@register_config("yolov3_toy")
def yolov3_toy():
    return _toy("yolov3_toy", 64, 8, 60)
