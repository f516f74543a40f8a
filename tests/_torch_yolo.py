"""Shared helpers of the port's YOLOv3 step tests
(tests/test_torch_yolo_step.py, tests/test_torch_yolo_trainer.py): the
``yolov3_toy`` model's seeded weights in flax layout, two seeded uint8
batches, and the port's Trainer around those weights."""

import functools

import _torch_port as tp
from deep_vision_tpu.data.detection import synthetic_detection_dataset
from deep_vision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.trainer import Trainer
from deep_vision_tpu_torch.data.detection import DetectionLoader
from deep_vision_tpu_torch.models.yolo import YoloV3
from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
from deep_vision_tpu_torch.tasks.detection import YoloTask

TOY = dict(num_classes=3, width=0.125, blocks=(1, 1, 1, 1, 1))
SIZE, BATCH, LR = 64, 8, 1e-3


@functools.cache
def variables():
    return tp.seeded_variables(JaxYoloV3(**TOY), (SIZE, SIZE, 3), seed=3)


@functools.cache
def batches():
    """Two uint8 batches (un-augmented synthetic scenes) with labels."""
    samples = synthetic_detection_dataset(2 * BATCH, SIZE, 3, seed=11)
    loader = DetectionLoader(samples, BATCH, 3, SIZE, train=False,
                             device_normalize=True)
    out = []
    for b in loader:
        b.pop("weight")
        out.append(b)
    return out


def port_trainer(workdir):
    cfg = get_config("yolov3_toy")
    model = YoloV3(**TOY)
    convert.load_yolo(model, variables())
    trainer = Trainer(cfg, model, YoloTask(3), workdir=workdir,
                      preprocess_fn=make_scale_preprocess(), device="cpu")
    return trainer, trainer.state_for(model)
