"""Where a serving bucket's or a train step's time goes:
``torch.profiler`` over a few calls, device time summed by kernel.

    python -m deep_vision_tpu_torch.obs.profile -m resnet50 \\
        --infer-dtype int8 --bucket 32 [--weights w.npz] [--device cuda]
    python -m deep_vision_tpu_torch.obs.profile -m resnet50 --train \\
        [--device cuda]
    python -m deep_vision_tpu_torch.obs.profile -m yolov3_coco --train
    python -m deep_vision_tpu_torch.obs.profile -m yolov3_coco \\
        --infer-dtype int8 --bucket 32       # or -m centernet, hourglass104
    python -m deep_vision_tpu_torch.obs.profile -m centernet --train
    python -m deep_vision_tpu_torch.obs.profile -m hourglass104 --train
    python -m deep_vision_tpu_torch.obs.profile -m inception3 --train
        # or any classifier: vgg16, mobilenet1, lenet5, resnet50_modern...
    python -m deep_vision_tpu_torch.obs.profile -m dcgan --train
    python -m deep_vision_tpu_torch.obs.profile -m cyclegan --train
    python -m deep_vision_tpu_torch.obs.profile -m dcgan \\
        --infer-dtype float32 --bucket 32     # or -m cyclegan (uint8 wire)

Prints one JSON object: the wall time per forward (or per train step;
host clock around synchronised calls), the device busy time per call
(the sum of its kernels' durations) and its share of the wall time, and
the kernels with the most device time, grouped into ``conv``
(cuDNN/cuBLAS convolution and GEMM kernels, cuBLAS's ``nvjet_*``
included), ``serve_ingest``, ``train_ingest``, ``best_iou_max``,
``optimizer`` (the foreach kernels of the SGD or Adam update and the
divergence guard) and ``other`` (elementwise, BatchNorm, pooling,
reductions), and, for a model whose workload decodes on the device,
``epilogue``: the detect decode, top-k and NMS, or the pose heatmap
decode.  Their kernels are generic (sorts, reductions, gathers), so
they are told apart by stage, not by name: the epilogue is profiled
alone on the forward's dense outputs, and the forward alone; the wall
time is the whole callable's.  The train step runs ``--model``'s config
at its batch on a seeded uint8 batch already on the device, through the
trainer's own ``train_step``: random pixels and labels for a
classifier (through ``train_ingest``, or for a grayscale one the MNIST
normalize); for YOLOv3 and CenterNet the seeded synthetic scenes of
``data/detection.py`` (1-3 boxes an image), for the stacked hourglass
the seeded synthetic poses of ``data/pose.py``, un-augmented, with
their encoded labels.  A GAN recipe (``dcgan``, ``cyclegan``) profiles
one adversarial step (``core/adversarial.py``) at its batch on seeded
uint8 images (MNIST-sized noise, or the synthetic unpaired domains at
its size), CycleGAN's with valid pooled fakes; its generate bucket
takes seeded latents (DCGAN's float32 wire) or uint8 images, and its
``epilogue`` group is the uint8 encode.  Where the profiler records no
device time, those fields are null.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from deep_vision_tpu_torch.core.device import (
    configure_precision,
    resolve_device,
)

CONV_MARKERS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90_",
                "implicit", "nvjet")


def kernel_group(name: str, stage: str = "forward") -> str:
    """The group of a kernel launched in ``stage`` ("forward", "step"
    or "epilogue": every kernel of the detect epilogue is its own)."""
    if stage == "epilogue":
        return "epilogue"
    low = name.lower()
    for kernel in ("serve_ingest", "train_ingest", "best_iou_max"):
        if kernel in low:
            return kernel
    if any(m in low for m in CONV_MARKERS):
        return "conv"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer"
    return "other"


def _profiled(call, device: torch.device, iters: int, top: int,
              unit: str, stage: str = "forward") -> dict:
    """Run ``call`` twice to warm up, then ``iters`` times under the
    profiler; wall and device milliseconds per call (``unit``), the
    kernels grouped by :func:`kernel_group` for ``stage``."""
    from torch.profiler import ProfilerActivity, profile

    on_cuda = device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    for _ in range(2):
        call()
    sync()
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        # kernel rows only: the operator rows above them carry the same
        # device time again
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        dev_us = e.self_device_time_total
        if dev_us <= 0:
            continue
        g = kernel_group(e.key, stage)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e3 / iters
        kernels.append((dev_us / 1e3 / iters, e.count // iters, e.key))
    kernels.sort(reverse=True)
    busy = sum(groups.values()) if groups else None
    return {"device": str(device), f"wall_ms_per_{unit}": wall_ms,
            f"device_busy_ms_per_{unit}": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "device_ms_by_group": groups or None,
            f"launches_per_{unit}": sum(n for _, n, _ in kernels),
            "top_kernels": [{"ms": ms, "launches": n, "name": name[:120]}
                            for ms, n, name in kernels[:top]]}


def profile_bucket(sm, bucket: int, iters: int = 5, top: int = 12) -> dict:
    """Profile ``iters`` calls of ``sm``'s ``bucket`` callable.  Where
    the workload fuses an epilogue (detect decode on the device), the
    forward without it and the epilogue on the forward's outputs are
    profiled apart, and ``device_ms_by_group`` holds both: the
    forward's groups and ``epilogue``."""
    fn = sm.compile_bucket(bucket)
    gen = torch.Generator().manual_seed(0)
    shape = (bucket, *sm.input_shape)
    x = torch.randn(shape, generator=gen) \
        if sm.wire_torch_dtype.is_floating_point else \
        torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    x = x.to(sm.device)
    rep = {"bucket": bucket,
           **_profiled(lambda: fn(x), sm.device, iters, top, "forward")}
    post = sm.workload.make_epilogue(sm)
    if post is None:
        return rep
    forward = sm.compile_bucket(bucket, epilogue=False)
    fwd = _profiled(lambda: forward(x), sm.device, iters, top, "forward")
    out = forward(x)
    with torch.inference_mode():
        epi = _profiled(lambda: post(out), sm.device, iters, top, "call",
                        "epilogue")
    groups = None
    if fwd["device_ms_by_group"] is not None:
        groups = dict(fwd["device_ms_by_group"],
                      epilogue=epi["device_busy_ms_per_call"] or 0.0)
    rep.update(device_ms_by_group=groups, forward_only=fwd, epilogue=epi)
    return rep


def profile_train_step(trainer, state, batch: dict, iters: int = 3,
                       top: int = 12) -> dict:
    """Profile ``iters`` of ``trainer``'s train steps on ``batch``
    (``state``: a TrainState, or the adversarial trainer's dict)."""
    def step():
        trainer.train_step(state, batch)

    return {"batch": len(next(iter(batch.values()))),
            **_profiled(step, trainer.device, iters, top, "step")}


def _gan_train_main(cfg, device) -> dict:
    """One adversarial step of ``cfg`` (``dcgan`` or ``cyclegan``) at its
    batch on a seeded uint8 batch on the device."""
    import tempfile

    import numpy as np

    from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
    from deep_vision_tpu_torch.core.trainer import to_device
    from deep_vision_tpu_torch.data.gan import synthetic_unpaired
    from deep_vision_tpu_torch.models import gan
    from deep_vision_tpu_torch.ops.preprocess import make_gan_preprocess
    from deep_vision_tpu_torch.tasks.gan import CycleGANTask, DCGANTask

    dtype = torch.bfloat16 if cfg.half_precision else torch.float32
    rng = np.random.default_rng(0)
    if cfg.task == "gan_dcgan":
        task = DCGANTask(lambda: gan.DCGANGenerator(dtype=dtype),
                         lambda: gan.DCGANDiscriminator(dtype=dtype),
                         opt=cfg.optimizer)
        batch = {"image": rng.integers(0, 256, (cfg.batch_size, 28, 28, 1),
                                       dtype=np.uint8)}
    else:
        task = CycleGANTask(lambda: gan.CycleGANGenerator(dtype=dtype),
                            lambda: gan.PatchGANDiscriminator(dtype=dtype),
                            opt=cfg.optimizer)
        a, b = synthetic_unpaired(2 * cfg.batch_size, cfg.image_size,
                                  device_normalize=True)
        fakes = (a[cfg.batch_size:].astype(np.float32) / 127.5 - 1.0,
                 b[cfg.batch_size:].astype(np.float32) / 127.5 - 1.0)
        task.host_update({"fake_a2b": torch.from_numpy(fakes[1]),
                          "fake_b2a": torch.from_numpy(fakes[0])})
        batch = task.host_prepare({"image_a": a[:cfg.batch_size],
                                   "image_b": b[:cfg.batch_size]})
    with tempfile.TemporaryDirectory() as work:
        trainer = AdversarialTrainer(cfg, task, workdir=work,
                                     preprocess_fn=make_gan_preprocess(),
                                     device=device)
        states = trainer.init_states()
        return profile_train_step(trainer, states, to_device(batch, device))


def _classification_batch(cfg):
    import numpy as np

    from deep_vision_tpu_torch.ops.preprocess import (
        make_imagenet_preprocess,
        make_mnist_preprocess,
    )
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(
        0, 256, (cfg.batch_size, cfg.image_size, cfg.image_size,
                 cfg.channels), dtype=np.uint8),
        "label": rng.integers(0, cfg.num_classes,
                              cfg.batch_size).astype(np.int64)}
    pre = make_mnist_preprocess() if cfg.channels == 1 \
        else make_imagenet_preprocess()
    return (batch, ClassificationTask(cfg.num_classes, cfg.label_smoothing),
            pre)


def _detection_batch(cfg):
    from deep_vision_tpu_torch.data.detection import (
        CenterNetLoader,
        DetectionLoader,
        synthetic_detection_dataset,
    )
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu_torch.tasks.centernet import CenterNetTask
    from deep_vision_tpu_torch.tasks.detection import YoloTask

    samples = synthetic_detection_dataset(
        cfg.batch_size, cfg.image_size, min(cfg.num_classes, 3), seed=0)
    if cfg.task == "centernet":
        loader_cls, task = CenterNetLoader, CenterNetTask(cfg.num_classes)
    else:
        loader_cls, task = DetectionLoader, YoloTask(cfg.num_classes)
    loader = loader_cls(samples, cfg.batch_size, cfg.num_classes,
                        cfg.image_size, train=False, device_normalize=True)
    batch = next(iter(loader))
    batch.pop("weight")
    return batch, task, make_scale_preprocess()


def _pose_batch(cfg):
    from deep_vision_tpu_torch.data.pose import (
        PoseLoader,
        synthetic_pose_dataset,
    )
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu_torch.tasks.pose import PoseTask

    samples = synthetic_pose_dataset(cfg.batch_size, cfg.image_size,
                                     cfg.num_classes, seed=0)
    loader = PoseLoader(samples, cfg.batch_size, cfg.image_size,
                        cfg.image_size // 4, cfg.num_classes, train=False,
                        device_normalize=True)
    batch = next(iter(loader))
    batch.pop("weight")
    return batch, PoseTask(), make_scale_preprocess()


#: the seeded train batch of each task
TRAIN_BATCHES = {"classification": _classification_batch,
                 "detection": _detection_batch,
                 "centernet": _detection_batch, "pose": _pose_batch}


def _train_main(args, device) -> dict:
    import tempfile

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer, to_device

    cfg = get_config(args.model)
    if str(cfg.task).startswith("gan_"):
        return _gan_train_main(cfg, device)
    batch, task, preprocess_fn = TRAIN_BATCHES[cfg.task](cfg)
    batch = to_device(batch, device)
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(cfg, cfg.model(), task, workdir=work,
                          preprocess_fn=preprocess_fn, device=device)
        state = trainer.init_state()
        return profile_train_step(trainer, state, batch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--infer-dtype", choices=("float32", "bfloat16", "int8"),
                   default="int8")
    p.add_argument("--bucket", type=int, default=32)
    p.add_argument("--train", action="store_true",
                   help="profile train steps instead of a serving bucket")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    device = resolve_device(args.device)
    configure_precision()
    if args.train:
        print(json.dumps(_train_main(args, device)), flush=True)
        return 0
    sm = ModelRegistry().load_checkpoint(args.model, args.weights,
                                         wire_dtype="uint8",
                                         infer_dtype=args.infer_dtype,
                                         device=device)
    print(json.dumps(profile_bucket(sm, args.bucket)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
