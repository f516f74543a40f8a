"""Training CLI for one GPU.

    python -m deep_vision_tpu_torch.cli.train -m resnet50 \\
        --data-format records --data-root D --workdir W [--resume] \\
        [--epochs N] [--batch-size B] [--num-workers K] [--device cuda]
    python -m deep_vision_tpu_torch.cli.train -m resnet50 --synthetic ...
    python -m deep_vision_tpu_torch.cli.train -m inception3 \\
        --data-root D --workdir W [--resume]   # or alexnet1, vgg16, ...
    python -m deep_vision_tpu_torch.cli.train -m lenet5 \\
        --data-root MNIST_DIR --workdir W [--resume]
    python -m deep_vision_tpu_torch.cli.train -m yolov3_coco \\
        --data-root D --workdir W [--resume] [--num-workers K]
    python -m deep_vision_tpu_torch.cli.train -m centernet \\
        --data-root D --workdir W [--resume] [--num-workers K]
    python -m deep_vision_tpu_torch.cli.train -m hourglass104 \\
        --data-root D --workdir W [--resume] [--num-workers K]
    python -m deep_vision_tpu_torch.cli.train -m dcgan \
        --data-root MNIST_DIR --workdir W [--resume]   # or --synthetic
    python -m deep_vision_tpu_torch.cli.train -m cyclegan \
        --synthetic [--synthetic-size N] --workdir W [--resume]
    python -m deep_vision_tpu_torch.cli.train --list -m x
    ... [--scan-steps K] [--grad-accum A] [--ema-decay D] \
        [--momentum-dtype bfloat16]

Port of ``deep_vision_tpu/cli/train.py`` (``build_parser``, ``main``'s
classification branch, ``build_classification_val_loader``,
``_main_detection`` and ``_main_pose``) on the records input: ``D``
holds ``train-*.dvrec`` and ``val-*.dvrec`` shards with raw uint8
payloads (``prepare_data --store raw``).  Classification: the host
reads, flips and crops uint8 pixels; the ``train_ingest`` CUDA kernel
jitters and normalizes each train batch on the card.  LeNet-5 and its
tiers (``-m lenet5``, ``lenet5_nano``, ``lenet5_big``) read MNIST's
idx-ubyte files from ``D`` instead: uint8 images padded to 32×32, which
the card standardizes with the MNIST statistics.  Detection
(``-m yolov3_coco`` and the other YOLOv3 configs, ``-m centernet``): the
host flips, crops (YOLOv3 only), resizes and encodes labels; the card
scales the uint8 batch to [0, 1], and YOLOv3's loss runs its ignore mask
through the ``best_iou_max`` CUDA kernel.  Pose (``-m hourglass104``):
the host crops around the keypoints, flips, resizes and draws the
heatmaps; the card scales the batch to [0, 1].  ``--synthetic`` trains
on seeded synthetic scenes or poses instead.  The GAN family (``-m
dcgan``, ``-m cyclegan``; ``_main_gan``) trains through the adversarial
trainer on uint8 batches the card scales to [-1, 1]: DCGAN on MNIST's
``train-images-idx3-ubyte[.gz]`` under ``D`` (or synthetic digits),
CycleGAN on ``train_a-*``/``train_b-*.dvrec`` shards of encoded images
(``prepare_data unpaired``; decoding them needs PIL) or on seeded
synthetic domains.  The recipe options take the reference's flags and
config fields: ``--scan-steps`` (``scan_steps``: on the card a captured
CUDA graph of the guarded step; DCGAN too, CycleGAN per step),
``--grad-accum`` (``grad_accum_steps``), ``--ema-decay`` (``ema_decay``:
eval and the workdir's serving use the EMA) and ``--momentum-dtype
bfloat16`` (``optimizer.momentum_dtype``).  Runs on CUDA unless given
``--device cpu``; without a GPU it raises.
"""

from __future__ import annotations

import argparse

from deep_vision_tpu_torch.core.device import (
    configure_precision,
    resolve_device,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="deep_vision_tpu_torch trainer")
    p.add_argument("-m", "--model", required=True,
                   help="config name (see --list)")
    p.add_argument("--data-root", default=None,
                   help="directory of train-*/val-*.dvrec shards "
                        "(raw payloads; detection: stored at the input size)")
    p.add_argument("--data-format", choices=("records",), default="records",
                   help="classification input: dvrec shards with raw uint8 "
                        "payloads (the folder/JPEG layout is not ported)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data smoke run (no dataset needed)")
    p.add_argument("--synthetic-size", type=int, default=1024)
    p.add_argument("-c", "--resume", action="store_true",
                   help="resume from the latest checkpoint in --workdir")
    p.add_argument("--workdir", default=None)
    p.add_argument("--epochs", type=int, default=None,
                   help="override config")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override config")
    p.add_argument("--scan-steps", type=int, default=None,
                   help="train steps a group: on the card one captured "
                        "CUDA graph of the guarded step, replayed a step "
                        "at a time, metrics read once a group")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="gradient-accumulation microbatches per optimizer "
                        "update (the recipe's batch in a fraction of the "
                        "memory)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="params EMA decay (e.g. 0.9999); eval and serving "
                        "use the averaged copy")
    p.add_argument("--momentum-dtype", choices=("bfloat16",), default=None,
                   help="store the SGD momentum in bfloat16 (changes the "
                        "update's numerics by ~1e-3: off for parity "
                        "recipes)")
    p.add_argument("--image-size", type=int, default=None,
                   help="override config (smoke runs at low resolution)")
    p.add_argument("--num-workers", type=int, default=16,
                   help="record read/crop worker processes (0 = inline)")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="device batches staged ahead of the step "
                        "(default 2)")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of steps 10-20 → "
                        "workdir/profile")
    p.add_argument("--list", action="store_true",
                   help="list configs and exit")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


#: the configs that train on MNIST's idx-ubyte files
MNIST_CONFIGS = ("lenet5_nano", "lenet5", "lenet5_big")


def build_classification_val_loader(cfg, data_root: str, split: str,
                                    batch: int, num_workers: int = 4):
    """Eval loader over ``split`` at the config's crop size: records, or,
    where ``data_root`` holds MNIST's idx-ubyte files (any name
    ``data/mnist.load_mnist`` accepts), MNIST's host-normalized images.
    Returns ``(loader, dataset_size)``."""
    import glob
    import os

    from deep_vision_tpu_torch.data.imagenet import ImageNetLoader
    from deep_vision_tpu_torch.data.transforms import imagenet_resize_for

    if glob.glob(os.path.join(data_root, "t10k-images*idx3-ubyte*")):
        from deep_vision_tpu_torch.data.loader import ArrayLoader
        from deep_vision_tpu_torch.data.mnist import load_mnist

        data = load_mnist(data_root, "train" if split == "train" else "test")
        loader = ArrayLoader(data, batch, shuffle=False, drop_last=False,
                             pad_last=True)
        return loader, len(data["label"])
    loader = ImageNetLoader.from_records(
        data_root, split, batch, train=False, image_size=cfg.image_size,
        resize=imagenet_resize_for(cfg.image_size), num_workers=num_workers)
    return loader, len(loader.ds)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from deep_vision_tpu_torch.core.config import get_config, list_configs

    if args.list:
        print("\n".join(list_configs()))
        return 0
    device = resolve_device(args.device)
    configure_precision()

    cfg = get_config(args.model)
    if args.epochs is not None:
        cfg.total_epochs = args.epochs
    if args.batch_size is not None:
        cfg.batch_size = cfg.eval_batch_size = args.batch_size
    if args.scan_steps is not None:
        cfg.scan_steps = args.scan_steps
    if args.grad_accum is not None:
        cfg.grad_accum_steps = args.grad_accum
    if args.ema_decay is not None:
        cfg.ema_decay = args.ema_decay
    if args.momentum_dtype is not None:
        cfg.optimizer.momentum_dtype = args.momentum_dtype
    if args.image_size is not None:
        cfg.image_size = args.image_size
    if args.prefetch_depth is not None:
        cfg.prefetch_depth = args.prefetch_depth
    if cfg.task in GAN_TASKS:
        print(f"device: {device}", flush=True)
        return _main_gan(args, cfg, device)
    build = LOADERS.get(cfg.task)
    if build is None:
        raise NotImplementedError(
            f"task '{cfg.task}' is not ported; have "
            f"{sorted([*LOADERS, *GAN_TASKS])}")

    print(f"device: {device}", flush=True)
    loaders = []
    try:
        task, train_loader, val_loader, preprocess_fn = build(args, cfg,
                                                              loaders)
        from deep_vision_tpu_torch.core.trainer import Trainer

        trainer = Trainer(cfg, cfg.model(), task, workdir=args.workdir,
                          preprocess_fn=preprocess_fn, device=device)
        if args.profile:
            trainer.profile_steps = (10, 20)
        state = trainer.fit(train_loader, val_loader, resume=args.resume)
        final = trainer.evaluate(state, val_loader)
    finally:
        for loader in loaders:
            loader.close()
    print("final:", " ".join(f"{k}={v:.4f}" for k, v in final.items()),
          flush=True)
    return 0


def _classification_loaders(args, cfg, loaders: list):
    """(task, train loader, val loader, preprocess_fn) for a classifier;
    loaders that own worker pools are appended to ``loaders``."""
    from deep_vision_tpu_torch.data.loader import ArrayLoader
    from deep_vision_tpu_torch.tasks.classification import ClassificationTask

    task = ClassificationTask(cfg.num_classes, cfg.label_smoothing)
    if args.synthetic:
        from deep_vision_tpu_torch.data.synthetic import (
            synthetic_classification,
        )

        train_data = synthetic_classification(
            args.synthetic_size, cfg.image_size, cfg.channels,
            cfg.num_classes, seed=1)
        val_data = synthetic_classification(
            max(args.synthetic_size // 4, cfg.batch_size),
            cfg.image_size, cfg.channels, cfg.num_classes, seed=2)
        train_loader = ArrayLoader(train_data, cfg.batch_size,
                                   seed=cfg.seed)
        val_loader = ArrayLoader(val_data, cfg.eval_batch_size,
                                 shuffle=False, drop_last=False,
                                 pad_last=True)
        return task, train_loader, val_loader, None
    if not args.data_root:
        raise SystemExit("--data-root is required without --synthetic")
    if args.model in MNIST_CONFIGS:
        from deep_vision_tpu_torch.data.mnist import load_mnist
        from deep_vision_tpu_torch.ops.preprocess import (
            make_mnist_preprocess,
        )

        # the uint8 wire: padded raw bytes cross to the card, which
        # standardizes them
        train_loader = ArrayLoader(
            load_mnist(args.data_root, "train", device_normalize=True),
            cfg.batch_size, seed=cfg.seed)
        val_loader = ArrayLoader(
            load_mnist(args.data_root, "test", device_normalize=True),
            cfg.eval_batch_size, shuffle=False, drop_last=False,
            pad_last=True)
        return task, train_loader, val_loader, make_mnist_preprocess()
    from deep_vision_tpu_torch.data.imagenet import ImageNetLoader
    from deep_vision_tpu_torch.data.transforms import imagenet_resize_for
    from deep_vision_tpu_torch.ops.preprocess import make_imagenet_preprocess

    train_loader = ImageNetLoader.from_records(
        args.data_root, "train", cfg.batch_size, train=True,
        seed=cfg.seed, image_size=cfg.image_size,
        resize=imagenet_resize_for(cfg.image_size),
        num_workers=args.num_workers)
    loaders.append(train_loader)
    val_loader, _ = build_classification_val_loader(
        cfg, args.data_root, "val", cfg.eval_batch_size,
        num_workers=args.num_workers)
    loaders.append(val_loader)
    return task, train_loader, val_loader, make_imagenet_preprocess()


def _detection_loaders(args, cfg, loaders: list):
    """(task, train loader, val loader, preprocess_fn) for YOLOv3 or
    CenterNet: uint8 batches from raw-payload detection records (or
    ``--synthetic`` scenes), scaled to [0, 1] on the device."""
    from deep_vision_tpu_torch.data.detection import (
        CenterNetLoader,
        DetectionLoader,
        synthetic_detection_dataset,
    )
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess

    if cfg.task == "centernet":
        from deep_vision_tpu_torch.tasks.centernet import CenterNetTask

        task, loader_cls = CenterNetTask(cfg.num_classes), CenterNetLoader
    else:
        from deep_vision_tpu_torch.tasks.detection import YoloTask

        task, loader_cls = YoloTask(cfg.num_classes), DetectionLoader
    if args.synthetic:
        train_samples = synthetic_detection_dataset(
            args.synthetic_size, cfg.image_size, min(cfg.num_classes, 3),
            seed=1)
        val_samples = synthetic_detection_dataset(
            max(args.synthetic_size // 4, cfg.batch_size), cfg.image_size,
            min(cfg.num_classes, 3), seed=2)
    else:
        from deep_vision_tpu_torch.data.records import (
            load_detection_records,
        )

        if not args.data_root:
            raise SystemExit("--data-root is required without --synthetic")
        # the train split is read by the worker pool (bounded memory); the
        # val split is revisited every epoch inline, so keep its images
        train_samples = load_detection_records(
            args.data_root, "train", cache_decoded=args.num_workers == 0)
        val_samples = load_detection_records(args.data_root, "val",
                                             cache_decoded=True)
    # in-memory synthetic samples need no reading: a pool would only add
    # pickling
    train_loader = loader_cls(
        train_samples, cfg.batch_size, cfg.num_classes, cfg.image_size,
        train=True, seed=cfg.seed, device_normalize=True,
        num_workers=0 if args.synthetic else args.num_workers)
    loaders.append(train_loader)
    val_loader = loader_cls(
        val_samples, cfg.eval_batch_size, cfg.num_classes, cfg.image_size,
        train=False, device_normalize=True)
    return task, train_loader, val_loader, make_scale_preprocess()


def _pose_loaders(args, cfg, loaders: list):
    """(task, train loader, val loader, preprocess_fn) for the stacked
    hourglass: uint8 crops from raw-payload pose records (or
    ``--synthetic`` poses) with their heatmaps, scaled to [0, 1] on the
    device."""
    from deep_vision_tpu_torch.data.pose import (
        PoseLoader,
        synthetic_pose_dataset,
    )
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu_torch.tasks.pose import PoseTask

    if args.synthetic:
        train_samples = synthetic_pose_dataset(
            args.synthetic_size, cfg.image_size, cfg.num_classes, seed=1)
        val_samples = synthetic_pose_dataset(
            max(args.synthetic_size // 4, cfg.batch_size), cfg.image_size,
            cfg.num_classes, seed=2)
    else:
        from deep_vision_tpu_torch.data.records import load_pose_records

        if not args.data_root:
            raise SystemExit("--data-root is required without --synthetic")
        train_samples = load_pose_records(
            args.data_root, "train", cache_decoded=args.num_workers == 0)
        val_samples = load_pose_records(args.data_root, "val",
                                        cache_decoded=True)
    heatmap_size = cfg.image_size // 4
    train_loader = PoseLoader(
        train_samples, cfg.batch_size, cfg.image_size, heatmap_size,
        cfg.num_classes, train=True, seed=cfg.seed, device_normalize=True,
        num_workers=0 if args.synthetic else args.num_workers)
    loaders.append(train_loader)
    val_loader = PoseLoader(
        val_samples, cfg.eval_batch_size, cfg.image_size, heatmap_size,
        cfg.num_classes, train=False, device_normalize=True)
    return PoseTask(), train_loader, val_loader, make_scale_preprocess()


def _main_gan(args, cfg, device) -> int:
    """DCGAN or CycleGAN through the adversarial trainer, on uint8
    batches that ``make_gan_preprocess`` scales on the device."""
    import torch

    from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
    from deep_vision_tpu_torch.models import gan as gan_models
    from deep_vision_tpu_torch.ops.preprocess import make_gan_preprocess
    from deep_vision_tpu_torch.tasks.gan import CycleGANTask, DCGANTask

    if args.profile:
        raise SystemExit("--profile is not ported for the GAN tasks; "
                         "profile a step with python -m "
                         "deep_vision_tpu_torch.obs.profile -m "
                         f"{args.model} --train")
    dtype = torch.bfloat16 if cfg.half_precision else torch.float32
    if cfg.task == "gan_dcgan":
        from deep_vision_tpu_torch.data.gan import GANLoader, mnist_gan_data

        if not args.synthetic and not args.data_root:
            raise SystemExit("--data-root is required without --synthetic")
        images = mnist_gan_data(None if args.synthetic else args.data_root,
                                n_synthetic=args.synthetic_size,
                                device_normalize=True)
        loader = GANLoader(images, cfg.batch_size, seed=cfg.seed)
        task = DCGANTask(lambda: gan_models.DCGANGenerator(dtype=dtype),
                         lambda: gan_models.DCGANDiscriminator(dtype=dtype),
                         opt=cfg.optimizer)
    else:
        from deep_vision_tpu_torch.data.gan import (
            UnpairedLoader,
            synthetic_unpaired,
        )

        if args.synthetic:
            a, b = synthetic_unpaired(args.synthetic_size, cfg.image_size,
                                      device_normalize=True)
        else:
            a, b = load_unpaired_records(args.data_root, cfg.image_size)
        loader = UnpairedLoader(a, b, cfg.batch_size, seed=cfg.seed)
        task = CycleGANTask(
            lambda: gan_models.CycleGANGenerator(dtype=dtype),
            lambda: gan_models.PatchGANDiscriminator(dtype=dtype),
            opt=cfg.optimizer)
    trainer = AdversarialTrainer(cfg, task, workdir=args.workdir,
                                 preprocess_fn=make_gan_preprocess(),
                                 device=device)
    states = trainer.fit(loader, epochs=cfg.total_epochs,
                         resume=args.resume)
    print("done: trained", ", ".join(states), flush=True)
    return 0


def load_unpaired_records(data_root: str, image_size: int):
    """``train_a-*``/``train_b-*.dvrec`` shards (``prepare_data
    unpaired``: encoded image payloads) → two uint8 (N, S, S, 3) arrays,
    each image decoded to RGB with PIL and resized to ``image_size``²
    (``data/transforms.resize_bilinear``, the reference's resize)."""
    import io

    import numpy as np

    from deep_vision_tpu_torch.data.records import list_shards, read_records
    from deep_vision_tpu_torch.data.transforms import resize_bilinear

    if not data_root:
        raise SystemExit("--data-root is required without --synthetic")
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding the unpaired image records needs PIL "
                          "(Pillow), which is not installed; train with "
                          "--synthetic instead") from e
    out = []
    for tag in ("a", "b"):
        shards = list_shards(data_root, f"train_{tag}")
        if not shards:
            raise FileNotFoundError(
                f"no train_{tag}-*.dvrec under {data_root} "
                "(run prepare_data unpaired)")
        imgs = []
        for sh in shards:
            for _, payload in read_records(sh):
                img = np.asarray(Image.open(io.BytesIO(payload))
                                 .convert("RGB"))
                imgs.append(resize_bilinear(img, image_size, image_size)
                            .astype(np.uint8))
        out.append(np.stack(imgs))
    return out[0], out[1]


#: the tasks of the adversarial trainer (``_main_gan``)
GAN_TASKS = ("gan_dcgan", "gan_cyclegan")
#: the input builder of each ported task of the Trainer
LOADERS = {"classification": _classification_loaders,
           "detection": _detection_loaders,
           "centernet": _detection_loaders,
           "pose": _pose_loaders}


if __name__ == "__main__":
    raise SystemExit(main())
