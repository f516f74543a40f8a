"""Inference CLI: classify, detect, pose, sample, translate, export and
eval on one GPU.

    python -m deep_vision_tpu_torch.cli.infer classify -m resnet50 \\
        --workdir runs/x --images a.jpg b.jpg
    python -m deep_vision_tpu_torch.cli.infer detect -m yolov3_voc \\
        --workdir W --images street.jpg --score-threshold 0.3 \\
        [--out annotated.jpg]
    python -m deep_vision_tpu_torch.cli.infer pose -m hourglass104 \\
        --workdir W --images person.jpg [--out annotated.jpg]
    python -m deep_vision_tpu_torch.cli.infer sample -m dcgan --workdir W \\
        -n 16 --out samples.png
    python -m deep_vision_tpu_torch.cli.infer translate -m cyclegan \\
        --workdir W --images a.jpg --direction a2b --out-dir translated
    python -m deep_vision_tpu_torch.cli.infer export -m resnet50 \\
        --workdir W --out model.pt2
    python -m deep_vision_tpu_torch.cli.infer eval -m resnet50 \\
        --workdir W --data-root D [--pretrained P.pth] [--tf-preprocessing]
    ... [--device cuda]

Port of ``deep_vision_tpu/cli/infer.py`` over ``core/restore.py
load_state`` (a workdir of ``cli.train``: its newest complete
checkpoint, the EMA where it trained one).  Image files need PIL;
``classify`` normalizes on the host (``data/transforms.eval_transform``,
LeNet's MNIST preprocessing for one channel), detection and pose feed
[0, 1] pixels at the model's square size, and ``--out`` draws the boxes
or keypoints on the original photo (``viz.py``).  ``sample`` and
``translate`` run the generator of an adversarial checkpoint: the
reference draws DCGAN's latents from a JAX ``PRNGKey``, which torch
cannot reproduce, so they come from ``torch.Generator`` seeded with
``--seed``.  ``export`` writes the eval forward at batch 1 as a
``torch.export`` archive (``core/export.py``) that ``cli.serve
--stablehlo`` serves.  ``eval`` reports top-1/top-5 (classification),
VOC and COCO mAP (detection: YOLOv3's loss runs ``best_iou_max``, the
CUDA kernel on the card) or the val loss (pose); ``--pretrained``
evaluates a torch-format ``state_dict`` (``models/pretrained.py``)
instead of the workdir.  Runs on CUDA unless given ``--device cpu``;
without a GPU it raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from deep_vision_tpu_torch.core.device import (
    configure_precision,
    resolve_device,
)

#: the 20 PASCAL VOC classes in their canonical order: the names a
#: 20-class detector's outputs index
VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def _load_state(cfg, workdir, device):
    """The workdir's model in eval mode on ``device``: the restore path
    the serving registry uses too."""
    from deep_vision_tpu_torch.core.restore import load_state

    return load_state(cfg, workdir=workdir, tag="infer").to(device)


def _read_image(path, size, channels=3):
    """An image file → the model's float32 NHWC input (without batch):
    MNIST's preprocessing for one channel, else rescale, centre crop
    and the ImageNet normalize."""
    from PIL import Image

    if channels == 1:
        from deep_vision_tpu_torch.data.mnist import preprocess

        img = np.asarray(Image.open(path).convert("L").resize((size - 4,
                                                               size - 4)))
        return preprocess(img[None])[0][:size, :size]
    from deep_vision_tpu_torch.data.transforms import (
        eval_transform,
        imagenet_resize_for,
    )

    img = np.asarray(Image.open(path).convert("RGB"))
    return eval_transform(img, size, imagenet_resize_for(size))


def _read_square(path, size):
    """(original RGB uint8, [0, 1] float32 ``size``² input)."""
    from PIL import Image

    from deep_vision_tpu_torch.data.detection import resize_square

    orig = np.asarray(Image.open(path).convert("RGB"))
    return orig, resize_square(orig, size).astype(np.float32) / 255.0


@torch.no_grad()
def _forward(model, images, device):
    return model(torch.from_numpy(np.stack(images)).to(device))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="deep_vision_tpu_torch "
                                            "inference")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("classify", "detect", "pose", "sample", "translate",
                 "export", "eval"):
        s = sub.add_parser(name)
        s.add_argument("-m", "--model", required=True)
        s.add_argument("--workdir", required=True)
        s.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
        if name in ("classify", "detect", "pose", "translate"):
            s.add_argument("--images", nargs="+", required=True)
        if name == "detect":
            s.add_argument("--score-threshold", type=float, default=0.3)
        if name in ("detect", "pose"):
            s.add_argument("--out", default=None,
                           help="write annotated image(s): boxes or "
                                "keypoints drawn on the ORIGINAL photo; "
                                "several inputs get -<stem> suffixes")
            s.add_argument("--names", default=None,
                           help="class-names file (one per line; default: "
                                "VOC names for 20-class models)")
        if name == "eval":
            s.add_argument("--pretrained", default=None,
                           help="evaluate imported torch-format weights "
                                "(.pth) instead of a workdir checkpoint")
            s.add_argument("--data-root", default=None,
                           help="dvrec shards or an MNIST idx directory")
            s.add_argument("--synthetic", action="store_true")
            s.add_argument("--synthetic-size", type=int, default=64)
            s.add_argument("--batch-size", type=int, default=None)
            s.add_argument("--split", default="val")
            s.add_argument("--num-workers", type=int, default=4)
            s.add_argument("--tf-preprocessing", action="store_true",
                           help="evaluate with the TF 'ResNet "
                                "preprocessing' pipeline (match what the "
                                "checkpoint was trained with)")
        if name == "sample":
            s.add_argument("-n", type=int, default=16)
            s.add_argument("--out", default="samples.png")
            s.add_argument("--seed", type=int, default=1,
                           help="seed of the latents' torch.Generator")
        if name == "translate":
            s.add_argument("--direction", default="a2b")
            s.add_argument("--out-dir", default="translated")
        if name == "export":
            s.add_argument("--out", default="model.pt2")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from deep_vision_tpu_torch.core.config import get_config

    cfg = get_config(args.model)
    device = resolve_device(args.device)
    configure_precision()
    if args.cmd == "classify":
        model = _load_state(cfg, args.workdir, device)
        logits = _forward(model, [_read_image(f, cfg.image_size,
                                              cfg.channels)
                                  for f in args.images], device)
        top5 = np.argsort(logits.float().cpu().numpy(), -1)[:, -5:][:, ::-1]
        for f, t in zip(args.images, top5):
            print(f"{f}: top-5 classes {t.tolist()}")
    elif args.cmd == "detect":
        _cmd_detect(args, cfg, device)
    elif args.cmd == "pose":
        _cmd_pose(args, cfg, device)
    elif args.cmd == "sample":
        gen = _generator(cfg, args.workdir, "generator", device)
        z = sample_latents(args.n, gen.latent_dim, args.seed, device)
        imgs = generate(gen, z)
        _save_grid(imgs, args.out)
        print(f"wrote {args.n} samples to {args.out}")
    elif args.cmd == "translate":
        _cmd_translate(args, cfg, device)
    elif args.cmd == "eval":
        return _cmd_eval(args, cfg, device)
    elif args.cmd == "export":
        from deep_vision_tpu_torch.core.export import export_forward

        model = _load_state(cfg, args.workdir, device)
        n = export_forward(model, None,
                           (1, cfg.image_size, cfg.image_size, cfg.channels),
                           args.out)
        print(f"exported {n} bytes of torch.export archive to {args.out}")
    return 0


def _cmd_detect(args, cfg, device):
    from deep_vision_tpu_torch.tasks.detection import postprocess
    from deep_vision_tpu_torch.viz import draw_detections

    model = _load_state(cfg, args.workdir, device)
    read = [_read_square(f, cfg.image_size) for f in args.images]
    outs = _forward(model, [x for _, x in read], device)
    boxes, scores, classes, valid = (
        t.cpu().numpy() for t in postprocess(
            [o.float() for o in outs], cfg.num_classes,
            score_threshold=args.score_threshold))
    names = _class_names(args, cfg)
    for i, f in enumerate(args.images):
        n = int(valid[i].sum())
        print(f"{f}: {n} detections")
        for j in range(n):
            b = boxes[i, j].round(3).tolist()
            name = names[int(classes[i, j])] if names else int(classes[i, j])
            print(f"  class={name} score={float(scores[i, j]):.3f} box={b}")
        if args.out:
            from PIL import Image

            ann = draw_detections(read[i][0], boxes[i, :n], scores[i, :n],
                                  classes[i, :n], class_names=names)
            dst = _out_path(args.out, f, i, len(args.images))
            Image.fromarray(ann).save(dst)
            print(f"  annotated -> {dst}")


def _cmd_pose(args, cfg, device):
    """Heatmap argmax → keypoints scaled to the original photo."""
    from deep_vision_tpu_torch.viz import draw_keypoints

    model = _load_state(cfg, args.workdir, device)
    read = [_read_square(f, cfg.image_size) for f in args.images]
    out = _forward(model, [x for _, x in read], device)
    heat = (out[-1] if isinstance(out, (tuple, list)) else out) \
        .float().cpu().numpy()
    for i, f in enumerate(args.images):
        kp_img, conf = pose_keypoints(heat[i], read[i][0].shape[:2])
        print(f"{f}: " + " ".join(
            f"j{k}=({kp_img[k, 0]:.0f},{kp_img[k, 1]:.0f})"
            for k in range(len(kp_img))))
        if args.out:
            from PIL import Image

            ann = draw_keypoints(read[i][0], kp_img, visible=(conf > 0.2))
            dst = _out_path(args.out, f, i, len(args.images))
            Image.fromarray(ann).save(dst)
            print(f"  annotated -> {dst}")


def pose_keypoints(heat: np.ndarray, orig_hw) -> tuple:
    """One image's (H, W, K) heatmaps → ((K, 2) keypoints in the
    original photo's pixels, (K,) peak values)."""
    from deep_vision_tpu_torch.tasks.pose import heatmap_argmax

    oh, ow = orig_hw
    hh, hw = heat.shape[:2]
    kp = heatmap_argmax(heat) * np.array([ow / hw, oh / hh], np.float32)
    return kp, heat.max(axis=(0, 1))


def _generator(cfg, workdir, name, device):
    """Network ``name`` of the newest adversarial checkpoint under
    ``workdir``, in eval mode on ``device``."""
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.models import gan as gan_models

    ckpt = Checkpointer(os.path.join(workdir, "checkpoints"))
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {workdir}/checkpoints")
    gen = (gan_models.DCGANGenerator() if cfg.task == "gan_dcgan"
           else gan_models.CycleGANGenerator())
    gen.load_state_dict(ckpt.load(step)["states"][name]["model"])
    print(f"[infer] restored {name} from step {step}")
    return gen.eval().to(device)


def sample_latents(n: int, latent_dim: int, seed: int, device):
    """``n`` standard-normal DCGAN latents from a ``torch.Generator``
    seeded with ``seed`` on the CPU (the same draw on every device)."""
    z = torch.randn((n, latent_dim), generator=torch.Generator()
                    .manual_seed(int(seed)))
    return z.to(device)


@torch.no_grad()
def generate(gen, z: torch.Tensor) -> np.ndarray:
    """The generator's eval forward: (N, H, W, C) in [-1, 1]."""
    return gen(z).float().cpu().numpy()


def _cmd_translate(args, cfg, device):
    from PIL import Image

    from deep_vision_tpu_torch.data.detection import resize_square

    name = "gen_a2b" if args.direction == "a2b" else "gen_b2a"
    gen = _generator(cfg, args.workdir, name, device)
    os.makedirs(args.out_dir, exist_ok=True)
    for f in args.images:
        img = resize_square(np.asarray(Image.open(f).convert("RGB")),
                            cfg.image_size)
        x = img.astype(np.float32) / 127.5 - 1.0
        out = generate(gen, torch.from_numpy(x[None]).to(device))[0]
        out8 = ((out + 1) * 127.5).clip(0, 255).astype(np.uint8)
        dst = os.path.join(args.out_dir, os.path.basename(f))
        Image.fromarray(out8).save(dst)
        print(f"{f} -> {dst}")


def _cmd_eval(args, cfg, device):
    """Held-out evaluation: classification top-1/top-5, detection VOC
    mAP@0.5 and COCO mAP@[.5:.95], pose val loss."""
    from deep_vision_tpu_torch.core.trainer import Trainer

    batch = args.batch_size or cfg.eval_batch_size
    if cfg.task == "classification":
        task, loader, n = _classification_eval_loader(args, cfg, batch)
    elif cfg.task == "pose":
        task, loader, n = _pose_eval_loader(args, cfg, batch)
    elif cfg.task in ("detection", "centernet"):
        task, loader, n = _detection_eval_loader(args, cfg, batch)
    else:
        raise SystemExit(f"eval does not support task '{cfg.task}'")
    try:
        if args.pretrained:
            model = _load_pretrained_model(cfg, args)
        else:
            model = _load_state(cfg, args.workdir, device)
        trainer = Trainer(cfg, model, task, workdir=args.workdir,
                          device=device)
        metrics = trainer.evaluate(trainer.state_for(model), loader)
    finally:
        close = getattr(loader, "close", None)
        if close is not None:
            close()
    print(f"eval[{args.split}] n={n} "
          + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
    return 0


def _load_pretrained_model(cfg, args):
    """A fresh model with imported torch-format weights: no checkpoint
    needed, so a published recipe's top-1/top-5 is one command from its
    ``.pth`` file."""
    from deep_vision_tpu_torch.models.pretrained import (
        ARCH_IMPORTERS,
        import_pretrained,
    )

    if args.model not in ARCH_IMPORTERS:
        raise SystemExit(
            f"--pretrained supports {sorted(ARCH_IMPORTERS)} (torch-format "
            f"checkpoints); '{args.model}' has a different param tree")
    model = cfg.model()
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    merged, head_kept = import_pretrained(args.pretrained, args.model,
                                          model.state_dict())
    model.load_state_dict(merged)
    head = ("with checkpoint head" if head_kept
            else "head left fresh (class-count mismatch)")
    print(f"[eval] imported {args.model} weights from {args.pretrained} "
          f"({head})")
    return model.eval()


def _classification_eval_loader(args, cfg, batch):
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    task = ClassificationTask(cfg.num_classes, cfg.label_smoothing)
    if args.synthetic:
        from deep_vision_tpu_torch.data.loader import ArrayLoader
        from deep_vision_tpu_torch.data.synthetic import (
            synthetic_classification,
        )

        data = synthetic_classification(args.synthetic_size, cfg.image_size,
                                        cfg.channels, cfg.num_classes, seed=2)
        return task, ArrayLoader(data, batch, shuffle=False, drop_last=False,
                                 pad_last=True), args.synthetic_size
    if not args.data_root:
        raise SystemExit("--data-root is required without --synthetic")
    from deep_vision_tpu_torch.cli.train import build_classification_val_loader

    # the train CLI's val loader wiring, so eval cannot drift from it
    loader, n = build_classification_val_loader(
        cfg, args.data_root, args.split, batch,
        num_workers=args.num_workers,
        preprocessing="tf" if args.tf_preprocessing else "torch")
    return task, loader, n


def _pose_eval_loader(args, cfg, batch):
    from deep_vision_tpu_torch.data.pose import (
        PoseLoader,
        synthetic_pose_dataset,
    )
    from deep_vision_tpu_torch.tasks.pose import PoseTask

    if args.synthetic:
        samples = synthetic_pose_dataset(args.synthetic_size, cfg.image_size,
                                         cfg.num_classes, seed=2)
    else:
        from deep_vision_tpu_torch.data.records import load_pose_records

        if not args.data_root:
            raise SystemExit("--data-root is required without --synthetic")
        samples = load_pose_records(args.data_root, args.split)
    loader = PoseLoader(samples, batch, cfg.image_size, cfg.image_size // 4,
                        cfg.num_classes, train=False)
    return PoseTask(), loader, len(samples)


def _detection_eval_loader(args, cfg, batch):
    from deep_vision_tpu_torch.data.detection import (
        CenterNetLoader,
        DetectionLoader,
        synthetic_detection_dataset,
    )

    if cfg.task == "centernet":
        from deep_vision_tpu_torch.tasks.centernet import CenterNetTask

        task, loader_cls = CenterNetTask(cfg.num_classes), CenterNetLoader
    else:
        from deep_vision_tpu_torch.tasks.detection import YoloTask

        task, loader_cls = YoloTask(cfg.num_classes), DetectionLoader
    if args.synthetic:
        samples = synthetic_detection_dataset(
            args.synthetic_size, cfg.image_size, min(cfg.num_classes, 3),
            seed=2)
    else:
        from deep_vision_tpu_torch.data.records import load_detection_records

        if not args.data_root:
            raise SystemExit("--data-root is required without --synthetic")
        samples = load_detection_records(args.data_root, args.split)
    loader = loader_cls(samples, batch, cfg.num_classes, cfg.image_size,
                        train=False)
    return task, loader, len(samples)


def _class_names(args, cfg) -> list[str] | None:
    """--names file, else VOC names for 20-class models, else None
    (generic ``class N`` labels)."""
    if getattr(args, "names", None):
        with open(args.names) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if cfg.num_classes == 20:
        return list(VOC_CLASSES)
    return None


def _out_path(out: str, src: str, i: int, n: int) -> str:
    """One input → ``out`` verbatim; several → stem-suffixed siblings."""
    if n == 1:
        return out
    base, ext = os.path.splitext(out)
    stem = os.path.splitext(os.path.basename(src))[0]
    return f"{base}-{stem}{ext or '.jpg'}"


def grid_image(imgs, cols: int = 4) -> np.ndarray:
    """[-1, 1] (N, H, W, C) images → one uint8 grid, ``cols`` a row
    (2-D for one channel)."""
    imgs = ((np.asarray(imgs) + 1) * 127.5).clip(0, 255).astype(np.uint8)
    n, h, w, c = imgs.shape
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, im in enumerate(imgs):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = im
    return grid[..., 0] if c == 1 else grid


def _save_grid(imgs, path, cols: int = 4):
    from PIL import Image

    Image.fromarray(grid_image(imgs, cols)).save(path)


if __name__ == "__main__":
    raise SystemExit(main())
