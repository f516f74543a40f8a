"""Dataset preparation CLI: raw downloads → dvrec shards.

    python -m deep_vision_tpu_torch.cli.prepare_data voc --voc-root VOCdevkit \\
        --out ./records --split train [--store jpeg|raw]
    python -m deep_vision_tpu_torch.cli.prepare_data coco \\
        --annotations instances_train2017.json --images train2017 --out ...
    python -m deep_vision_tpu_torch.cli.prepare_data mpii \\
        --annotations train.json --images images --out ...
    python -m deep_vision_tpu_torch.cli.prepare_data imagenet --src train_flat \\
        --labels imagenet_2012_metadata.txt --out ... [--store raw]
    python -m deep_vision_tpu_torch.cli.prepare_data imagenet-bboxes \\
        --xml-dir bbox --out-csv boxes.csv [--synsets synsets.txt]
    python -m deep_vision_tpu_torch.cli.prepare_data imagenet-flatten-train \\
        --src raw_train --dest train_flat
    python -m deep_vision_tpu_torch.cli.prepare_data imagenet-flatten-val \\
        --src raw_val --dest val_flat [--ground-truth GT --synsets S]
    python -m deep_vision_tpu_torch.cli.prepare_data unpaired --dir-a trainA \\
        --dir-b trainB --out ...
    python -m deep_vision_tpu_torch.cli.prepare_data celeba --attr list_attr.txt \\
        --images img_align_celeba --out-a male --out-b female

Port of ``deep_vision_tpu/cli/prepare_data.py``: the same subcommands,
flags and defaults, over ``data/prep.py``.  Preparation needs PIL (and
uses cv2 where installed); ``--store raw`` writes shards that a machine
with neither trains from.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="deep_vision_tpu_torch data prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    voc = sub.add_parser("voc")
    voc.add_argument("--voc-root", required=True)
    voc.add_argument("--year", default="2007")
    voc.add_argument("--names", default=None)

    coco = sub.add_parser("coco")
    coco.add_argument("--annotations", required=True)
    coco.add_argument("--images", required=True)

    mpii = sub.add_parser("mpii")
    mpii.add_argument("--annotations", required=True)
    mpii.add_argument("--images", required=True)

    imagenet = sub.add_parser("imagenet")
    imagenet.add_argument("--src", required=True)
    imagenet.add_argument("--labels", required=True)
    imagenet.add_argument("--bbox-csv", default=None,
                          help="imagenet-bboxes output; boxes go into "
                               "record headers")
    imagenet.add_argument("--store", choices=("jpeg", "raw"), default="jpeg",
                          help="raw: decode+rescale at build time, store "
                               "uint8 — the decode-free read path (and the "
                               "only one a machine without PIL can read)")
    imagenet.add_argument("--resize", type=int, default=256,
                          help="shorter-side rescale target for --store raw")
    for s_, r_ in ((voc, 416), (coco, 416), (mpii, 384)):
        s_.add_argument("--store", choices=("jpeg", "raw"), default="jpeg",
                        help="raw: decode+rescale at build time, store "
                             "uint8 — decode-free read path (labels are "
                             "rescale-invariant/rescaled at build)")
        s_.add_argument("--resize", type=int, default=r_,
                        help="shorter-side rescale target for --store raw")

    # XML bbox tree → relative-coords CSV
    bboxes = sub.add_parser("imagenet-bboxes")
    bboxes.add_argument("--xml-dir", required=True)
    bboxes.add_argument("--out-csv", required=True)
    bboxes.add_argument("--synsets", default=None,
                        help="restrict to challenge synsets (one id/line)")

    # raw download → the flat layout of data/imagenet.ImageNetFolder
    ftrain = sub.add_parser("imagenet-flatten-train")
    ftrain.add_argument("--src", required=True,
                        help="dir of per-synset tars or subdirectories")
    ftrain.add_argument("--dest", required=True)
    fval = sub.add_parser("imagenet-flatten-val")
    fval.add_argument("--src", required=True)
    fval.add_argument("--dest", required=True)
    fval.add_argument("--ground-truth", default=None,
                      help="ILSVRC2012 validation ground-truth file "
                           "(needed for the flat official layout)")
    fval.add_argument("--synsets", default=None)

    unpaired = sub.add_parser("unpaired")
    unpaired.add_argument("--dir-a", required=True)
    unpaired.add_argument("--dir-b", required=True)

    celeba = sub.add_parser("celeba")
    celeba.add_argument("--attr", required=True)
    celeba.add_argument("--images", required=True)
    celeba.add_argument("--out-a", required=True)
    celeba.add_argument("--out-b", required=True)
    celeba.add_argument("--attribute", default="Male")

    for s in (voc, coco, mpii, imagenet, unpaired):
        s.add_argument("--out", required=True)
        s.add_argument("--split", default="train")
        s.add_argument("--num-shards", type=int, default=8)
        s.add_argument("--num-workers", type=int, default=8)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from deep_vision_tpu_torch.data import prep

    if args.cmd == "voc":
        n = prep.prepare_voc(args.voc_root, args.out, args.split, args.names,
                             args.num_shards, args.num_workers, args.year,
                             store=args.store, resize=args.resize)
    elif args.cmd == "coco":
        n = prep.prepare_coco(args.annotations, args.images, args.out,
                              args.split, args.num_shards, args.num_workers,
                              store=args.store, resize=args.resize)
    elif args.cmd == "mpii":
        n = prep.prepare_mpii(args.annotations, args.images, args.out,
                              args.split, args.num_shards, args.num_workers,
                              store=args.store, resize=args.resize)
    elif args.cmd == "imagenet":
        n = prep.prepare_imagenet(args.src, args.labels, args.out, args.split,
                                  args.num_shards, args.num_workers,
                                  bbox_csv=args.bbox_csv, store=args.store,
                                  resize=args.resize)
    elif args.cmd == "imagenet-bboxes":
        n = prep.process_imagenet_bboxes(args.xml_dir, args.out_csv,
                                         args.synsets)
    elif args.cmd == "imagenet-flatten-train":
        n = prep.flatten_imagenet_train(args.src, args.dest)
    elif args.cmd == "imagenet-flatten-val":
        n = prep.flatten_imagenet_val(args.src, args.dest,
                                      args.ground_truth, args.synsets)
    elif args.cmd == "unpaired":
        n = prep.prepare_unpaired(args.dir_a, args.dir_b, args.out,
                                  args.split, args.num_shards,
                                  args.num_workers)
    else:
        n = prep.split_celeba_by_attribute(args.attr, args.images, args.out_a,
                                           args.out_b, args.attribute)
    print(f"prepared: {n}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
