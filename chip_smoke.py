#!/usr/bin/env python3
"""Drive the PyTorch port (deep_vision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build    — compile every CUDA source of the port (one nvcc each, in
              parallel) and print the seconds it took;
2. kernels  — hold ``serve_ingest`` against its plain PyTorch version on
              the card at the ResNet-50 bucket shapes (B, 224, 224, 3)
              for B in {1, 8, 32}, at (3, 17, 23, 3), at (4, 32, 32, 1)
              mnist and at the detect buckets (32, 416, 416, 3) and
              (32, 256, 256, 3) "unit", int8 and float32 outputs: int8 must
              be bit-identical, float32 within 1e-6 (both divide with
              IEEE rounding; the tolerance only covers a compiler
              contracting differently); then every channel count from 1
              to 4 and misaligned inputs (the scalar path), checks only.
              Device times come from CUDA events around replays of a
              CUDA graph of one call per input buffer (the buffers
              together exceed the 50 MB L2), so host overhead drops out;
              the eager per-call time of the wrapper is printed beside
              them, and so are each kernel's registers, shared memory
              and local (spill) bytes from ``cuobjdump
              --dump-resource-usage``;
3. serving  — boot ``cli/serve.py``'s server for ``resnet50`` at full
              width (224×224×3, 1000 classes), ``--wire-dtype uint8
              --infer-dtype int8 --warmup``, with seeded weights (non-zero
              BatchNorm scales) loaded through ``--weights``; POST 32
              ``/v1/classify`` requests, most of them concurrent, with
              the kernel's launch count set to 0 just before and read
              just after; every answer must be 200 with a top-5 that
              matches a direct call of the same model with the PLAIN
              ingest within the bf16 bound (3e-2·max|ref|), and top-1
              equal on every row whose direct top-1 margin exceeds that
              bound (most rows must: the seeded noise images are screened
              by the direct call for such a margin, since random weights
              leave most of them nearly tied); the same answers held
              against an ingest without the ImageNet mean/std must fail
              that check.
              Then the eager forward time of every bucket on the card,
              and one float32-infer request (serve_ingest with float32
              out);
4. train kernel — hold ``train_ingest`` against its plain PyTorch
              version on the card at (B, 224, 224, 3) for B in
              {256, 32, 1} and at (3, 17, 23, 3), with seeded factors:
              the outputs must be bit-identical.  Kernel device, eager
              call, plain, library and bound times as for serve_ingest,
              and the device time of ``train_ingest_factors`` (the int64
              image sum) beside them.  Then the edge cases, bit for bit:
              a contiguous view at an unaligned address (``x[1:]`` of a
              (129, 299, 299, 3) batch: the per-pixel loop), images
              smaller than a 16-pixel chunk (64, 2, 3, 3), and a batch
              beyond 65,535 images (70000, 4, 4, 3);
5. training — write seeded raw-payload dvrec shards (train 1024, val
              256 images, stored at 256×256×3, labels from 1000 classes)
              and call ``cli/train.py``'s ``main`` in process for
              ``resnet50`` at full width (224×224×3, 1000 classes, bf16,
              batch 256) for 2 epochs, then again with ``--resume
              --epochs 3``.  ``train_ingest`` must launch once per train
              step, every logged loss be finite, ``bad_steps`` stay 0, a
              checkpoint exist per epoch, and the resumed run start at
              epoch 3, step 8, with the saved checkpoint's parameters,
              buffers and momentum.  Prints the steady-state step ms (CUDA
              events), img/s, peak device memory and final top-1/top-5;
6. step check — one float32 train step (TF32 off) of full-width
              ResNet-50 on 8 seeded images with the same weights and
              factors, on the card (through the kernel) and on the CPU
              (through the plain version), from seeded weights whose last
              BN scale in every block is 1e-2 (at the trainer's zero a
              residual branch gets no gradient), so that every branch's
              update must be mostly gradient; the loss within 1e-4
              relative, the parameters' updates within 1e-3 and the
              running statistics' within 1e-4 in L2, and each tensor's
              within 5e-2 in L2 (``compare_steps`` says why); the same
              comparison with two images' factors swapped on the card's
              side must fail;
6a. native input — build the native dvrec reader
              (``data/native/dvrec_reader.cc``) with the machine's C++
              compiler and print the build seconds; rewrite the training
              phase's records from their seed and iterate
              ``ImageNetLoader.from_records(..., num_workers=0)`` at batch
              256, crop 224, train and eval over two epochs: every batch
              byte-equal to the numpy path's (``_native_batch`` patched
              to return None) and counted by the reader, one for every
              batch; a batch drawn with another seed must differ. Then
              ``cli.train -m resnet50 --data-format records --num-workers
              0 --epochs 1``: ``train_ingest`` launches = the steps, the
              reader's batches = the train batches + the eval batches
              (two evals: the epoch's and the final one); and
              ``cli.train --data-format folder`` fails with an error that
              names PIL (blocked for the check where the machine has
              it). Information only: host img/s of native against numpy
              assembly, and step ms and input stall at 0 workers beside
              the training phase's 4-worker run;
7. iou kernel — hold ``best_iou_max`` against its plain PyTorch version
              on the card at the yolov3_coco loss shapes (128, N, 100)
              for N = 3·52², 3·26², 3·13² and at a ``--grad-accum 2``
              microbatch's (64, 8112, 100), with 70% of the ground truths
              unmasked, and at (128, 8112, 100) on near ties (twinned
              ground truths, predictions a few ulps off them), at a
              COCO-like share (7% unmasked) and at the YOLOv3 run's share
              (2%); and at (3, 1000, 7), (2, 300, 600) and (2, 100, 0)
              with and without near ties.  The first input set of each
              has a wholly masked image, zero-area boxes, NaN prediction
              rows and inf, NaN and 1e30 ground truths; it and the first
              timed set must be bit-identical (a NaN matching any NaN).
              Kernel device, eager call, plain and bound times and the
              kernel's resources as above, each timed set with its own
              row; no single PyTorch call computes this function, so
              there is no library time;
8. yolo training — write seeded raw-payload detection shards (train 258,
              val 64 synthetic scenes stored at 416×416×3, boxes from 80
              classes) and call ``cli/train.py``'s ``main`` for
              ``yolov3_coco`` at full width (Darknet-53, 416², 80 classes,
              bf16, batch 128, Adam with clipping) for 1 epoch, then
              with ``--resume --epochs 2``.  ``best_iou_max`` must launch
              3 times per train step and per eval batch, every logged
              loss be finite, ``bad_steps`` stay 0, the ignore mask hide
              a non-zero share of predictions in a logged step, the
              val mAP be finite (the records are noise to a random model:
              its value is no accuracy measurement), a checkpoint exist
              per epoch, and the resumed run start at epoch 2, step 2,
              with the saved weights and Adam state.  Prints step ms
              (CUDA events), img/s, input stall, peak memory and mAP;
9. yolo step check — one float32 forward + backward (TF32 off) of
              full-width yolov3_coco on 2 seeded noise images at 128²
              (grids 16, 8, 4) whose ground truths are cut from the
              model's own jittered predictions (so the ignore mask hides
              some), same weights, on the card (through the kernel)
              and on the CPU (through the plain version): the loss and
              every per-scale component within 1e-4 relative, the
              gradients in L2 within 10× the CPU's own floor (its
              gradients from weights moved by 1e-7), at least 1e-3 over
              the model and 5e-2 per tensor; the ignore masks' flips are
              printed.  The same step with each image's boxes in the
              next image's ignore mask must break the loss bound;
10. detect serving — on heavily tied rows at the two decodes' shapes,
              ``topk_stable`` on the card must equal the CPU's.  Then for
              ``yolov3_coco`` (Darknet-53, 416², 80 classes) and
              ``centernet`` (2 stacks, order 5, 256² → 64², 80 classes)
              at full width: write seeded ``--weights`` through
              ``yolo_to_flax``/``centernet_to_flax`` (non-zero BN scales,
              the heads' output convs scaled to a trained model's spread,
              ``seeded_model`` says why), boot ``cli/serve.py`` with
              ``--wire-dtype uint8 --infer-dtype int8 --warmup``, buckets
              1–32, and POST 32 ``/v1/detect`` requests (8 sequential, 24
              concurrent) with the launch count set to 0 just before and
              read just after.  Every reply must be 200 and equal a direct
              call of the same model on the same image (PLAIN ingest, same
              forward, same epilogue) at one of the buckets: the kept set
              equal, scores and boxes within twice the card's own spread
              between buckets 1 and 32 (at least 2^-23 and the boxes'
              4-place rounding); the same replies held against an
              "imagenet" ingest must fail on most rows; ``serve_ingest``
              must launch once a batch the engine formed; D2H must be
              exactly K·28 bytes a padded image; a batch decoded with
              ``detect_decode="host"`` must answer byte for byte as device
              decode; a classify request to a detection model answers
              400.  Prints per bucket the forward and the epilogue ms
              apart, the client p50 and the concurrent img/s;
11. centernet training — write seeded raw-payload detection shards
              (train 66, val 32 synthetic scenes stored at 256×256×3,
              boxes from 80 classes) and call ``cli/train.py``'s ``main``
              for ``centernet`` at full width (2 stacks of the order-5
              hourglass, 256² → 64², 80 classes, bf16, batch 32, Adam)
              with 6 loader workers for 1 epoch, then with ``--resume
              --epochs 2``: every logged loss finite, ``bad_steps`` 0, a
              checkpoint per epoch, the resumed run at epoch 2, step 2,
              with the saved weights, BN statistics and Adam state, the
              val loss and mAP finite (the mAP is noise on these scenes).
              Prints step ms (CUDA events), img/s, input stall, peak
              memory and mAP.  No hand-written kernel runs on this path;
12. centernet step check — one float32 forward + backward (TF32 off) of
              full-width ``centernet`` on 2 seeded scenes at 128²,
              seeded weights as for serving (``seeded_model``), on the
              card and on the CPU: every conv and BN weight, the
              re-injection convs included, must get a gradient; the loss
              and its components within 1e-4 relative, the gradients in
              L2 within 10× the CPU's own floor (its gradients from
              weights moved by 1e-7), at least 1e-3 over the model and
              5e-2 per tensor; the same step with each image's labels
              on the next image must break the loss bound;
13. hourglass training and 14. step check — the same two phases for
              ``hourglass104`` (4 stacks of the order-4 hourglass at 256
              filters, 16 heatmaps, 256² → 64², bf16, batch 32, Adam) on
              seeded raw pose shards (train 66, val 32 synthetic poses
              stored at 256×256×3; the loader crops around the keypoints
              and resizes), the val loss finite;
15. pose serving — seeded ``hourglass104`` weights through
              ``stacked_hourglass_to_flax`` (non-zero BN scales, each
              stack's heatmap conv scaled to an output spread of 1),
              ``cli/serve.py`` int8 on the uint8 wire, buckets 1–32, 32
              ``/v1/pose`` requests (8 sequential, 24 concurrent) with the
              launch count set to 0 just before and read just after:
              every reply 200 and equal to a direct plain-ingest call at
              one of the buckets within twice the card's own spread
              between buckets 1 and 32 (scores, and keypoint positions);
              an "imagenet" ingest control must fail on most rows;
              ``serve_ingest`` must launch once a batch formed; D2H must
              be exactly 192 bytes a padded image; the device decode must
              equal a host decode of the same heatmaps copied out, and
              its unrefined peaks ``heatmap_argmax``; classify and detect
              requests answer 400 naming ``/v1/pose``.  Prints forward and
              epilogue ms per bucket, the client p50 and the concurrent
              img/s;
15a. pipeline training — ``parallel/pipelined.py`` on one card.  (a)
              ``cli.train -m hourglass104 --mesh data=1,pipe=4
              --microbatches 4 --device cuda:0`` (every pipe place is
              the card) on phase 13's records, an epoch and a resumed
              second (resume digest as phase 5), the checkpoints in the
              pipelined layout (``stem.*``, ``stages.<s>.*``); (b) under
              deterministic algorithms at 128², batch 8, float32:
              ``memory_allocated`` after placing the four places is the
              monolithic weights plus the last stage's re-injection convs
              (not four copies); at one microbatch the pipelined eval
              forward and one trainer step (Adam) equal the monolithic
              ``StackedHourglass``'s from the same weights bit for bit;
              at four the step equals the plain loop over the same four
              contiguous microbatches bit for bit, and misses the
              monolithic step's update by more than 1e-3 in L2 (the
              control); (c) ``load_state(workdir=...)`` of (a)'s workdir
              is the monolithic network, whose eval forward equals the
              pipelined model's from the same checkpoint (bit for bit at
              one microbatch, 1e-3 of the largest heatmap at four), and
              ``cli.serve -m hourglass104 --workdir`` (float32, uint8
              wire, buckets 1, 8, 32) serves those weights: 32
              ``/v1/pose`` answers 200
              (8 sequential ones equal to a direct bucket-1 call and
              not to an "imagenet" ingest's), ``serve_ingest``
              launches = batches; (d) a full-width ``centernet`` on ``pipe=2``, one
              step at 128², batch 8, equal bit for bit to the plain loop;
16. zoo kernels — within phases 2 and 4: ``train_ingest`` at the zoo's
              shapes (128, 224, 224, 3), (128, 299, 299, 3) (299·299·3
              bytes an image is no multiple of 16) and
              (1024, 224, 224, 3), and ``serve_ingest`` at (32, 32, 32, 1)
              "mnist" and (32, 299, 299, 3) "imagenet", int8 and float32,
              all bit for bit, timed against their bounds;
17. zoo steps — each of alexnet1, alexnet2, vgg16, vgg19, inception1,
              inception3, mobilenet1, shufflenet1, resnet50v2 and
              resnet50_modern: the port's Trainer at the recipe's batch
              and size, bf16, 3 steps on a seeded uint8 batch on the card
              through ``train_ingest``: finite losses, 0 bad steps (for
              inception1, whose reference recipe diverges at its init on
              noise, the guard must skip the non-finite steps and keep the
              weights finite: ``ZOO_DIVERGING``), one launch a step; step
              ms (CUDA events), img/s, peak memory;
18. zoo training — ``cli.train`` for inception3 (299², batch 128,
              RMSprop) on 256 train and 128 val seeded raw records stored
              at 341², 6 workers, and for lenet5 on seeded idx-ubyte files
              (20,000 + 10,000 images), each 2 epochs and a
              resumed third: a checkpoint an epoch, the resumed run
              starting from the last with its weights, BN statistics and
              optimizer state (RMSprop's nu and trace, Adam's moments and
              count), finite losses, no bad step, one ``train_ingest``
              launch an inception3 step; step ms, img/s, input stall,
              peak memory; then ``cli.serve -m lenet5 --workdir`` on
              the workdir ``cli.train`` wrote serves the weights of its
              preferred checkpoint bit for bit, and 32 /v1/classify
              answers equal a direct plain-ingest call at one of the
              buckets, one ``serve_ingest`` launch a batch;
19. zoo step checks — one float32 step of full-width mobilenet1
              (RMSprop, depthwise convs, BN) and inception1 (SGD, LRN, two
              aux heads, three dropouts) at 128², batch 8, on the card and
              on the CPU from the same seeded weights, factors and dropout
              masks (drawn on the CPU and copied): loss within 1e-4
              relative, updates within max(1e-3, 10× the CPU's own floor)
              in L2 (5e-2 a tensor), a gradient in every weight (every
              Inception branch and both aux heads); rolled labels must
              fail;
20. classify serving — lenet5 float32 ("mnist") and inception3 int8
              ("imagenet") on the uint8 wire, seeded weights with non-zero
              BN scales, buckets 1–32, 32 ``/v1/classify`` requests each (8
              sequential, 24 concurrent): every answer 200 and equal to a
              direct plain-ingest call at one of the buckets (top-5
              classes, logits within twice the card's own bucket-1-vs-32
              spread), a "unit" ingest (no mean and std) control failing
              on most rows, ``serve_ingest`` launches equal to the batches;
21. card    — print ``nvidia-smi --query-gpu=name,power.limit``;
22. GAN training — ``cli.train`` for dcgan (28²×1, latent 100, bf16,
              batch 256, Adam) on seeded idx-ubyte files of MNIST's shape
              (15,360 images: 60 steps an epoch, through the staged
              prefetcher) and for cyclegan (256²×3, 9 residual blocks,
              bf16, batch 1) on ``--synthetic --synthetic-size 32`` (32
              steps an epoch: the 50-image pools fill and replay in the
              second), each 2 epochs and then ``--resume --epochs 3``:
              finite losses, 0 bad steps, a checkpoint at epoch 2 (the
              recipes save every 2), the resumed run starting from it
              with every network's weights, BN statistics, Adam moments
              and count and the scheduler's state; step ms, img/s, input
              stall (DCGAN) and peak memory.  No hand-written kernel runs
              on these paths;
23. GAN step checks — one float32 adversarial step of dcgan (batch 64, z
              and dropout masks drawn on the CPU and copied) and of
              cyclegan (9 blocks, 128², batch 1, valid pooled fakes) on
              the card and on the CPU from the same seeded networks
              (non-zero BN scales): every loss within 1e-4 relative,
              gradients within max(1e-3, 10× the CPU's own floor) in L2
              (5e-2 a tensor), BN statistics within max(1e-4, 10×
              floor), Adam's first update (about lr·sign(g)) of the
              other sign on at most 1% of the elements it moves, a
              gradient in every parameter; rolled z (DCGAN) and swapped
              domains (CycleGAN) must fail;
23a. trainer recipes — (a) 16 steps of lenet5 (batch 64) and of dcgan
              (batch 256) from one seed with ``scan_steps`` 8 (3 eager
              warmup steps, then a captured CUDA graph of the guarded
              step replayed) and 1: final weights bit-identical or within
              1e-6 relative (which is printed); controls that must fail:
              dcgan replays whose generators are not re-seeded, and runs
              whose warmup steps are thrown away; step ms and host
              launches a step, eager and graph.  (b) ``cli.train -m
              resnet50 --scan-steps 4 --ema-decay 0.9999`` on the
              training phase's records (rewritten from their seed), 2
              epochs and a resumed third: ``train_ingest`` launches =
              steps (counted by replay), a profiler trace of one replay
              names the kernel, the logged losses within 1e-4 of the
              training phase's single-step run, no bad step, the EMA in
              the checkpoint and carried by the resume (which captures
              anew), ``load_state`` serving the EMA (digest of the EMA,
              not of the trained weights), and ``cli.serve --workdir``
              answering as a direct call of those weights with one
              ``serve_ingest`` launch a batch; peak memory and step ms
              beside the eager run's.  (c) ``cli.train -m yolov3_coco
              --grad-accum 2``, one epoch of 2 steps: ``best_iou_max``
              launches 3 a microbatch and 3 an eval batch, finite
              losses, no bad step; peak memory beside the yolo training
              phase's.  (d) lenet5 with SGD nesterov and a bfloat16
              momentum, 3 float32 steps on the card and on the CPU:
              losses within 1e-4, updates within ``compare_steps``'s
              bounds, the momentum stored in bfloat16; the same run
              without nesterov must fail.  Also in (a): yolov3_toy,
              centernet_toy and hourglass_toy through ``cli.train
              --synthetic`` (hourglass_toy also on a pipe grid of four
              places on ``cuda:0``), 8 steps with ``--scan-steps 4`` and
              1 under deterministic algorithms: checkpoints
              bit-identical;
24. generate serving — seeded generator weights (non-zero BN scales)
              through ``gan_to_flax``: dcgan at float32 (its float32
              latent wire forced over the requested uint8) and cyclegan
              on the uint8 wire at float32 and int8, buckets 1–32, 32
              ``/v1/generate`` requests each (8 sequential, 24
              concurrent; DCGAN ``{"seed"}``, CycleGAN ``pixels``) with
              ``serve_ingest``'s count set to 0 just before and read just
              after, where it must stay 0 (the "gan" prologue is plain):
              every answer 200 and its bytes within twice the card's own
              bucket-1-vs-32 spread in codes of a direct call at one of
              the buckets; the same request again answers the same bytes;
              an "imagenet" prologue control fails on most CycleGAN rows;
              D2H exactly 784 B (DCGAN) or 196,608 B (CycleGAN) a padded
              image; other verbs answer 400 naming ``/v1/generate``.
              Prints forward and epilogue ms per bucket, the client p50
              and the concurrent img/s.
24a. cli tools — ResNet-50 at full width on the training phase's
              records rewritten from their seed, two of the four train
              shards linked into a second root (2 steps at batch 256):
              (a) ``cli.train --pretrained P`` from a torchvision-layout
              ``.pth`` of seeded weights (``{"state_dict"}`` wrapper,
              ``module.`` prefixes, ``num_batches_tracked`` at 7) for
              one epoch: the state before the first step equals the
              checkpoint bit for bit (the counters left at 0), the head
              kept, ``train_ingest`` launched once a step, finite
              losses; (b) ``--host-normalize`` with ``--upload`` to a
              local mirror and ``--tf-preprocessing``, one epoch each:
              ``train_ingest`` launches +0, the H2D image bytes a step 4×
              the uint8 run's, the eval ran, event files under
              ``workdir/tensorboard``, the mirror holding the checkpoint
              byte for byte; (c) ``cli.infer eval --pretrained P`` on the
              256 val records: top-1 and top-5 equal to
              ``Trainer.evaluate`` on the same weights loaded directly,
              and ``cli.infer eval -m yolov3_coco`` on the YOLOv3
              phase's workdir and val records: ``best_iou_max`` 3 an
              eval batch, finite metrics; (d) ``cli.infer export`` of
              (a)'s workdir, ``cli.serve --stablehlo`` of the archive
              with that workdir: the exported forward at batch 1 equal
              to the eager one bit for bit, and 8 float32 requests
              answered bit for bit as the eager model answers through
              the same engine (``--workdir --wire-dtype float32``),
              ``serve_ingest`` never launched, ``--infer-dtype
              bfloat16`` refused.  Information
              only: the checkpoint's load seconds, step ms and input
              stall of each pipeline, export seconds and archive bytes,
              the exported and the eager forward's ms at batch 1;
24b. data parallel — ``parallel/`` on the card.  (a) Two processes
              (``chip_smoke.py --dp-rank``) join a gloo group, both on
              ``cuda:0`` (NCCL refuses two ranks on one device; gloo
              runs ``all_reduce`` and ``broadcast`` on CUDA tensors):
              one float32 guarded step of full-width ResNet-50 from the
              step check's start on the rows of a global batch of 256
              (128 a rank, deterministic algorithms) against this
              process's step on all 256: loss within 1e-4, running
              statistics within 1e-4 in L2, parameter updates within
              1e-3 in L2 and 5e-2 a tensor, each of the last two raised
              to twice this process's own floor (the step from weights
              moved by 1e-7) where that is higher; both ranks' weights
              bit-identical; the control, the ranks with rank-local
              BatchNorm statistics, fails those bounds.  Then
              ``Trainer.fit`` at the recipe's rank batch on each rank's
              shard of the training records (1024 + 256, 512 + 128 a
              rank): ``train_ingest`` launches = a rank's steps, the
              eval and the weights equal on both ranks, the checkpoints
              written by rank 0 alone, a fresh trainer's resume equal
              bit for bit to the saved state; ``yolov3_coco`` at 416²,
              a rank batch of 64, 2 steps: ``best_iou_max`` 3 a step a
              rank, the ranks' weights equal.  A 102 MB all-reduce is
              timed.  (b) Beside them, ``python -m torch.distributed.run
              --standalone --nproc-per-node 1`` runs ``cli.train -m
              resnet50 --mesh data=1 --scan-steps 2`` for an epoch (4
              steps) and its ``--resume``: the backend ``nccl``,
              ``train_ingest`` = steps, the losses within 1e-4 of the
              training phase's run with no mesh at the steps both log;

25. faults — ResNet-50 int8 on the uint8 wire through ``cli/serve.py``
              with ``--workdir`` (a port checkpoint of seeded weights,
              non-zero BN scales, written as ``cli.train`` writes it):
              with ``--faults compute:poison:nth=5 --fault-seed 0`` and a
              20 ms window, 2 sequential and 30 concurrent
              ``/v1/classify`` requests: exactly one answers 500
              "quarantined: poison", the other 31 answer 200 equal to a
              direct plain-ingest call at one of the buckets within twice
              the card's own bucket spread ("unit" control failing),
              quarantined 1, one batch failure, at least 3 retry
              executions, ``serve_ingest`` launches equal to the executed
              batches (pipelined and retried), ``/metrics`` parses, and
              ``/v1/stats`` shows the MFU of bucket 32 in (0, 1] from
              ``flop_counter`` FLOPs after 4 full batches.  Then a server
              with ``batcher:die:times=1`` restarts its batcher once and
              serves 8 requests, healthz 200; one with
              ``d2h:hang:hang_s=30:after=2:times=1`` fails the third batch with
              504 within its exec timeout (printed beside the time it
              took) and serves the fourth;
26. plane   — ``--models resnet50,yolov3_coco --workdir W`` int8 on the
              uint8 wire, ``--hbm-budget-mb`` halfway between the larger
              model's weight bytes and their sum: 3 rounds of sequential
              requests alternating the models (each switch evicts one and
              re-admits the other, then a repeat hits): every answer
              bit-identical to that model's bucket-1 answer when loaded
              alone; ``memory_allocated`` unmoved by a hit, equal every
              round while the same model is resident, and the two
              resident states apart by the two models' weight bytes
              (512-byte blocks) within 4 MiB of allocator slack; no
              bucket callable rebuilt; launches = batches.  A
              hot reload of a new step (step 1's classifier bias moved
              by 0.25 + seeded 1e-3 noise) under 4 closed-loop clients
              reaches ACTIVE v2 through shadow (10 top-1 comparisons) and
              canary (8 requests) with every client answer 200; answers
              then match direct plain-ingest calls on step 2's weights
              and ``/v1/models`` shows its digest; a step 3 with a NaN in
              the classifier's weight matrix and a step 4 with one in its
              bias (the shadow phase turned off for them) are each rolled
              back by the canary's error-rate gate, v2 stays active and
              answers finite; steps 4 and 3 truncated then make a fresh
              ``-m resnet50 --workdir`` boot serve step 2 with
              ``restore_fallback``;
27. fleet   — ResNet-50 int8 on the uint8 wire from a port checkpoint,
              served by ``ReplicatedEngine(devices=[cuda:0, cuda:0])``
              (two replicas on the one card, each its own weight copy and
              stream) behind the HTTP front end, warmed on its router
              thread: 16 sequential and 48 concurrent ``/v1/classify``
              requests with the launch count set to 0 just before and
              read just after, every answer 200 and bit-identical to the
              single engine's (the model's own bucket callable) at one of
              the buckets, both replicas routed, launches = batches, a
              "unit" ingest control failing on most rows; replica 1
              forced DEAD 24 requests into 96 concurrent ones: none lost,
              every answer again bit-identical at a bucket, an evacuation
              (timed from the kill), healthz 200 "degraded"; both DEAD:
              healthz 503 and a request shed (429); revived, a third
              replica added on cuda:0 and removed with a 10 s drain
              deadline under 4 closed-loop clients: every answer 200,
              ``memory_allocated`` (idle, cuBLAS's per-stream workspaces
              dropped) back within 4 MiB of its value before the add;
              the autoscaler on the real engine reads finite signals and
              a forced-pressure tick without a spare device counts one
              ``scale_errors`` and starts its cooldown.  Information
              only: a single engine and the fleet on a closed loop of
              192 requests, in turns;
28. deploy  — ``--models resnet50 --watch --watch-interval-s 0.5
              --gate-dir`` (32 seeded uint8 .npy, label-free agreement
              gate) over HTTP under 4 closed-loop clients: a step 2 (the
              classifier bias moved by 0.25) passes the gate after at
              least two polls and reaches ACTIVE through shadow (10
              comparisons) and canary (8 requests); a step 3 with a NaN
              in the classifier's weight matrix fails the gate
              (``gate_failed``), starts no reload, v2 keeps serving; every
              client answer 200; ``POST /v1/deploy/resnet50/revert``
              restores v1, whose sequential answers equal v1's before bit
              for bit; ``GET /v1/deploy/resnet50/history`` lists the six
              records in order, and again after a restart on the same
              workdir (step 3 removed first);
29. cascade — ``--models resnet34,resnet50,resnet152 --cascade
              resnet34:resnet50:resnet152 --cascade-quant-front`` from
              port checkpoints of seeded weights, the uint8 wire, tier 0
              int8 and the others bf16, clients addressing resnet152.
              Seeded random ResNets almost never agree on top-1, so the
              calibration is held to its machinery
              (``--cascade-min-agreement 0``, sample period 3, 12
              samples a hop): its escalation rate says nothing of a
              trained cascade's economics.  8 sequential requests, all
              ``X-DVT-Tier: big`` and equal to resnet152's own bucket
              callable at one of the buckets; then 4 closed-loop
              clients until dual-run calibration flips hop 0 to
              ``front``, whose answers must equal resnet34's direct
              call (top-5 classes, probabilities within twice the
              card's own bucket-1-vs-32 spread) at one of the buckets,
              with exactly 3·5·4 B of D2H a padded front image, while
              the same answers held against resnet152's calls must fail
              on most rows (a control); an always-big tenant stays on
              ``big``; a reload of resnet34 under the clients resets hop
              0 alone (the ledger's reset records), hop 1's sample
              survives and then serves ``t1``; a reload of resnet50 (its
              canary fed on its own route) resets hop 1 alone; every
              client answer 200; ``serve_ingest`` launches = the tiers'
              batches + the two reloads' warmups; tier errors 0; a new
              router restores the live thresholds from ``_cascade`` and
              refuses them once a tier's digest moved; the ladder pinned
              over HTTP: L1 pauses samples, L2 serves ``front`` marked
              ``X-DVT-Degraded`` to a standard tenant and ``big`` to a
              premium one (hop 0's threshold raised by hand above every
              confidence first); /metrics parses with the dvt_cascade_*
              and dvt_brownout_* series; last, a front tier whose
              callables raise after their forward (a control) counts
              tier errors, every answer still 200 from big.  The detect
              lane: ``yolov3_toy416:yolov3_coco``, both 416² int8, 8
              sequential requests and 4 clients: every answer 200 with
              its tier, a front answer's kept set equal to
              yolov3_toy416's direct call at one of the buckets,
              launches = batches, tier errors 0.  Information only:
              client p50 by tier and the escalation rate;
30. brownout — ``--models resnet50`` int8, one image a batch under a
              ``compute:latency:delay_ms=40`` fault, ``--brownout``
              (L1/L2/L3 at 20/60/240 ms of queue pressure, 25 ms ticks,
              3-tick release, 0.2 s cooldown), ``--qos`` premium
              (``shed_at=1.0``, always-big) and standard (0.5), a 64 MB
              response cache: 8 closed-loop standard clients take the
              ladder to L2 or more, premium requests meanwhile answer
              200, and once the clients stop and their last requests are
              answered the ladder walks back to L0 one level at a time,
              from L2 or more (polled every 2 ms); pinned at L2 then
              L3 under the clients, premium answers 200 at both and
              standard 200 at L2, 429 at L3; a reload to a step 2, then
              at L2 a payload answered before the reload answers the
              retired version's bytes from the cache with
              ``X-DVT-Degraded: 1``, and at L0 the new version's; no
              5xx anywhere; launches = batches + the reload's warmup;
              /metrics parses.  Information only: engage and release
              seconds, premium p50 under the clients at L2 and L3.
  gateway     two ``python -m deep_vision_tpu_torch.cli.serve``
              processes on the card (ResNet-50 int8 from one seeded
              port checkpoint, uint8 wire, ``--warmup``, a 64 MB
              response cache, the default selector edge; backend 0
              with ``compute:exception:times=1``) behind
              ``cli/gateway.py``'s ``build_gateway`` in this process:
              32 requests (8 sequential, 24 concurrent) answer 200,
              each equal to the bucket callable's answer at a bucket,
              both backends serve, each backend's ``serve_ingest``
              launches (from its ``/v1/stats``) equal its batches in
              every window, backend 0's exception is retried; each
              backend's edge reused keep-alive sockets and accepted no
              more than the gateway's pool, its probes and this
              script's own connections; a SIGKILL of backend 1 under 4
              closed-loop clients loses nothing, its breaker opens and
              the gateway's healthz stays 200; over the survivor and a
              restarted backend 1 an ``--affinity`` gateway sends 8
              repeats of one payload to one backend (one batch, 7
              ``X-DVT-Cache`` hits, the other backend untouched);
              ``gateway:conn_reset:p=0.2`` (seed 1) over 16 requests
              retries and answers every one with
              ``X-DVT-Retry-Budget``; ``POST /v1/drain`` on both turns
              their healthz and the gateway's 503; every backend
              process is reaped.  Information only: boot seconds, p50
              through the gateway against direct to a backend, kill →
              unroutable ms, reused connections.
  batch       the offline batch tier through ``cli/serve.py``'s
              ``build_server``: ResNet-50 int8 from a seeded port
              checkpoint, uint8 wire, buckets 1-32 warmed,
              ``--jobs-dir`` in a temporary directory,
              ``--batch-cache-shards 1`` (so shards spill to the JSONL
              ledger and stream back from disk), ``--brownout``,
              ``--max-body-mb 128``. (1) A 96-item manifest (3 shards of
              32) POSTed as one body is answered 202 and drains while 4
              closed-loop clients send bucket-1 requests (after a
              baseline of 32 of theirs alone, with the ladder free and
              the level it reached recorded; the drain with the ladder
              pinned at L0, since the clients alone stretch the engine's
              measured execution until its signals freeze the tier):
              every interactive answer is 200, the job is done while
              they run, ``GET /v1/jobs/<id>/results`` arrives chunked
              through the edge with indices 0-95 once each in order and
              a ``done`` status line, at least one shard spilled, each
              row's top-5 holds against a direct call of the model's
              bucket callable at one of the buckets (logits within
              3e-2·max|ref|, top-1 equal where the margin exceeds it)
              and fails on most rows against a "unit" ingest;
              ``serve_ingest`` launches equal the engine's batches over
              checks 1 and 2. (2) At ``POST /v1/brownout {"force": 1}``
              a 32-item job does no shard for 1.5 s while
              ``frozen_deferred`` grows; after ``{"force": null}`` it
              drains. (3) A 128-item job (4 shards) is stopped after its
              first shard (the ladder pinned at L1 as that shard is
              recorded, then the scheduler, the server and the engine),
              a half-written shard line is appended to its ledger, and a
              second server over the same ``--jobs-dir`` replays every
              shard the first recorded, counts 1 torn line, resumes the
              job with no resubmit, serves exactly 128 − 32 images and
              streams 0-127 once each. (4) A 64-item job of ``{"seed":
              i}`` on a ``dcgan`` int8 server: each image within twice
              the card's bucket-1-vs-32 spread (codes) of a direct
              bucket-callable call on ``default_rng(i)``'s latent, most
              rows failing against seed i + 1's, ``serve_ingest`` never
              launched. Information only: batch img/s, interactive p50
              and p99 without and with the drain beside the reference
              test's envelope (p99 ≤ 5·base + 0.25 s), the POST's and
              its JSON parse's seconds, the resume's seconds.

It prints ``{"phase_seconds": {...}}``, the wall seconds each phase
took, and before the last line ``{"kernels": [...]}`` (one entry per
ported kernel: launches on its own path, max error, kernel / plain /
library times at the path's main shape, and the bound), and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero with no
result line; so does a machine without CUDA or a directory without the
package.

    python3 chip_smoke.py --phase-times-of DIR

runs the ``chip_smoke.py`` of another checkout in ``DIR`` (an earlier
commit unpacked with ``git archive``) with its phases timed the same
way, so that two commits' phase times can be held side by side.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and
#: float32 (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: float32 operations per element of the ingest: /255, −mean, /std,
#: /act_scale, round, clamp (two compares)
INGEST_OPS = {True: 7, False: 3}
#: float32 operations per element of train_ingest: /255, ·fb, −m, ·fc,
#: +m, the gray (5 per pixel, 5/3 per element), −gray, ·fs, +gray, clamp
#: (two compares), −mean, /std
TRAIN_INGEST_OPS = 13 + 5 / 3
TRAIN_SHAPES = [(256, 224, 224, 3), (32, 224, 224, 3), (1, 224, 224, 3),
                (3, 17, 23, 3)]
#: the classifier zoo's train_ingest shapes: batch 128 at 224² (AlexNet,
#: VGG, Inception V1, MobileNet), Inception V3's 299² (299·299·3 bytes
#: an image is no multiple of 16) and resnet50_modern's batch 1024
ZOO_TRAIN_SHAPES = [(128, 224, 224, 3), (128, 299, 299, 3),
                    (1024, 224, 224, 3)]
#: train_ingest's edge cases, checks only: (name, shape, leading images
#: dropped by a view), the view x[1:] of a 299² batch at an address no
#: multiple of 16, images smaller than the kernel's 16-pixel chunk, and
#: more images than a grid dimension holds (65,535)
TRAIN_EDGE_CASES = [("unaligned_view", (129, 299, 299, 3), 1),
                    ("tiny_images", (64, 2, 3, 3), 0),
                    ("past_grid_limit", (70000, 4, 4, 3), 0)]
#: serve_ingest at the zoo's /v1/classify buckets: lenet5's "mnist"
#: float32 and inception3's "imagenet" int8 (both outputs checked)
ZOO_SERVE_CASES = [("mnist", (32, 32, 32, 1)), ("imagenet", (32, 299, 299, 3))]
#: the classifier recipes driven for 3 train steps each at their own
#: batch and size (bf16, train_ingest on every step)
ZOO_STEP_MODELS = ("alexnet1", "alexnet2", "vgg16", "vgg19", "inception1",
                   "inception3", "mobilenet1", "shufflenet1", "resnet50v2",
                   "resnet50_modern")
ZOO_STEPS = 3
#: recipes whose own first steps diverge on seeded noise at the
#: reference's init: Inception V1's He fan-out convs with no
#: BatchNorm put its logits at a standard deviation of 72 (the JAX
#: package's own init, 128²), and SGD at lr 0.01 takes the loss from
#: about 780 to 7e11 and then NaN (the port on the CPU, float32, 224²,
#: batch 16; one step of it equals the JAX Trainer's,
#: tests/test_torch_zoo_step.py).  For these the divergence guard must
#: skip exactly the non-finite steps and leave the weights finite.
ZOO_DIVERGING = ("inception1",)
#: inception3 through cli.train: seeded raw records stored at its
#: resize (341²), 2 train steps an epoch at batch 128, one val batch
ZOO_TRAIN, ZOO_VAL, ZOO_WORKERS = 256, 128, 6
#: lenet5 through cli.train on a third of MNIST's train split and its
#: test split's size
MNIST_TRAIN, MNIST_TEST = 20000, 10000
#: the card-vs-CPU float32 steps: size, batch
ZOO_CHECK_MODELS = ("mobilenet1", "inception1")
ZOO_CHECK_SIZE, ZOO_CHECK_BATCH = 128, 8
#: /v1/classify serving of the zoo: (config, --infer-dtype, ingest kind)
CLASSIFY_MODELS = (("lenet5", "float32", "mnist"),
                   ("inception3", "int8", "imagenet"))
N_TRAIN, N_VAL, STORED, BATCH = 1024, 256, 256, 256
#: the crop ResNet-50 trains at from records stored at STORED
CROP = 224
EPOCHS, RESUME_EPOCHS, WORKERS = 2, 3, 4
STEP_CHECK_BATCH = 8
#: the step check's last BN scale of every block: at the trainer's zero no
#: gradient reaches a residual branch, and with every scale near 1 a 1e-7
#: change of the weights moves the update by up to 10% (ReLU gates flip)
STEP_CHECK_LAST_SCALE = 1e-2
BF16_BOUND = 3e-2
#: best_iou_max at yolov3_coco's loss: B=128, N = 3·(416/s)² for s in
#: (8, 16, 32), M = MAX_BOXES
IOU_SHAPES = [(128, 8112, 100), (128, 2028, 100), (128, 507, 100)]
#: the largest scale's shape in a microbatch of --grad-accum 2
IOU_MICRO_SHAPE = (64, 8112, 100)
#: float32 operations of best_iou_max per unmasked pair: 2 max + 2 min
#: (intersection corners), 2 sub + 2 clamp (its sides), 1 mul, add, sub,
#: + eps, the division, the mask select and the running max; per ground
#: truth its mask test (a masked one needs no work per pair: its IoU
#: term is an exact 0); per box its area (2 sub, 2 clamp, 1 mul)
IOU_OPS_PER_PAIR, IOU_OPS_MASK, IOU_OPS_AREA = 15, 1, 5
#: the YOLOv3 run: yolov3_coco at full width (416², 80 classes, batch 128,
#: bf16, Adam) on seeded synthetic records (three shards of 86 scenes),
#: 2 train steps an epoch and one val batch (64 scenes, padded); the
#: card-vs-CPU step at 128² (grids 16, 8, 4)
YOLO_TRAIN, YOLO_VAL, YOLO_SIZE, YOLO_BATCH = 258, 64, 416, 128
YOLO_CLASSES, YOLO_WORKERS, YOLO_CHECK_SIZE = 80, 6, 128
#: CenterNet and Stacked Hourglass-104 training at full width (256², 80
#: classes or 16 keypoints, bf16, batch 32, Adam) on seeded raw records
#: stored at 256² (three train shards of 22): 2 train steps an epoch and
#: 1 val batch; their
#: card-vs-CPU float32 steps on 2 images at 128²
HEAT_TRAIN, HEAT_VAL, HEAT_SIZE, HEAT_BATCH = 66, 32, 256, 32
HEAT_WORKERS, HEAT_CHECK_SIZE, HEAT_CHECK_BATCH = 6, 128, 8
#: the YOLOv3 and heatmap runs through cli.train: an epoch, then a
#: resumed second (the other runs: EPOCHS and a resumed RESUME_EPOCHS)
DETECT_EPOCHS = (1, 2)
#: the biases of the convs whose output goes straight into a training
#: BatchNorm (each bottleneck's conv1/conv2, the stem conv, a stack's
#: conv or linear layer): the normalization removes any per-channel
#: constant, so their gradient is zero in exact arithmetic and rounding
#: noise on any device (the CPU's own 1e-7 move changes it by 160-190%).
#: In the stacked hourglass every conv bias but the heatmap conv's is
#: such noise: its residual stream reaches the loss only through each
#: stack's 1×1 linear layer and its BatchNorm, and the pools,
#: upsamplings, additions and 1×1 convs on the way pass a constant on.
BN_FED_BIAS = re.compile(r"(conv1|conv2|stem_conv|^stacks\.\d+\.conv"
                         r"|^stacks\.\d+\.linear)\.bias$")
HEAT_MODELS = ("centernet", "hourglass104")
#: /v1/pose serving: hourglass104 int8 on the uint8 wire; one image's
#: row is 16 keypoints' (x, y) and scores, float32
POSE_MODEL = "hourglass104"
POSE_ROW_BYTES = 16 * (2 * 4 + 4)
MODEL = "resnet50"
BUCKETS = (1, 2, 4, 8, 16, 32)
N_SEQ, N_CONC = 8, 24
#: the pipeline training phase: hourglass104 with its four stacks over a
#: pipe grid of four places, all on one card, four microbatches; the
#: step checks at HEAT_CHECK_SIZE² with PIPE_CHECK_BATCH images; the
#: CenterNet step on a grid of two
PIPE_MODEL, PIPE_CENTERNET, PIPE_DEVICE = POSE_MODEL, "centernet", "cuda:0"
PIPE_SIZE, PIPE_MICRO, PIPE_CHECK_BATCH = 4, 4, 8
#: the pipeline workdir's server: two buckets (phase 15 warms all six),
#: N_SEQ sequential requests and PIPE_SERVE_CONC concurrent ones
PIPE_SERVE_BUCKETS, PIPE_SERVE_CONC = (1, 8), 8
#: the update bound the control must miss (L2 over the parameters)
PIPE_CONTROL_BOUND = 1e-3
#: detect serving: both detection families at full width, int8 on the
#: uint8 wire, with the default decode knobs (K = 100, score floor 0.05)
DETECT_MODELS = ("yolov3_coco", "centernet")
DETECT_SIZES = (416, 256)  # their input sizes: the kernel rows' shapes
DETECT_TOPK, DETECT_FLOOR = 100, 0.05
#: one image's device-decoded row: boxes (K, 4) f32, scores f32,
#: classes int32, valid f32
DETECT_ROW_BYTES_PER_K = 16 + 4 + 4 + 4
#: the seeded heads' output spread and biases (see ``seeded_model``):
#: CenterNet's heatmap prior, and a YOLO objectness bias that leaves
#: about a hundred candidates an image over the score floor
HEAD_STD = {"yolo": 1.5, "heat": 1.5, "wh": 1.0, "offset": 0.5,
            "pose": 1.0}
HEAT_PRIOR, YOLO_OBJ_BIAS = -2.19, -6.0
#: the GAN family at full width: dcgan through cli.train on seeded
#: idx-ubyte files of MNIST's shape (batch 256: 60 steps an epoch),
#: cyclegan on seeded --synthetic domains (256², 9 blocks, batch 1: 32
#: steps an epoch, so the 50-image pools fill and start replaying in the
#: second epoch); both checkpoint every 2 epochs
GAN_MODELS = ("dcgan", "cyclegan")
GAN_SYNTHETIC = 32
#: dcgan's idx images (60 steps an epoch; MNIST's 60,000 until PR 16)
DCGAN_TRAIN = 15360
GAN_STEPS = {"dcgan": DCGAN_TRAIN // 256, "cyclegan": GAN_SYNTHETIC}
#: the card-vs-CPU float32 steps: DCGAN at batch 64, CycleGAN at 128²,
#: batch 1, with valid pooled fakes
DCGAN_CHECK_BATCH, CYCLE_CHECK_SIZE = 64, 128
#: /v1/generate: (config, requested wire, --infer-dtype); dcgan's wire
#: is forced to float32 (a latent), cyclegan's uint8 takes the plain
#: "gan" prologue at float32 and int8
GENERATE_MODELS = (("dcgan", "uint8", "float32"),
                   ("cyclegan", "uint8", "float32"),
                   ("cyclegan", "uint8", "int8"))
#: one padded image's D2H bytes: the uint8 image
GENERATE_ROW_BYTES = {"dcgan": 28 * 28 * 1, "cyclegan": 256 * 256 * 3}
#: the fault plane on ResNet-50 int8 served from a port checkpoint: the
#: 6th submitted request is poisoned; 2 sequential then 30 concurrent
#: requests in a 20 ms batching window, so the poison shares its cohort
POISON_SPEC = "compute:poison:nth=5"
#: the third batch hangs once (without times=1 every later batch would)
HANG_SPEC = "d2h:hang:hang_s=30:after=2:times=1"
FAULT_N_SEQ, FAULT_N_CONC = 2, 30
#: the model control plane: two models whose int8 weights together
#: exceed the weight-cache budget, 3 rounds of alternating sequential
#: requests (a miss then a hit each), the reload's clients on 32 images
#: with a decided top-1, and how far the two resident states'
#: ``memory_allocated`` may differ from the two models' weight bytes in
#: 512-byte blocks: the caching allocator leaves a large block the tail
#: of its segment when that tail is under 1 MiB (1.6-1.7 MB measured on
#: an H100 80GB HBM3 at 700 W)
PLANE_MODELS = (MODEL, "yolov3_coco")
PLANE_ROUNDS, PLANE_CLIENT_IMAGES = 3, 32
PLANE_BODY = {"classify": {"top_k": 5},
              "detect": {"score_threshold": DETECT_FLOOR}}
PLANE_MEM_SLACK = 4 * 2**20
#: the replicated engine: ResNet-50 int8 on two replicas of one card, 16
#: sequential then 48 concurrent requests, 96 concurrent while replica 1
#: is forced DEAD, 4 closed-loop clients across an add and a remove, and
#: the closed-loop batch the single engine and the fleet are timed on
FLEET_DEVICE = "cuda:0"
FLEET_N_SEQ, FLEET_N_CONC, FLEET_DEAD_N = 16, 48, 96
FLEET_TIMED_N, FLEET_TIMED_ROUNDS = 192, 2
#: the deploy loop: 32 seeded uint8 gate images, the watcher's poll
#: interval, and how long a rollout may take on the card
DEPLOY_GATE_IMAGES, DEPLOY_POLL_S, DEPLOY_TIMEOUT_S = 32, 0.5, 300.0
#: the cascade: three ImageNet ResNets at 224² on the uint8 wire
#: (clients address the last), tier 0 int8 (``--cascade-quant-front``),
#: the others bf16, a top-5 epilogue on the non-final tiers; and the
#: detect lane, both tiers 416² int8.  Seeded random tiers almost never
#: agree on top-1, so calibration is held to its machinery: any observed
#: agreement qualifies (``--cascade-min-agreement 0``) and the samples
#: are few.  16 seeded images, 8 sequential requests, then 4 closed-loop
#: clients; a tenant of the "premium" class is always-big
CASCADE_TIERS = ("resnet34", "resnet50", "resnet152")
CASCADE_DETECT = ("yolov3_toy416", "yolov3_coco")
CASCADE_TOPK, CASCADE_SAMPLE_PERIOD = 5, 3
CASCADE_MIN_SAMPLE, CASCADE_DETECT_MIN_SAMPLE = 12, 6
CASCADE_IMAGES, CASCADE_SEQ, CASCADE_CLIENTS = 16, 8, 4
CASCADE_TIMEOUT_S = 120.0
CASCADE_QOS = ("premium:rate=0,shed_at=1.0,always_big=1,tenants=acme;"
               "standard:rate=0,shed_at=0.5;default=standard")
PREMIUM = {"X-DVT-Tenant": "acme"}
#: the brownout episode: ResNet-50 int8 one image a batch under a 40 ms
#: compute latency fault, so 8 closed-loop clients queue ~8 × 40 ms; a
#: shed client retries after 20 ms (its Retry-After says 1 s); the load
#: is held 4 s past L2 (2 s in the parse-first control); the ladder's
#: thresholds and windows at that time scale
BROWNOUT_HERD, BROWNOUT_RETRY_S = 8, 0.02
BROWNOUT_EPISODE_S, BROWNOUT_CONTROL_S = 4.0, 2.0
BROWNOUT_FAULT = "compute:latency:delay_ms=40"
BROWNOUT_FLAGS = ["--brownout", "--brownout-interval-ms", "25",
                  "--brownout-l1-ms", "20", "--brownout-l2-ms", "60",
                  "--brownout-l3-ms", "240", "--brownout-shed-rate", "0.9",
                  "--brownout-down-window", "3", "--brownout-cooldown-s",
                  "0.2"]

#: the gateway: two ``cli.serve`` processes of ResNet-50 int8 on the one
#: card behind ``cli.gateway`` (probes every 50 ms), backend 0 with one
#: injected compute exception; 8 sequential then 24 concurrent requests,
#: 16 bucket-1 requests each way for the hop's cost, 4 closed-loop
#: clients across the SIGKILL (held 1 s after it), 8 repeats of one
#: payload under affinity, and 16 requests under a seeded conn_reset
#: (seed 1 fires on the first attempt and on two in a row later)
GATEWAY_DEVICE = "cuda"
GATEWAY_FAULT = "compute:exception:times=1"
GATEWAY_PROBE_MS = 50
GATEWAY_N, GATEWAY_N_SEQ, GATEWAY_HOP_N = 32, 8, 16
GATEWAY_CLIENTS, GATEWAY_KILL_TAIL_S = 4, 1.0
GATEWAY_AFFINITY_REPEATS = 8
GATEWAY_NET_FAULT, GATEWAY_NET_SEED, GATEWAY_NET_N = \
    "gateway:conn_reset:p=0.2", 1, 16
GATEWAY_BOOT_TIMEOUT_S = 300.0


#: the batch tier: ResNet-50 int8 through ``cli.serve --jobs-dir`` with
#: one shard of payloads cached (the rest spill to the ledger and stream
#: back from disk) and the brownout ladder armed; a job of 3 shards
#: drains under 4 closed-loop bucket-1 clients (8 requests each before
#: it, for the baseline), one shard waits 1.5 s behind a pinned L1, and
#: a job of 4 shards is stopped after its first and resumed by a second
#: server; then 2 shards of DCGAN int8 seeds.  A 224² JSON item is
#: ~0.79 MB, so the largest body is ~101 MB
BATCH_DEVICE = "cuda"
BATCH_DRAIN_SHARDS, BATCH_RESTART_SHARDS, BATCH_GAN_SHARDS = 3, 4, 2
BATCH_CLIENTS, BATCH_BASE_N = 4, 8
BATCH_FREEZE_S = 1.5
BATCH_TIMEOUT_S = 300.0
BATCH_FLAGS = ["--batch-cache-shards", "1", "--brownout",
               "--max-body-mb", "128"]

#: the trainer's recipe options: (a) 16 steps of lenet5 (batch 64) and
#: dcgan (batch 256) with --scan-steps 8 against 1, and the detection and
#: pose tasks at their toy sizes with --scan-steps 4 against 1 (yolov3_toy
#: also with --grad-accum 2 --ema-decay 0.9); (b) resnet50 through
#: cli.train on the training phase's records (2 epochs and a resumed
#: third, 4 steps each) with --scan-steps 4 --ema-decay 0.9999; (c)
#: yolov3_coco with --grad-accum 2 for one epoch on 258 + 64 records (2
#: steps: three shards of 86; one val batch); (d) lenet5 with SGD
#: nesterov and a bfloat16 momentum, 3 steps on the card and on the CPU
RECIPE_STEPS, RECIPE_SCAN = 16, 8
#: the other Trainer tasks captured at their toy sizes, 8 steps each:
#: (name, extra cli.train flags)
#: mesh serving: ResNet-50 int8 through cli.serve on a 2×2 data×model
#: grid that repeats one card (an explicit --device cuda:K lays it at
#: every place of the grid), 8 sequential then 24 concurrent requests a
#: server over the sharded ladder 2..32; the reference's classifier
#: table is refused on int8 (its kernel rules hit the 1-D param_scales
#: leaves), so its intent runs anchored on params/
MESH_DEVICE = "cuda:0"
MESH_AXES = (2, 2)
MESH_N_SEQ, MESH_N_CONC = 8, 24
MESH_PARAMS_TABLE = r"^params/.*Dense_\d+/kernel$=-,model;.*="
MESH_REFUSAL = "is only valid for values of rank at least 2, but was " \
    "applied to a value of rank 1"
RECIPE_TOY_ACCUM = ("--grad-accum", "2", "--ema-decay", "0.9")
#: the toy tasks captured against single steps; the last, the Stacked
#: Hourglass's four stacks on a pipe grid of four places on one card
RECIPE_TOY_PIPE = ("--mesh", "data=1,pipe=4", "--microbatches", "2",
                   "--device", "cuda:0")
RECIPE_TOY_TASKS = (
    ("yolov3_toy", ()), ("centernet_toy", ()), ("hourglass_toy", ()),
    ("yolov3_toy", RECIPE_TOY_ACCUM), ("hourglass_toy", RECIPE_TOY_PIPE))
RECIPE_TOY_STEPS = 8
RECIPE_R50_SCAN, RECIPE_EMA = 4, 0.9999
RECIPE_YOLO_TRAIN, RECIPE_YOLO_VAL, RECIPE_ACCUM = 258, 64, 2
RECIPE_NESTEROV_STEPS = 3


#: the script's start: each log line carries the seconds since it
_START = time.monotonic()


def log(msg: str) -> None:
    print(f"[chip_smoke] +{time.monotonic() - _START:.1f}s {msg}",
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def act_scale_for(kind: str, channels: int) -> float:
    """The ingest scale the port's calibration prices for ``kind`` on
    uniform uint8 data: absmax of the normalized 0..255 range / 127."""
    import torch

    from deep_vision_tpu_torch.ops.preprocess import serve_normalize

    x = torch.arange(256, dtype=torch.uint8).repeat_interleave(
        channels).view(1, 1, 256, channels)
    return float(serve_normalize(x, kind).abs().max()) / 127.0


def call_ms(fn, inputs, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per EAGER call (CUDA events around back-to-back
    calls, cycling ``inputs``): includes the host's launch overhead
    whenever the host launches slower than the device runs."""
    import torch

    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs, reps: int = 20) -> float:
    """Mean DEVICE milliseconds per call: one call per input captured in
    a CUDA graph, the graph replayed ``reps`` times between two events,
    so host overhead and launch gaps drop out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for x in inputs[:3]:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(inputs))
    del graph
    return ms


def phase_build() -> float:
    from deep_vision_tpu_torch.ops import _build

    t0 = time.monotonic()
    names = _build.build_all()
    secs = time.monotonic() - t0
    log(f"build: {names} in {secs:.2f} s")
    return secs


def phase_kernels() -> list[dict]:
    """serve_ingest vs its plain version at the serving shapes."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import (
        ingest_norm_constants,
        serve_ingest,
        serve_ingest_plain,
    )

    resources = kernel_resources("serve_ingest")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("imagenet", (b, 224, 224, 3)) for b in (1, 8, 32)] + [
        ("imagenet", (3, 17, 23, 3)), ("mnist", (4, 32, 32, 1))] + [
        ("unit", (32, s, s, 3)) for s in DETECT_SIZES] + ZOO_SERVE_CASES
    rows = []
    for kind, shape in cases:
        scale = act_scale_for(kind, shape[-1])
        mean, std = ingest_norm_constants(kind, shape[-1])
        mean_t = torch.tensor(mean, device="cuda")
        std_t = torch.tensor(std, device="cuda")
        numel = math.prod(shape)
        n_bufs = max(2, min(64, math.ceil(100e6 / numel)))
        xs = [torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                            generator=gen) for _ in range(n_bufs)]
        for quantize in (True, False):
            got = serve_ingest(xs[0], kind, scale, quantize)
            want = serve_ingest_plain(xs[0], kind, scale, quantize)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if quantize:
                check(torch.equal(got, want),
                      f"serve_ingest int8 differs from plain at {shape} "
                      f"{kind}: max err {err}")
            elif (kind, shape) in ZOO_SERVE_CASES:
                check(torch.equal(got, want),
                      f"serve_ingest f32 differs from plain at {shape} "
                      f"{kind}: max err {err}")
            else:
                check(err <= 1e-6, f"serve_ingest f32 differs from plain "
                                   f"at {shape} {kind}: {err}")

            def library(x, q=quantize):
                y = (x.float() / 255 - mean_t) / std_t
                return (y / scale).round().clamp(-127, 127).to(torch.int8) \
                    if q else y

            out_bytes = numel * (1 if quantize else 4)
            bound_bytes = (numel + out_bytes) / HBM_BYTES_PER_S * 1e3
            bound_ops = numel * INGEST_OPS[quantize] / F32_OPS_PER_S * 1e3

            def kernel(x, q=quantize):
                return serve_ingest(x, kind, scale, q)

            def plain(x, q=quantize):
                return serve_ingest_plain(x, kind, scale, q)

            row = {"kind": kind, "shape": list(shape),
                   "out": "int8" if quantize else "float32",
                   "max_abs_err": err, "resources": resources,
                   "ms": device_ms(kernel, xs),
                   "call_ms": call_ms(kernel, xs),
                   "plain_ms": device_ms(plain, xs),
                   "library_ms": device_ms(library, xs),
                   "bound_ms": max(bound_bytes, bound_ops),
                   "bound_by": "bytes" if bound_bytes >= bound_ops
                   else "operations"}
            rows.append(row)
            log(f"serve_ingest {kind} {shape} {row['out']}: device "
                f"{row['ms'] * 1e3:.2f} us (eager call "
                f"{row['call_ms'] * 1e3:.2f}, plain "
                f"{row['plain_ms'] * 1e3:.2f}, library "
                f"{row['library_ms'] * 1e3:.2f}, bound "
                f"{row['bound_ms'] * 1e3:.2f} us), max err {err}")
    # every channel count the kernel takes, and a misaligned input (the
    # scalar path over the table)
    for kind, shape, offset in (("unit", (2, 15, 17, 2), 0),
                                ("unit", (2, 16, 16, 4), 0),
                                ("imagenet", (2, 31, 29, 3), 1),
                                ("mnist", (3, 28, 28, 1), 3)):
        numel = math.prod(shape)
        buf = torch.randint(0, 256, (numel + offset,), dtype=torch.uint8,
                            device="cuda", generator=gen)
        x = buf[offset:].view(shape)
        for quantize in (True, False):
            got = serve_ingest(x, kind, 0.02, quantize)
            want = serve_ingest_plain(x, kind, 0.02, quantize)
            torch.cuda.synchronize()
            check(torch.equal(got, want) if quantize else
                  float((got - want).abs().max()) <= 1e-6,
                  f"serve_ingest differs from plain at {shape} {kind} "
                  f"(offset {offset}, int8 {quantize})")
    empty = torch.empty((0, 224, 224, 3), dtype=torch.uint8, device="cuda")
    before = serve_ingest.launches
    out = serve_ingest(empty, "imagenet", 1.0)
    check(out.shape == empty.shape and out.dtype == torch.int8
          and serve_ingest.launches == before,
          "an empty batch must return an empty int8 batch and launch nothing")
    log(f"kernel launches while checking: {serve_ingest.launches}")
    return rows


def seeded_weights(path: str, seed: int = 0) -> None:
    """ResNet-50 weights in the reference's flax layout, written as the
    ``--weights`` npz a user would pass: He/LeCun init from the seed,
    then NON-ZERO BatchNorm scales (the reference init zeroes the last
    one of each block, which would hide the residual branches) and
    positive running variances."""
    import torch

    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.models.resnet import ResNet50

    gen = torch.Generator().manual_seed(seed)
    model = ResNet50().reset_parameters(gen)
    nonzero_bn_(model, gen)
    with torch.no_grad():
        model.fc.bias.normal_(0.0, 0.1, generator=gen)
    convert.save_npz(path, convert.import_torch_resnet(model.state_dict(),
                                                        MODEL))


def post(port: int, body: bytes, path: str = "/v1/classify"
         ) -> tuple[int, dict, float]:
    """POST one pre-encoded JSON body (encoding stays out of the clock)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read()), time.monotonic() - t0


def boot(weights: str, infer_dtype: str, buckets, warmup: bool):
    from deep_vision_tpu_torch.cli import serve as cli

    argv = ["-m", MODEL, "--weights", weights, "--wire-dtype", "uint8",
            "--infer-dtype", infer_dtype, "--port", "0",
            "--max-batch", str(max(buckets)),
            "--buckets", ",".join(map(str, buckets)), "--device", "cuda"]
    engine, server = cli.build_server(cli.build_parser().parse_args(
        argv + (["--warmup"] if warmup else [])))
    server.start_background()
    return engine, server


def direct_logits(sm, images: np.ndarray, kind: str | None = None
                  ) -> np.ndarray:
    """The served model called directly, with the PLAIN ingest of
    ``kind`` (by default the model's own preprocess kind)."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest_plain
    from deep_vision_tpu_torch.ops.preprocess import serve_normalize

    kind = kind or sm.preprocess_kind
    x = torch.from_numpy(images).to(sm.device)
    with torch.inference_mode():
        if sm.infer_dtype == "int8":
            s = float(sm.quant.act_scale)
            xf = serve_ingest_plain(x, kind, s).float() * s
        else:
            xf = serve_normalize(x, kind)
        out = sm._model(xf).float().cpu().numpy()
    return out


def decided_images(sm, n: int) -> tuple[np.ndarray, int]:
    """The first ``n`` of 1024 seeded uint8 noise images whose top-1
    the direct plain-ingest call decides: its top-1 margin (top logit
    minus the runner-up) exceeds the bf16 bound.  With random weights
    most noise images put their top two logits a few bf16 steps apart,
    where a served batch's rounding may swap them.  Screened by the
    direct call only, never by the served path; returns the images and
    the number screened."""
    pool = 1024
    rng = np.random.RandomState(1)
    cands = rng.randint(0, 256, (pool, *sm.input_shape), np.uint8)
    ref = np.concatenate([direct_logits(sm, cands[i:i + 64])
                          for i in range(0, pool, 64)])
    top2 = np.sort(ref, axis=-1)[:, -2:]
    keep = np.flatnonzero(top2[:, 1] - top2[:, 0]
                          > BF16_BOUND * float(np.abs(ref).max()))
    check(len(keep) >= n, f"only {len(keep)} of {pool} images have a "
                          f"top-1 margin above the bf16 bound")
    return cands[keep[:n]], int(keep[n - 1]) + 1


def bucket_forward_ms(sm, buckets, iters: int = 10) -> dict:
    """Eager per-bucket forward time (ingest kernel + ResNet + float32
    logits) from CUDA events, on random uint8 input already on the
    card: the device side of one batch without HTTP or staging."""
    import torch

    out = {}
    for b in buckets:
        fn = sm.compile_bucket(b)
        x = torch.randint(0, 256, (b, *sm.input_shape), dtype=torch.uint8,
                          device=sm.device)
        out[str(b)] = call_ms(fn, [x], iters=iters, warmup=2)
    return out


def compare_answers(replies, ref: np.ndarray) -> dict:
    """Hold served top-5 answers against direct logits ``ref``.

    Every served logit must lie within the bf16 bound of the direct
    call's logit for the same class.  Top-1 must be equal on the rows
    whose direct top-1 margin (top logit minus the runner-up) exceeds
    that bound: below it, bf16 rounding that differs with the batch a
    request landed in may legitimately swap two nearly tied classes.
    Returns the numbers and a list of faults (empty when all hold)."""
    bound = BF16_BOUND * float(np.abs(ref).max())
    top2 = np.sort(ref[:len(replies)], axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    faults, worst, decisive = [], 0.0, 0
    for i, (status, body, _) in enumerate(replies):
        if status != 200:
            faults.append(f"request {i}: HTTP {status} {body}")
            continue
        top = body["top"]
        if len(top) != 5:
            faults.append(f"request {i}: {len(top)} classes, not 5")
            continue
        logits = np.array([t["logit"] for t in top])
        if not np.isfinite(logits).all():
            faults.append(f"request {i}: non-finite logits")
            continue
        classes = [t["class"] for t in top]
        err = float(np.abs(logits - ref[i][classes]).max())
        worst = max(worst, err)
        if err > bound:
            faults.append(f"request {i}: logit err {err} > bound {bound}")
        if margins[i] > bound:
            decisive += 1
            if classes[0] != int(ref[i].argmax()):
                faults.append(f"request {i}: top-1 {classes[0]} != direct "
                              f"{int(ref[i].argmax())} (margin "
                              f"{float(margins[i])})")
    return {"max_abs_err": worst, "bound": bound,
            "top1_decisive_rows": decisive, "rows": len(replies),
            "min_top1_margin": float(margins.min()),
            "median_top1_margin": float(np.median(margins)),
            "faults": faults}


def phase_serving() -> dict:
    """Serve ResNet-50 int8 over HTTP on the card and check the answers
    (8 sequential requests, then 24 concurrent); returns the numbers."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        weights = os.path.join(tmp, "weights.npz")
        seeded_weights(weights)
        t0 = time.monotonic()
        engine, server = boot(weights, "int8", BUCKETS, True)
        log(f"serving {MODEL} int8: boot + warmup "
            f"{time.monotonic() - t0:.1f} s, buckets {engine.buckets}")
        sm = engine.model
        imgs, screened = decided_images(sm, N_SEQ + N_CONC)
        log(f"{len(imgs)} images with a decided top-1 among the first "
            f"{screened} seeded noise images")
        bodies = [json.dumps({"pixels": im.tolist(), "top_k": 5}).encode()
                  for im in imgs]
        try:
            serve_ingest.launches = 0
            replies = [post(server.port, b) for b in bodies[:N_SEQ]]
            t1 = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(N_CONC) as pool:
                replies += list(pool.map(lambda b: post(server.port, b),
                                         bodies[N_SEQ:]))
            conc_s = time.monotonic() - t1
            launches = serve_ingest.launches
            stats = engine.stats()
        finally:
            server.shutdown()
            engine.stop(drain_deadline=10.0)
        check(launches > 0, "serve_ingest was never launched while serving")
        forward_ms = bucket_forward_ms(sm, BUCKETS)
        agree = compare_answers(replies, direct_logits(sm, imgs))
        log(f"int8 answers vs direct plain-ingest call: {json.dumps(agree)}")
        check(not agree["faults"], f"int8 answers: {agree['faults']}")
        check(2 * agree["top1_decisive_rows"] > len(replies),
              f"top-1 decides only {agree['top1_decisive_rows']} of "
              f"{len(replies)} rows (margin above the bound)")
        # the gate has power: the same answers held against a direct call
        # whose ingest skips the ImageNet mean/std must fail it
        wrong = compare_answers(replies, direct_logits(sm, imgs, "unit"))
        log(f"control, answers vs an ingest without mean/std: "
            f"{len(wrong['faults'])} faults, max logit err "
            f"{wrong['max_abs_err']}")
        check(bool(wrong["faults"]),
              "the answer check passed against a wrong ingest")
        lat = sorted(r[2] for r in replies)
        out = {"launches": launches, "requests": len(replies),
               "batches": stats["batches"],
               "compiled_buckets": stats["compiled_buckets"],
               "client_p50_ms": lat[len(lat) // 2] * 1e3,
               "concurrent_img_per_s": N_CONC / conc_s,
               "engine_latency_ms": stats["latency"],
               "engine_exec_ewma_ms": stats["admission"][
                   "exec_ewma_ms_by_bucket"],
               "device_idle_frac_host_proxy": stats["pipeline"][
                   "device_idle_frac"],
               "forward_ms_by_bucket": forward_ms,
               "logit_max_abs_err": agree["max_abs_err"],
               "logit_bound": agree["bound"],
               "top1_decisive_rows": agree["top1_decisive_rows"],
               "images_screened": screened,
               "min_top1_margin": agree["min_top1_margin"],
               "control_faults": len(wrong["faults"])}
        check(stats["batches"] < len(replies),
              "concurrent requests were never batched together")
        log(f"int8 serving: {json.dumps(out)}")
        del sm, engine, server
        # the float32 ingest (serve_ingest with float32 out): one
        # float32-infer request
        engine, server = boot(weights, "float32", (1,), False)
        try:
            f32 = [post(server.port, bodies[0])]
        finally:
            server.shutdown()
            engine.stop(drain_deadline=10.0)
        out["float32_infer"] = compare_answers(
            f32, direct_logits(engine.model, imgs[:1]))
        log(f"float32-infer request: {json.dumps(out['float32_infer'])}")
        check(not out["float32_infer"]["faults"],
              f"float32 answers: {out['float32_infer']['faults']}")
    return out


def nonzero_bn_(model, gen) -> None:
    """NON-ZERO BatchNorm scales (uniform 0.5–1), biases and running
    means about 0, positive running variances, drawn from ``gen``: the
    reference's init zeroes the last scale of a residual block, which
    would hide the branch from a check."""
    import torch

    from deep_vision_tpu_torch.models.common import BatchNorm2d

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.5, 1.0, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)


def seeded_model(name: str, seed: int):
    """Config ``name``'s model at the reference's init from the seed,
    with NON-ZERO BatchNorm scales and positive running variances, then
    each head's output conv scaled, from float32 forwards of 4 seeded
    images on the card, one head at a time, so that its output has the
    spread
    ``HEAD_STD`` (a trained model's; at the init's own scale the deeper
    stacks' outputs spread over ±20 and more, where the sigmoid rounds
    many CenterNet peaks to exactly 1.0 and the decode would rank ties
    alone); the heatmap's bias is the −2.19 prior, YOLO's objectness
    bias −6 (a trained detector is confident about a few boxes, not
    about every anchor), the others 0.  On the CPU, in float32."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config

    cfg = get_config(name)
    model = cfg.model()
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    nonzero_bn_(model, gen)
    yolo = name.startswith("yolo")
    if yolo:
        heads = [(getattr(model, h).out, HEAD_STD["yolo"], 0.0)
                 for h in ("head13", "head26", "head52")]
    elif cfg.task == "pose":
        heads = [(s.heat, HEAD_STD["pose"], 0.0) for s in model.stacks]
    else:
        heads = [(h.out, HEAD_STD[kind], HEAT_PRIOR if kind == "heat"
                  else 0.0) for s in model.stacks
                 for kind, h in (("heat", s.heat), ("wh", s.wh),
                                 ("offset", s.offset))]
    # one head at a time, in order: a stack's heatmap feeds the next
    # stack through the re-injection, so its scale moves later outputs
    x = torch.rand((4, cfg.image_size, cfg.image_size, 3), generator=gen)
    model.set_compute_dtype(torch.float32).eval().cuda()
    for conv, std, bias in heads:
        spread = []
        hook = conv.register_forward_hook(
            lambda m, _i, out: spread.append(
                float((out - m.bias.view(1, -1, 1, 1)).std())))
        with torch.no_grad():
            model(x.cuda())
            hook.remove()
            conv.weight.mul_(std / spread[0])
            conv.bias.fill_(bias)
            if yolo:  # channel a·(5 + C) + 4 is anchor a's objectness
                conv.bias.view(3, -1)[:, 4] = YOLO_OBJ_BIAS
    return model.cpu()


def write_weights(name: str, path: str, seed: int) -> None:
    """:func:`seeded_model`'s weights in the reference's flax layout,
    written as the ``--weights`` npz a user would pass."""
    from deep_vision_tpu_torch import convert

    model = seeded_model(name, seed)
    sd = model.state_dict()
    if name.startswith("yolo"):
        variables = convert.yolo_to_flax(sd, model.blocks)
    elif name.startswith("hourglass"):
        variables = convert.stacked_hourglass_to_flax(
            sd, model.num_stack, model.num_heatmap, model.filters,
            model.num_residual, model.order)
    else:
        variables = convert.centernet_to_flax(sd, model.num_stack,
                                              model.order, model.filters)
    convert.save_npz(path, variables)


def direct_rows(sm, images: np.ndarray, bucket: int,
                kind: str | None = None) -> list[dict]:
    """The served model called directly in batches of ``bucket`` (zero
    padded), with the PLAIN ingest of ``kind`` (by default the model's
    own), the same forward and the same epilogue: one row dict of numpy
    arrays per image."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest_plain
    from deep_vision_tpu_torch.serve.engine import map_leaves

    kind = kind or sm.preprocess_kind
    post = sm.workload.make_epilogue(sm)
    rows = []
    for i in range(0, len(images), bucket):
        chunk = images[i:i + bucket]
        batch = np.zeros((bucket, *sm.input_shape), np.uint8)
        batch[:len(chunk)] = chunk
        x = torch.from_numpy(batch).to(sm.device)
        with torch.inference_mode():
            if sm.infer_dtype == "int8":
                s = float(sm.quant.act_scale)
                xf = serve_ingest_plain(x, kind, s).to(torch.float32) * s
            else:
                xf = serve_ingest_plain(x, kind, quantize=False)
            out = map_leaves(lambda t: t.to(torch.float32), sm._model(xf))
            if post is not None:
                out = post(out)
        if isinstance(out, torch.Tensor):  # classify: the logits
            host = out.cpu().numpy()
            rows += [host[j] for j in range(len(chunk))]
            continue
        host = {k: v.cpu().numpy() for k, v in out.items()}
        rows += [{k: v[j] for k, v in host.items()}
                 for j in range(len(chunk))]
    return rows


def answer_diff(got: dict, want: dict) -> tuple[bool, float, float]:
    """(same kept set, max |Δscore|, max |Δbox|) of two /v1/detect
    answers: the kept set is the detections' count and classes in
    order."""
    a, b = got["detections"], want["detections"]
    if len(a) != len(b) or [d["class"] for d in a] != \
            [d["class"] for d in b]:
        return False, math.inf, math.inf
    if not a:
        return True, 0.0, 0.0
    ds = max(abs(x["score"] - y["score"]) for x, y in zip(a, b))
    db = float(np.abs(np.array([x["box"] for x in a])
                      - np.array([y["box"] for y in b])).max())
    return True, ds, db


def classify_diff(got: dict, want: dict) -> tuple[bool, float, float]:
    """(same top-k classes in order, max |Δlogit|, 0) of two
    /v1/classify answers."""
    a, b = got["top"], want["top"]
    if [t["class"] for t in a] != [t["class"] for t in b]:
        return False, math.inf, math.inf
    return True, max(abs(x["logit"] - y["logit"]) for x, y in zip(a, b)), 0.0


def pose_diff(got: dict, want: dict) -> tuple[bool, float, float]:
    """(True, max |Δscore|, max |Δx| or |Δy|) of two /v1/pose
    answers."""
    a, b = got["keypoints"], want["keypoints"]
    if len(a) != len(b):
        return False, math.inf, math.inf
    ds = max(abs(x["score"] - y["score"]) for x, y in zip(a, b))
    dxy = max(max(abs(x["x"] - y["x"]), abs(x["y"] - y["y"]))
              for x, y in zip(a, b))
    return True, ds, dxy


def compare_rows(sm, replies, refs: dict, body: dict,
                 bounds: tuple[float, float], diff=answer_diff) -> dict:
    """Each served answer against the direct answers of its image at
    every bucket (``refs``: bucket → rows): the engine puts a request
    into a batch of some bucket, and the card's convolutions round
    differently from one batch size to the next, so an answer must
    match the direct answer at one of the buckets by ``diff``: the same
    kept set, scores and positions within ``bounds``.  Returns the
    numbers and the faults."""
    workload = sm.workload
    faults, exact, worst = [], 0, (0.0, 0.0)
    for i, (status, got, _) in enumerate(replies):
        if status != 200:
            faults.append(f"request {i}: HTTP {status} {got}")
            continue
        best = None
        for bucket, rows in refs.items():
            want = json.loads(json.dumps(workload.respond(sm, body,
                                                          rows[i])))
            if got == want:
                exact += 1
                best = (0.0, 0.0)
                break
            same, ds, db = diff(got, want)
            if same and ds <= bounds[0] and db <= bounds[1]:
                best = min(best or (ds, db), (ds, db))
        if best is None:
            faults.append(f"request {i}: no bucket's direct answer is "
                          f"within {bounds}")
        else:
            worst = (max(worst[0], best[0]), max(worst[1], best[1]))
    return {"rows": len(replies), "exact": exact,
            "max_score_err": worst[0], "max_pos_err": worst[1],
            "faults": faults}


def bucket_spread(sm, refs: dict, body: dict, diff=answer_diff) -> dict:
    """The card's own batch-to-batch spread: over the images whose
    direct answers at buckets 1 and 32 keep the same set, the largest
    score and position differences between the two."""
    workload = sm.workload
    small, large = refs[min(refs)], refs[max(refs)]
    same, ds, dp = 0, 0.0, 0.0
    for a, b in zip(small, large):
        ok, s, p = diff(workload.respond(sm, body, a),
                        workload.respond(sm, body, b))
        if ok:
            same += 1
            ds, dp = max(ds, s), max(dp, p)
    return {"same_kept_set": same, "images": len(small),
            "score": ds, "position": dp}


def check_tied_topk() -> dict:
    """``topk_stable`` on the card equals the CPU's on heavily tied
    rows at the two decodes' shapes: CenterNet's (32, 64·64·80) heatmap
    and YOLO's (32, 10647) pre-NMS scores."""
    import torch

    from deep_vision_tpu_torch.ops.boxes import topk_stable

    gen = torch.Generator().manual_seed(7)
    out = {}
    for shape, k in (((32, 64 * 64 * 80), 100), ((32, 10647), 512)):
        x = torch.randint(0, 5, shape, generator=gen).float() / 4
        cv, ci = topk_stable(x.cuda(), k)
        hv, hi = topk_stable(x, k)
        check(torch.equal(ci.cpu(), hi) and torch.equal(cv.cpu(), hv),
              f"topk_stable on the card differs from the CPU on ties "
              f"at {shape}")
        out[str(shape)] = k
    return out


def bucket_epilogue_ms(sm, buckets, iters: int = 10) -> dict:
    """Per bucket: the eager forward (ingest kernel + model + float32
    outputs) and, apart, the workload's epilogue on those outputs
    (decode, top-k, NMS), from CUDA events on random uint8 input on the
    card."""
    import torch

    post = sm.workload.make_epilogue(sm)
    out = {}
    for b in buckets:
        fn = sm.compile_bucket(b, epilogue=False)
        x = torch.randint(0, 256, (b, *sm.input_shape), dtype=torch.uint8,
                          device=sm.device)
        heads = fn(x)
        with torch.inference_mode():
            out[str(b)] = {
                "forward_ms": call_ms(fn, [x], iters=iters, warmup=2),
                "epilogue_ms": call_ms(post, [heads], iters=iters,
                                       warmup=2)}
    return out


def serve_over_http(name: str, weights: str, verb: str, body: dict,
                    extra=(), infer_dtype: str = "int8",
                    kind: str = "unit") -> tuple:
    """Serve ``name`` (``infer_dtype``, ``kind`` ingest) on the uint8
    wire over HTTP on the card (buckets 1–32, warmed up), POST 8 sequential then 24 concurrent
    ``/v1/{verb}`` requests of seeded noise images with ``serve_ingest``'s
    count set to 0 just before and read just after, and a request to
    every other verb, which must answer 400 naming ``/v1/{verb}``.
    Checks that the kernel launched once a batch the engine formed and
    that concurrent requests were batched.  Returns ``(served model,
    images, replies, numbers)``."""
    from deep_vision_tpu_torch.cli import serve as cli
    from deep_vision_tpu_torch.ops.ingest import serve_ingest
    from deep_vision_tpu_torch.serve.workloads import WORKLOADS

    argv = ["-m", name, "--weights", weights, "--wire-dtype", "uint8",
            "--infer-dtype", infer_dtype, "--port", "0",
            "--max-batch", str(max(BUCKETS)),
            "--buckets", ",".join(map(str, BUCKETS)), "--device", "cuda",
            "--warmup", *extra]
    t0 = time.monotonic()
    engine, server = cli.build_server(cli.build_parser().parse_args(argv))
    server.start_background()
    sm = engine.model
    act_scale = sm.quant.act_scale if sm.quant is not None else None
    log(f"serving {name} {infer_dtype}: boot + warmup "
        f"{time.monotonic() - t0:.1f} s, buckets {engine.buckets}, "
        f"act_scale {act_scale}")
    check(sm.weights == weights and sm.preprocess_kind == kind,
          f"{name} did not load its weights with the '{kind}' ingest")
    n = N_SEQ + N_CONC
    imgs = np.random.RandomState(3).randint(
        0, 256, (n, *sm.input_shape), np.uint8)
    bodies = [json.dumps(dict(body, pixels=im.tolist())).encode()
              for im in imgs]
    path = f"/v1/{verb}"
    try:
        serve_ingest.launches = 0
        replies = [post(server.port, b, path) for b in bodies[:N_SEQ]]
        t1 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(N_CONC) as pool:
            replies += list(pool.map(lambda b: post(server.port, b, path),
                                     bodies[N_SEQ:]))
        conc_s = time.monotonic() - t1
        launches = serve_ingest.launches
        stats = engine.stats()
        wrong_verbs = {}
        for other in sorted(set(WORKLOADS) - {verb}):
            try:
                post(server.port, bodies[0], f"/v1/{other}")
                wrong_verbs[other] = (200, {})
            except urllib.error.HTTPError as e:
                wrong_verbs[other] = (e.code, json.loads(e.read()))
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    for other, (status, reply) in wrong_verbs.items():
        check(status == 400 and path in reply.get("error", ""),
              f"{name} on /v1/{other} answered {status} {reply}")
    check(launches == stats["batches"] > 0,
          f"{name}: serve_ingest launched {launches} times for "
          f"{stats['batches']} batches")
    check(stats["batches"] < len(replies),
          f"{name}: concurrent requests were never batched together")
    lat = sorted(r[2] for r in replies)
    pipe = stats["pipeline"]
    numbers = {"launches": launches, "requests": len(replies),
               "batches": stats["batches"],
               "padded_images": stats["padded_images"],
               "images_copied": stats["served"] + stats["padded_images"],
               "d2h_bytes": pipe["d2h_bytes"],
               "d2h_bytes_by_bucket": pipe["d2h_bytes_by_bucket"],
               "client_p50_ms": lat[len(lat) // 2] * 1e3,
               "concurrent_img_per_s": N_CONC / conc_s,
               "engine_latency_ms": stats["latency"],
               "device_idle_frac_host_proxy": pipe["device_idle_frac"],
               "wrong_verbs": {k: v[0] for k, v in wrong_verbs.items()},
               "act_scale": act_scale}
    return sm, imgs, replies, numbers


def hold_answers(name: str, sm, imgs, replies, body: dict, diff,
                 control: str = "imagenet") -> dict:
    """The served answers against direct plain-ingest calls at every
    bucket, within twice the card's own spread between buckets 1 and
    32 (at least one float32 step at 1 in scores and the boxes' 4-place
    rounding); then the same answers against the ``control`` ingest (an
    "imagenet" one for a [0, 1] model, "unit", without mean and std, for
    a classifier), which must fail on most rows."""
    refs = {b: direct_rows(sm, imgs, b) for b in BUCKETS}
    spread = bucket_spread(sm, refs, body, diff)
    bounds = (max(2 * spread["score"], 2 ** -23),
              max(2 * spread["position"], 1e-4))
    agree = compare_rows(sm, replies, refs, body, bounds, diff)
    log(f"{name}: batch-to-batch spread {json.dumps(spread)}; answers vs "
        f"direct plain-ingest calls: {json.dumps(agree)}")
    check(not agree["faults"], f"{name} answers: {agree['faults'][:5]}")
    wrong = compare_rows(sm, replies, {b: direct_rows(
        sm, imgs, b, control) for b in BUCKETS}, body, bounds, diff)
    log(f"{name} control, answers vs a '{control}' ingest: "
        f"{len(wrong['faults'])} of {len(replies)} fail")
    check(2 * len(wrong["faults"]) > len(replies),
          f"{name}: the answer check passed against a wrong ingest")
    return {"spread": spread, "bounds": list(bounds),
            "exact_answers": agree["exact"],
            "max_score_err": agree["max_score_err"],
            "max_pos_err": agree["max_pos_err"],
            "control_faults": len(wrong["faults"])}


def serve_detect(name: str, weights: str) -> dict:
    """Serve ``name`` int8 over HTTP on the card, 8 sequential then 24
    concurrent /v1/detect requests, and check them; returns the
    numbers."""
    import copy

    import torch

    from deep_vision_tpu_torch.serve.engine import map_leaves

    body = {"score_threshold": DETECT_FLOOR}
    sm, imgs, replies, out = serve_over_http(
        name, weights, "detect", body,
        ("--detect-topk", str(DETECT_TOPK),
         "--detect-score-threshold", str(DETECT_FLOOR)))
    check(out["d2h_bytes"] == DETECT_TOPK * DETECT_ROW_BYTES_PER_K
          * out["images_copied"] == sum(out["d2h_bytes_by_bucket"].values()),
          f"{name}: D2H {out['d2h_bytes']} B for {out['images_copied']} "
          f"padded images, not K·28 = "
          f"{DETECT_TOPK * DETECT_ROW_BYTES_PER_K} each")
    out.update(hold_answers(name, sm, imgs, replies, body, answer_diff))
    out["detections"] = sum(r[1]["num_detections"] for r in replies)
    check(out["detections"] > 0, f"{name} answered no detection at all")
    # host decode answers as device decode does, on one batch
    host = copy.copy(sm)
    host.detect_decode = "host"
    x = torch.from_numpy(imgs[:8]).to(sm.device)
    dense = host.compile_bucket(8)(x)
    dev = {k: v.cpu().numpy() for k, v in sm.compile_bucket(8)(x).items()}
    for i in range(8):
        row = map_leaves(lambda t, i=i: t[i].cpu().numpy(), dense)
        a = json.dumps(sm.workload.respond(host, body, row))
        b = json.dumps(sm.workload.respond(
            sm, body, {k: v[i] for k, v in dev.items()}))
        check(a == b, f"{name}: host decode answers otherwise than device "
                      f"decode on image {i}")
    out["by_bucket_ms"] = bucket_epilogue_ms(sm, BUCKETS)
    log(f"{name} detect serving: {json.dumps(out)}")
    return out


def phase_detect_serving() -> dict:
    """Serve yolov3_coco and centernet over /v1/detect on the card."""
    import torch

    out = {"tied_topk": check_tied_topk()}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        for seed, name in enumerate(DETECT_MODELS):
            weights = os.path.join(tmp, f"{name}.npz")
            write_weights(name, weights, seed)
            out[name] = serve_detect(name, weights)
            torch.cuda.empty_cache()
    return out


def phase_pose_serving() -> dict:
    """Serve hourglass104 int8 over /v1/pose on the card and check the
    answers, the D2H bytes and the decode against a host decode of the
    copied heatmaps."""
    import torch

    from deep_vision_tpu_torch.tasks.pose import (
        decode_heatmaps,
        heatmap_argmax,
    )

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        weights = os.path.join(tmp, f"{POSE_MODEL}.npz")
        write_weights(POSE_MODEL, weights, 5)
        sm, imgs, replies, out = serve_over_http(POSE_MODEL, weights,
                                                 "pose", {})
    check(out["d2h_bytes"] == POSE_ROW_BYTES * out["images_copied"]
          == sum(out["d2h_bytes_by_bucket"].values()),
          f"pose: D2H {out['d2h_bytes']} B for {out['images_copied']} "
          f"padded images, not {POSE_ROW_BYTES} each")
    out.update(hold_answers(POSE_MODEL, sm, imgs, replies, {}, pose_diff))
    # the device decode against a host decode of the same heatmaps
    # copied out (the last stack's): refined, and the integer peak of
    # heatmap_argmax
    x = torch.from_numpy(imgs[:8]).to(sm.device)
    heads = sm.compile_bucket(8, epilogue=False)(x)
    with torch.inference_mode():
        dev = sm.workload.make_epilogue(sm)(heads)
        coarse = decode_heatmaps(heads[-1], refine=False)["keypoints"].cpu()
    host = heads[-1].cpu()
    ref = decode_heatmaps(host)
    check(all(torch.equal(dev[k].cpu(), ref[k]) for k in ref),
          "pose: the device decode differs from the host decode of the "
          "copied heatmaps")
    peaks = np.stack([heatmap_argmax(h) for h in host.numpy()])
    check(np.array_equal(coarse.numpy(), peaks),
          "pose: the unrefined device decode differs from heatmap_argmax")
    out.update(heatmap_std=float(host.std()),
               by_bucket_ms=bucket_epilogue_ms(sm, BUCKETS))
    log(f"pose serving: {json.dumps(out)}")
    return out


def pipelined_from(name: str, sd: dict, pipe: int, micro: int):
    """Config ``name``'s monolithic weights ``sd`` in a ``PipelinedModel``
    over ``pipe`` places at PIPE_DEVICE, ``micro`` microbatches, float32
    (the last stage's re-injection convs, which no output reads, as
    constructed), placed."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.parallel import make_mesh
    from deep_vision_tpu_torch.parallel.pipelined import PipelinedModel

    mesh = make_mesh({"data": 1, "pipe": pipe}, pipe_device=PIPE_DEVICE)
    pm = PipelinedModel.for_model(get_config(name).model(), mesh, micro)
    pm.import_monolithic_variables(sd)
    return pm.set_compute_dtype(torch.float32).place()


def plain_loop(pm, micro: int):
    """``pm`` with its forward replaced by the plain loop the pipeline
    schedules: the stem on the batch, then each of ``micro`` contiguous
    microbatches through every stage in turn."""
    import torch

    def cat(parts):
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts)
        return tuple(cat([p[i] for p in parts]) for i in range(len(parts[0])))

    def forward(x):
        outs = [[] for _ in pm.stages]
        carry = pm.stem(x.to(pm.places[0]))
        for c in carry.split(x.shape[0] // micro):
            for s, stage in enumerate(pm.stages):
                c, o = stage(c)
                outs[s].append(o)
        return tuple(cat(o) for o in outs)

    pm.forward = forward
    return pm


#: the wall ms of the last ``pipe_step`` of each config, the loss read
STEP_MS: dict = {}


def pipe_step(name: str, model, batch: dict) -> tuple:
    """One float32 trainer step (the config's optimizer, Adam) of
    ``model`` on ``batch`` at PIPE_DEVICE: ``(loss, state before, state
    after)``, the states CPU ``state_dict``s in the monolithic layout;
    its wall ms to the loss read in ``STEP_MS[name]``."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu_torch.tasks.centernet import CenterNetTask
    from deep_vision_tpu_torch.tasks.pose import PoseTask

    cfg = get_config(name)
    task = PoseTask() if cfg.task == "pose" else \
        CenterNetTask(cfg.num_classes)

    def mono_sd(m):
        if hasattr(m, "export_monolithic_variables"):
            return m.export_monolithic_variables()
        return {k: v.detach().cpu().clone() for k, v in
                m.state_dict().items()}

    model.set_compute_dtype(torch.float32)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as work:
        trainer = Trainer(cfg, model, task, workdir=work,
                          preprocess_fn=make_scale_preprocess(),
                          device=PIPE_DEVICE,
                          mesh=getattr(model, "mesh", None))
        state = trainer.state_for(model)
        before = mono_sd(model)
        sync = torch.cuda.synchronize if PIPE_DEVICE.startswith("cuda") \
            else (lambda: None)
        sync()
        t0 = time.monotonic()
        state, m = trainer.train_step(state, batch)
        loss = float(m["loss"])
        STEP_MS[name] = (time.monotonic() - t0) * 1e3
        check(int(state.bad_steps) == 0, f"{name}: the step was skipped")
        return loss, before, mono_sd(model)


def same_tensors(a: dict, b: dict) -> bool:
    import torch

    return sorted(a) == sorted(b) and all(
        torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def pipe_placement(name: str, sd: dict) -> dict:
    """``memory_allocated`` taken by placing config ``name``'s pipelined
    model on PIPE_SIZE places of one card: the monolithic tensors plus
    the last stage's re-injection convs, each once."""
    import torch

    def rounded(t):  # the caching allocator's 512-byte blocks
        return -(-t.numel() * t.element_size() // 512) * 512

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    pm = pipelined_from(name, sd, PIPE_SIZE, 1)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    psd = pm.state_dict()
    mono_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    last = f"stages.{pm.num_stages - 1}.reinject"
    extra = sum(t.numel() * t.element_size() for k, t in psd.items()
                if k.startswith(last))
    want = sum(rounded(t) for t in psd.values())
    out = {"placed_bytes": placed, "tensor_bytes_rounded": want,
           "monolithic_bytes": mono_bytes, "reinject_extra_bytes": extra,
           "pipelined_bytes": sum(t.numel() * t.element_size()
                                  for t in psd.values()),
           "places": [str(d) for d in pm.places]}
    check(out["pipelined_bytes"] == mono_bytes + extra,
          f"pipelined tensors {out['pipelined_bytes']} B are not the "
          f"monolithic {mono_bytes} + re-injection {extra}")
    check(abs(placed - want) <= 4 * 2**20 and placed < 1.5 * mono_bytes,
          f"placing {PIPE_SIZE} places took {placed} B for {want} B of "
          f"tensors (monolithic {mono_bytes})")
    del pm
    torch.cuda.empty_cache()
    return out


def pipe_step_check(name: str, sd: dict, seed: int, pipe: int,
                    micro: int, monolithic: bool) -> dict:
    """Config ``name`` at full width from its seeded weights ``sd`` (its
    batch from ``seed + 1``), on ``pipe`` places at HEAT_CHECK_SIZE² with
    PIPE_CHECK_BATCH images, float32, under deterministic algorithms: the
    step at ``micro`` microbatches equals the plain loop over the same
    contiguous microbatches bit for bit.  With ``monolithic`` also: at
    one microbatch the eval forward and the step equal the monolithic
    network's bit for bit, and the step at ``micro`` misses the
    monolithic step (whole-batch statistics) by more than
    PIPE_CONTROL_BOUND (the control)."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config

    batch = heatmap_batch(name, PIPE_CHECK_BATCH, seed=seed + 1)
    out = {}
    with deterministic():
        if monolithic:
            mono_model = get_config(name).model()
            mono_model.load_state_dict(sd)
            mono_model.set_compute_dtype(torch.float32).to(PIPE_DEVICE)
            pm = pipelined_from(name, sd, pipe, 1)
            x = torch.rand((PIPE_CHECK_BATCH, HEAT_CHECK_SIZE,
                            HEAT_CHECK_SIZE, 3),
                           generator=torch.Generator().manual_seed(seed))
            with torch.no_grad():
                a = pm.eval()(x.to(PIPE_DEVICE))
                b = mono_model.eval()(x.to(PIPE_DEVICE))
            out["m1_forward_bit_equal"] = all(
                torch.equal(u, v) for u, v in zip(a, b))
            mono = pipe_step(name, mono_model, batch)
            out["monolithic_step_ms"] = STEP_MS[name]
            one = pipe_step(name, pm, batch)
            out["m1_step_bit_equal"] = one[0] == mono[0] and \
                same_tensors(one[2], mono[2])
            del pm, mono_model
        piped = pipe_step(name, pipelined_from(name, sd, pipe, micro), batch)
        out["step_ms"] = STEP_MS[name]
        loop = pipe_step(name, plain_loop(pipelined_from(name, sd, pipe,
                                                         micro), micro),
                         batch)
    out.update(loss=piped[0], loop_bit_equal=piped[0] == loop[0]
               and same_tensors(piped[2], loop[2]))
    check(math.isfinite(piped[0]), f"{name} pipelined loss {piped[0]}")
    check(out["loop_bit_equal"], f"{name}: the pipelined step at "
          f"{micro} microbatches differs from the plain loop over them")
    if monolithic:
        errs = update_errors(piped, mono)
        out.update(loss_monolithic=mono[0],
                   control_params_l2=errs["params"],
                   control_stats_l2=errs["stats"])
        check(out["m1_forward_bit_equal"] and out["m1_step_bit_equal"],
              f"{name} at one microbatch differs from the monolithic "
              f"network: {out}")
        check(errs["params"] > PIPE_CONTROL_BOUND,
              f"{name}: the step at {micro} microbatches is within "
              f"{PIPE_CONTROL_BOUND} of the whole-batch monolithic step "
              f"({errs['params']:.3e}): the control passed")
    torch.cuda.empty_cache()
    return out


def pipe_served(work: str) -> dict:
    """(c): ``load_state`` of the pipeline-trained workdir is the
    monolithic network, whose eval forward equals the pipelined model's
    from the same checkpoint; ``cli.serve --workdir`` serves those
    weights on /v1/pose with one ``serve_ingest`` launch a batch."""
    import torch

    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.restore import (
        PIPELINE_LAYOUT,
        checkpoint_weights,
        load_state,
    )
    from deep_vision_tpu_torch.models.hourglass import StackedHourglass
    from deep_vision_tpu_torch.ops.ingest import serve_ingest
    from deep_vision_tpu_torch.parallel.pipelined import (
        monolithic_state_dict,
    )

    info = {}
    mono = load_state(get_config(PIPE_MODEL), workdir=work, info=info)
    check(isinstance(mono, StackedHourglass)
          and info["layout"] == PIPELINE_LAYOUT,
          f"load_state of the pipeline workdir gave {type(mono).__name__} "
          f"({info})")
    weights = checkpoint_weights(Checkpointer(info["dir"]).load(
        info["step"]))
    merged = monolithic_state_dict(mono, weights)
    x = torch.rand((8, HEAT_SIZE, HEAT_SIZE, 3),
                   generator=torch.Generator().manual_seed(41))
    mono = mono.set_compute_dtype(torch.float32).to(PIPE_DEVICE).eval()
    out = {"step": info["step"], "dir": os.path.basename(info["dir"])}
    with deterministic(), torch.no_grad():
        want = mono(x.to(PIPE_DEVICE))
        pm = pipelined_from(PIPE_MODEL, merged, PIPE_SIZE, 1).eval()
        pm.load_state_dict(weights)
        for micro in (1, PIPE_MICRO):
            pm.num_microbatches = micro
            got = pm(x.to(PIPE_DEVICE))
            out[f"m{micro}_max_abs_err"] = max(
                float((u - v).abs().max()) for u, v in zip(got, want))
        del pm
    scale = max(float(v.abs().max()) for v in want)
    out["heatmap_max_abs"] = scale
    del mono
    torch.cuda.empty_cache()
    check(out["m1_max_abs_err"] == 0.0,
          f"the restored network's eval forward differs from the pipelined "
          f"model's at one microbatch: {out}")
    check(out[f"m{PIPE_MICRO}_max_abs_err"] <= 1e-3 * scale,
          f"the restored network's eval forward is more than 1e-3 of "
          f"{scale} from the pipelined model's at {PIPE_MICRO}: {out}")
    engine, server = boot_cli([
        "-m", PIPE_MODEL, "--workdir", work, "--wire-dtype", "uint8",
        "--infer-dtype", "float32", "--port", "0", "--device",
        PIPE_DEVICE.split(":")[0], "--max-batch",
        str(max(PIPE_SERVE_BUCKETS)),
        "--buckets", ",".join(map(str, PIPE_SERVE_BUCKETS)), "--warmup"])
    sm = engine.model
    imgs = np.random.RandomState(7).randint(
        0, 256, (N_SEQ + PIPE_SERVE_CONC, *sm.input_shape), np.uint8)
    bodies = [json.dumps({"pixels": im.tolist()}).encode() for im in imgs]
    try:
        got = sm._model.state_dict()
        same = same_tensors({k: v for k, v in got.items()}, merged)
        serve_ingest.launches = 0
        replies = [post(server.port, b, "/v1/pose") for b in bodies[:N_SEQ]]
        with concurrent.futures.ThreadPoolExecutor(PIPE_SERVE_CONC) as pool:
            replies += list(pool.map(
                lambda b: post(server.port, b, "/v1/pose"), bodies[N_SEQ:]))
        launches = serve_ingest.launches
        batches = engine.stats()["batches"]
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    check(same, "cli.serve --workdir did not serve the merged pipeline "
                "checkpoint's weights")
    check(launches == batches > 0, f"pipeline workdir on /v1/pose: "
          f"serve_ingest launched {launches} times for {batches} batches")
    # the sequential requests ran one a batch: each answer is the direct
    # bucket-1 call's exactly, and not an "imagenet" ingest's (phase 15
    # holds the concurrent batches of this path at every bucket)
    seq = replies[:N_SEQ]
    agree = compare_rows(sm, seq, {1: direct_rows(sm, imgs[:N_SEQ], 1)},
                         {}, (0.0, 0.0), pose_diff)
    wrong = compare_rows(sm, seq, {1: direct_rows(sm, imgs[:N_SEQ], 1,
                                                  "imagenet")},
                         {}, (0.0, 0.0), pose_diff)
    check(all(r[0] == 200 for r in replies) and agree["exact"] == N_SEQ,
          f"pipeline workdir on /v1/pose: {agree}")
    check(2 * len(wrong["faults"]) > N_SEQ,
          "pipeline workdir on /v1/pose: the answers held against an "
          "'imagenet' ingest")
    out.update(launches=launches, batches=batches, requests=len(replies),
               exact_sequential=agree["exact"],
               control_faults=len(wrong["faults"]))
    return out


def phase_pipeline_training(pose_data: str) -> dict:
    """The pipeline training mode on one card (docstring, phase 15a):
    (a) cli.train on a pipe grid over phase 13's records, (b) the step
    checks and the placement bytes, (c) the workdir served as the
    monolithic network, (d) CenterNet on a grid of two."""
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer

    out, seconds = {}, {}
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        work = os.path.join(tmp, "work")
        run, _ = train_and_resume(
            PIPE_MODEL, pose_data, work, HEAT_WORKERS,
            HEAT_TRAIN // HEAT_BATCH, epochs=DETECT_EPOCHS,
            extra=["--mesh", f"data=1,pipe={PIPE_SIZE}", "--microbatches",
                   str(PIPE_MICRO), "--device", PIPE_DEVICE])
        keys = list(Checkpointer(os.path.join(work, "checkpoints")).load()[
            "state"]["model"])
        check(all(k.startswith(("stem.", "stages.")) for k in keys)
              and f"stages.{PIPE_SIZE - 1}.reinject_heat.weight" in keys,
              f"the pipeline run's checkpoint is not in the pipelined "
              f"layout: {keys[:4]}")
        out["train"] = run
        log(f"pipeline training: {json.dumps(run)}")
        seconds["train"] = time.monotonic() - t0
        out["served"] = pipe_served(work)
        log(f"pipeline served: {json.dumps(out['served'])}")
        seconds["served"] = time.monotonic() - t0 - seconds["train"]
    t1 = time.monotonic()
    sd = seeded_model(PIPE_MODEL, 13).state_dict()
    out["placement"] = pipe_placement(PIPE_MODEL, sd)
    out["step_check"] = pipe_step_check(PIPE_MODEL, sd, 13, PIPE_SIZE,
                                        PIPE_MICRO, monolithic=True)
    seconds["step_check"] = time.monotonic() - t1
    t1 = time.monotonic()
    out["centernet"] = pipe_step_check(
        PIPE_CENTERNET, seeded_model(PIPE_CENTERNET, 17).state_dict(), 17,
        2, 2, monolithic=False)
    seconds["centernet"] = time.monotonic() - t1
    out["seconds"] = seconds
    log(f"pipeline checks: {json.dumps({k: out[k] for k in ('placement', 'step_check', 'centernet')})}")
    return out


def phase_train_kernels() -> list[dict]:
    """train_ingest vs its plain version at the training shapes."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import ingest_norm_constants
    from deep_vision_tpu_torch.ops.train_ingest import (
        GRAY,
        tiled_path,
        train_ingest,
        train_ingest_factors,
        train_ingest_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    mean, std = ingest_norm_constants("imagenet", 3)
    shift = torch.tensor(-mean / std, device="cuda")
    inv_std = torch.tensor(1.0 / std, device="cuda")
    gray_col = torch.tensor(GRAY, device="cuda").view(3, 1)

    def library(p):
        """Fewest-ops PyTorch expression of the same function."""
        x, f = p
        fb, fc, fs, m = f.t().reshape(4, -1, 1, 1, 1).unbind(0)
        y = torch.addcmul(m * (1 - fc), x.float(), fb * fc / 255)
        y = torch.lerp(y @ gray_col, y, fs).clamp_(0, 1)
        return torch.addcmul(shift, y, inv_std)

    def kernel(p):
        return train_ingest(*p)

    def plain(p):
        return train_ingest_plain(*p)

    rows = []
    for shape in TRAIN_SHAPES + ZOO_TRAIN_SHAPES:
        numel = math.prod(shape)
        n_bufs = max(2, min(128, math.ceil(100e6 / (5 * numel))))
        pairs = []
        for _ in range(n_bufs):
            x = torch.randint(0, 256, shape, dtype=torch.uint8,
                              device="cuda", generator=gen)
            pairs.append((x, train_ingest_factors(x, gen)))
        got, want = kernel(pairs[0]), plain(pairs[0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"train_ingest differs from plain at {shape}: max err {err}")
        lib_err = float((library(pairs[0]) - want).abs().max())
        check(lib_err < 1e-4, f"the library expression is not the same "
                              f"function at {shape}: {lib_err}")
        bytes_moved = numel + 16 * shape[0] + 4 * numel
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = numel * TRAIN_INGEST_OPS / F32_OPS_PER_S * 1e3
        row = {"shape": list(shape), "max_abs_err": err,
               "ms": device_ms(kernel, pairs),
               "call_ms": call_ms(kernel, pairs),
               "plain_ms": device_ms(plain, pairs),
               "library_ms": device_ms(library, pairs),
               "library_max_abs_err": lib_err,
               "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops
               else "operations",
               # the factor draw before each launch: three draws and the
               # int64 image sum, which reads the batch once
               "factors_ms": device_ms(
                   lambda p: train_ingest_factors(p[0], None), pairs),
               "factors_bound_ms": (numel + 16 * shape[0])
               / HBM_BYTES_PER_S * 1e3}
        rows.append(row)
        log(f"train_ingest {shape}: device {row['ms'] * 1e3:.2f} us "
            f"(eager call {row['call_ms'] * 1e3:.2f}, plain "
            f"{row['plain_ms'] * 1e3:.2f}, library "
            f"{row['library_ms'] * 1e3:.2f}, bound "
            f"{row['bound_ms'] * 1e3:.2f} us; factors "
            f"{row['factors_ms'] * 1e3:.2f} us, bound "
            f"{row['factors_bound_ms'] * 1e3:.2f}), max err {err}")
        del pairs
    for name, shape, drop in TRAIN_EDGE_CASES:
        full = torch.randint(0, 256, shape, dtype=torch.uint8,
                             device="cuda", generator=gen)
        x = full[drop:]
        aligned = x.data_ptr() % 16 == 0
        check(x.is_contiguous() and aligned == (drop == 0),
              f"train_ingest edge case {name} is not the case it names")
        factors = train_ingest_factors(x, gen)
        got, want = kernel((x, factors)), plain((x, factors))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"train_ingest differs from plain "
                                      f"at {name} {tuple(x.shape)}: {err}")
        rows.append({"edge": name, "shape": list(x.shape),
                     "tiled": tiled_path(x.data_ptr(), got.data_ptr(),
                                         x.shape[1] * x.shape[2]),
                     "max_abs_err": err})
        log(f"train_ingest {name} {tuple(x.shape)}: bit-identical "
            f"(tiled path {rows[-1]['tiled']})")
        del full, x, got, want
    empty = torch.empty((0, 224, 224, 3), dtype=torch.uint8, device="cuda")
    before = train_ingest.launches
    out = train_ingest(empty, torch.empty((0, 4), device="cuda"))
    check(out.shape == empty.shape and train_ingest.launches == before,
          "an empty batch must return an empty batch and launch nothing")
    return rows


def iou_inputs(shape, gen, edge: bool = False, unmasked: float = 0.7,
               near_tie: bool = False):
    """Seeded (pred, gt, mask) for ``best_iou_max`` at (B, N, M): boxes
    with centres in [0, 1] and sides in [0.01, 0.5], a share ``unmasked``
    of the ground truths unmasked.  ``edge`` adds the edge cases: image 0
    wholly masked, zero-area boxes, a NaN prediction row in images 0 and
    1 (NaN out in image 1, 0 in the masked image 0), and ground truths
    that are not finite (inf, NaN, 1e30 corners) in image 1.
    ``near_tie`` makes ties the reduction must break exactly: the second
    half of each image's ground truths repeats the first half, every
    other one a few ulps off, and half the predictions are ground truths
    moved by a few ulps."""
    import torch

    b, n, m = shape

    def boxes(count):
        xy = torch.rand((b, count, 2), generator=gen, device="cuda")
        wh = torch.rand((b, count, 2), generator=gen, device="cuda") \
            * 0.49 + 0.01
        return torch.cat([xy - wh / 2, xy + wh / 2], -1).contiguous()

    def ulps_off(t, most):
        step = torch.randint(-most, most + 1, t.shape, generator=gen,
                             device="cuda", dtype=torch.int32)
        return (t.view(torch.int32) + step).view(torch.float32)

    pred, gt = boxes(n), boxes(m)
    if near_tie and m >= 2:
        half = m // 2
        twin = gt[:, :half].clone()
        twin[:, 1::2] = ulps_off(twin[:, 1::2], 2)
        gt[:, half:2 * half] = twin
        src = gt[:, torch.randint(0, m, (n,), generator=gen, device="cuda")]
        take = torch.rand((b, n, 1), generator=gen, device="cuda") < 0.5
        pred = torch.where(take, ulps_off(src, 3), pred).contiguous()
    mask = (torch.rand((b, m), generator=gen, device="cuda")
            < unmasked).float()
    if edge:
        mask[0] = 0.0
        pred[:, ::7, 2] = pred[:, ::7, 0]       # zero width
        gt[:, ::5, 3] = gt[:, ::5, 1]           # zero height
        pred[0, 3] = float("nan")
        pred[min(1, b - 1), 5] = float("nan")
        if b > 1 and m > 3:
            gt[1, 1, 2] = float("inf")
            gt[1, 2, 0] = float("nan")
            gt[1, 3] = torch.tensor([-1e30, -1e30, 1e30, 1e30])
            mask[1, 1:4] = 1.0
    return pred, gt, mask


def iou_differing(got, want) -> int:
    """Elements whose float32 bits differ, NaN matching any NaN."""
    import torch

    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    return int((~same).sum())


def kernel_resources(name: str) -> list[dict]:
    """Registers, static shared memory, stack and local (spill) bytes a
    thread of each kernel in the built ``csrc/<name>.cu``, as ``cuobjdump
    --dump-resource-usage`` reads them from the library."""
    from deep_vision_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "--dump-resource-usage",
                           _build.library_path(name)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    rows, function = [], None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            function = line[len("Function "):].rstrip(":")
        elif line.startswith("REG:") and function is not None:
            usage = dict(kv.split(":", 1) for kv in line.split())
            rows.append({"function": function, "registers": int(usage["REG"]),
                         "shared_bytes": int(usage["SHARED"]),
                         "stack_bytes": int(usage["STACK"]),
                         "local_bytes": int(usage["LOCAL"])})
            function = None
    check(bool(rows), f"cuobjdump found no kernel in {name}")
    for r in rows:
        log(f"{name} {r['function']}: {r['registers']} registers, "
            f"{r['shared_bytes']} B shared, {r['stack_bytes']} B stack, "
            f"{r['local_bytes']} B local (spills)")
    return rows


#: the timed best_iou_max inputs: shape, set name, unmasked share, near
#: ties; the largest shape also on near ties, at a COCO-like share (COCO
#: images hold about 7 boxes of MAX_BOXES = 100) and at the YOLOv3 run's
#: share (its synthetic scenes hold 1-3 boxes, 2 on average)
IOU_CASES = [(IOU_SHAPES[0], "mixed", 0.7, False),
             (IOU_MICRO_SHAPE, "microbatch", 0.7, False),
             (IOU_SHAPES[0], "near_tie", 0.7, True),
             (IOU_SHAPES[0], "coco_share", 0.07, False),
             (IOU_SHAPES[0], "run_share", 0.02, False)] + [
                 (shape, "mixed", 0.7, False) for shape in IOU_SHAPES[1:]]


def phase_iou_kernels() -> list[dict]:
    """best_iou_max vs its plain version at the YOLOv3 416² loss shapes
    (B=128; N = 3·52², 3·26², 3·13²; M = 100), with near ties and at a
    COCO-like unmasked share at the largest, and on the edge cases."""
    import torch

    from deep_vision_tpu_torch.ops.best_iou import (
        best_iou_max,
        best_iou_max_plain,
    )

    resources = kernel_resources("best_iou_max")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape, name, unmasked, near_tie in IOU_CASES:
        b, n, m = shape
        per_set = b * (n + m) * 20
        n_sets = max(2, min(16, math.ceil(100e6 / per_set)))
        sets = [iou_inputs(shape, gen, edge=(k == 0), unmasked=unmasked,
                           near_tie=near_tie) for k in range(n_sets)]
        got, want = best_iou_max(*sets[0]), best_iou_max_plain(*sets[0])
        torch.cuda.synchronize()
        diff = iou_differing(got, want)
        check(diff == 0, f"best_iou_max differs from plain at {shape} "
                         f"{name} in {diff} elements")
        check(bool(want[1].isnan().any()) and bool((want[0] == 0).all()),
              "the edge cases did not reach the output (NaN row, masked "
              "image)")
        ok = ~(got.isnan() | want.isnan())
        err = float((got[ok] - want[ok]).abs().max())
        # the timed sets without the edge set's non-finite ground truths;
        # the first of them is held against the plain version too
        timed = sets[1:]
        timed_diff = iou_differing(best_iou_max(*timed[0]),
                                   best_iou_max_plain(*timed[0]))
        check(timed_diff == 0, f"best_iou_max differs from plain at "
                               f"{shape} {name} (a timed set) in "
                               f"{timed_diff} elements")
        on = torch.stack([s[2].gt(0).sum(1) for s in timed]).double()
        pairs_on = float(on.sum(1).mean()) * n    # unmasked pairs a call
        ops = IOU_OPS_PER_PAIR * pairs_on + IOU_OPS_MASK * b * m \
            + IOU_OPS_AREA * b * (n + m)
        bound_ops = ops / F32_OPS_PER_S * 1e3
        bound_bytes = (b * n * (16 + 4) + b * m * (16 + 4)) \
            / HBM_BYTES_PER_S * 1e3

        def kernel(p):
            return best_iou_max(*p)

        def plain(p):
            return best_iou_max_plain(*p)

        row = {"shape": list(shape), "set": name, "unmasked": unmasked,
               "differing": diff, "max_abs_err": err,
               "nan_rows": int(got.isnan().any(1).sum()),
               "ms": device_ms(kernel, timed),
               "call_ms": call_ms(kernel, timed),
               "plain_ms": device_ms(plain, timed, reps=5),
               "library_ms": None,
               "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops
               else "operations", "pairs": b * n * m,
               "unmasked_pairs": pairs_on, "resources": resources}
        rows.append(row)
        log(f"best_iou_max {shape} {name}: device {row['ms'] * 1e3:.2f} us "
            f"(eager call {row['call_ms'] * 1e3:.2f}, plain "
            f"{row['plain_ms'] * 1e3:.2f}, bound {row['bound_ms'] * 1e3:.2f}"
            f" us by {row['bound_by']}), {diff} differing elements")
        del sets, timed
    # ragged N, M past one shared-memory chunk, M = 0, empty batch
    for shape in ((3, 1000, 7), (2, 300, 600), (2, 100, 0)):
        for near_tie in (False, True):
            p = iou_inputs(shape, gen, edge=shape[2] > 0, near_tie=near_tie)
            got, want = best_iou_max(*p), best_iou_max_plain(*p)
            torch.cuda.synchronize()
            diff = iou_differing(got, want)
            check(diff == 0, f"best_iou_max differs from plain at {shape} "
                             f"(near ties {near_tie}) in {diff} elements")
            if shape[2] == 0:
                check(bool((got == 0).all()), "M = 0 must give 0")
    before = best_iou_max.launches
    out = best_iou_max(torch.empty((0, 10, 4), device="cuda"),
                       torch.empty((0, 5, 4), device="cuda"),
                       torch.empty((0, 5), device="cuda"))
    check(out.shape == (0, 10) and best_iou_max.launches == before,
          "an empty batch must return an empty result and launch nothing")
    return rows


def write_records(root: str, n_train: int = N_TRAIN, n_val: int = N_VAL,
                  stored: int = STORED) -> None:
    """Seeded raw-payload dvrec shards (``prepare_data --store raw``),
    stored at the loader's resize so no resize is needed."""
    from deep_vision_tpu_torch.data.records import RecordWriter, shard_name

    rng = np.random.default_rng(3)
    for split, n, shards in (("train", n_train, 4), ("val", n_val, 1)):
        labels = rng.integers(0, 1000, n)
        for i in range(shards):
            with RecordWriter(shard_name(root, split, i, shards)) as w:
                for j in range(i, n, shards):
                    img = rng.integers(0, 256, (stored, stored, 3),
                                       dtype=np.uint8)
                    w.write({"label": int(labels[j]), "enc": "raw",
                             "shape": [stored, stored, 3]}, img.tobytes())


def state_digest(model_sd: dict, opt_state: dict) -> str:
    """One hash over parameters, buffers and the optimizer's tensors
    (SGD momentum; Adam's mu, nu and count), nested dicts flattened."""
    import hashlib

    import torch

    def leaves(tree, prefix=""):
        for key in sorted(tree):
            v = tree[key]
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{key}/")
            elif isinstance(v, torch.Tensor):
                yield f"{prefix}{key}", v

    h = hashlib.blake2b(digest_size=8)
    for part in (model_sd, opt_state):
        for key, v in leaves(part):
            a = v.detach().cpu().contiguous()
            h.update(key.encode())
            h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def phase_training() -> dict:
    """cli.train end to end for resnet50 at full width on the card."""
    import torch

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        data, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        t0 = time.monotonic()
        write_records(data)
        log(f"training: wrote {N_TRAIN}+{N_VAL} raw records in "
            f"{time.monotonic() - t0:.1f} s")
        argv = ["-m", MODEL, "--data-format", "records", "--data-root", data,
                "--workdir", work, "--num-workers", str(WORKERS),
                "--device", "cuda"]
        steps = N_TRAIN // BATCH
        torch.cuda.reset_peak_memory_stats()
        train_ingest.launches = 0
        t0 = time.monotonic()
        check(cli.main(argv + ["--epochs", str(EPOCHS)]) == 0,
              "cli.train failed")
        first_s = time.monotonic() - t0
        first = train_ingest.launches
        check(first == EPOCHS * steps,
              f"train_ingest launched {first} times in {EPOCHS * steps} "
              f"train steps")
        ckpts = Checkpointer(os.path.join(work, "checkpoints"))
        check(ckpts.all_steps() == [steps * e for e in range(1, EPOCHS + 1)],
              f"checkpoints {ckpts.all_steps()}, not one per epoch")
        saved = ckpts.load(EPOCHS * steps)["state"]
        want_digest = state_digest(saved["model"],
                                   saved["optimizer"]["momentum"])
        resumed = {}
        original = Trainer.maybe_resume

        def spy(self, state):
            state = original(self, state)
            resumed.update(
                step=state.step, epoch=self.start_epoch,
                digest=state_digest(state.model.state_dict(),
                                    state.opt.state_dict()["momentum"]))
            return state

        Trainer.maybe_resume = spy
        try:
            t0 = time.monotonic()
            check(cli.main(argv + ["--resume", "--epochs",
                                   str(RESUME_EPOCHS)]) == 0,
                  "cli.train --resume failed")
            resume_s = time.monotonic() - t0
        finally:
            Trainer.maybe_resume = original
        launches = train_ingest.launches
        peak = torch.cuda.max_memory_allocated()
        check(launches - first == (RESUME_EPOCHS - EPOCHS) * steps,
              f"the resumed run launched train_ingest {launches - first} "
              f"times in {(RESUME_EPOCHS - EPOCHS) * steps} steps")
        check(resumed == {"step": EPOCHS * steps, "epoch": EPOCHS + 1,
                          "digest": want_digest},
              f"resume restored {resumed}, not step {EPOCHS * steps} "
              f"epoch {EPOCHS + 1} digest {want_digest}")
        check(ckpts.all_steps() == [steps * e
                                    for e in range(1, RESUME_EPOCHS + 1)],
              f"checkpoints after resume: {ckpts.all_steps()}")
        series: dict[str, list] = {}
        with open(os.path.join(work, "metrics.jsonl")) as f:
            for line in f:
                d = json.loads(line)
                series.setdefault(d["name"], []).append((d["step"],
                                                         d["value"]))
        losses = series.get("train_loss", [])
        check(bool(losses), "no train loss was logged")
        check(all(math.isfinite(v) for _, v in losses),
              f"non-finite train loss: {losses}")
        check(all(v == 0 for _, v in series["train_bad_steps"]),
              f"bad steps: {series['train_bad_steps']}")
        step_ms = [v for _, v in series["train_step_ms"]]
        out = {"train_ingest_launches": launches,
               "train_steps": RESUME_EPOCHS * steps,
               "first_run_s": first_s, "resumed_run_s": resume_s,
               "step_ms_by_epoch": step_ms,
               "img_per_s_by_epoch": [BATCH * 1e3 / v for v in step_ms],
               "peak_memory_bytes": peak,
               "losses": losses,
               "input_stall_frac": [v for _, v in
                                    series.get("input_stall_frac", [])],
               "final_val_top1": series["val_top1"][-1][1],
               "final_val_top5": series["val_top5"][-1][1],
               "checkpoints": ckpts.all_steps(),
               "resumed": resumed}
        log(f"training: {json.dumps(out)}")
    return out


def native_pass(data: str, split: str, train: bool, seed: int = 0
                ) -> tuple:
    """One epoch of ``split`` through ``ImageNetLoader`` at 0 workers:
    (batches, seconds)."""
    from deep_vision_tpu_torch.data.imagenet import ImageNetLoader

    loader = ImageNetLoader.from_records(
        data, split, BATCH, train=train, image_size=CROP, resize=STORED,
        num_workers=0, seed=seed)
    loader.set_epoch(1)
    t0 = time.monotonic()
    try:
        batches = list(loader)
    finally:
        loader.close()
    return batches, time.monotonic() - t0


def batches_equal(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        sorted(g) == sorted(w) and all(np.array_equal(g[k], w[k])
                                       for k in w)
        for g, w in zip(got, want))


def phase_native_input(training: dict) -> dict:
    """The native dvrec reader: built here, byte for byte the numpy
    path, and counted on ``cli.train``'s 0-worker path."""
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.data import native
    from deep_vision_tpu_torch.data.imagenet import ImageNetLoader
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        # a compile into an empty directory, timed whatever _build holds
        t0 = time.monotonic()
        built = native.build(os.path.join(tmp, "build"))
        build_s = time.monotonic() - t0
        check(built is not None and native.load() is not None,
              f"no C++ compiler for the native reader "
              f"({native.compiler()})")
        log(f"native input: built {os.path.basename(built)} with "
            f"{native.compiler()} in {build_s:.2f} s")
        count = native.assemble_batch
        out = {"build_s": build_s, "compiler": native.compiler()}
        data = os.path.join(tmp, "data")
        t0 = time.monotonic()
        write_records(data, N_TRAIN, N_VAL, STORED)
        out["write_s"] = time.monotonic() - t0
        passes = {}
        for split, train in (("train", True), ("val", False)):
            before = count.batches
            got, native_s = native_pass(data, split, train)
            n_native = count.batches - before
            real = ImageNetLoader._native_batch
            ImageNetLoader._native_batch = lambda self, args, n_real: None
            try:
                want, numpy_s = native_pass(data, split, train)
            finally:
                ImageNetLoader._native_batch = real
            check(count.batches - before == n_native == len(got),
                  f"native input {split}: the reader counted {n_native} "
                  f"of {len(got)} batches")
            check(batches_equal(got, want),
                  f"native input {split}: native batches differ from the "
                  f"numpy path's")
            images = sum(len(b["image"]) for b in got)
            passes[split] = {"batches": len(got),
                             "native_img_s": images / native_s,
                             "numpy_img_s": images / numpy_s}
            if train:  # control: another seed draws other crops, flips
                other, _ = native_pass(data, split, train, seed=1)
                check(not np.array_equal(other[0]["image"],
                                         got[0]["image"]),
                      "native input: a batch drawn with another seed "
                      "equals seed 0's")
        out["passes"] = passes
        log(f"native input: {json.dumps(passes)}")
        work = os.path.join(tmp, "work")
        steps = N_TRAIN // BATCH
        val_batches = -(-N_VAL // BATCH)
        train_ingest.launches = 0
        before = count.batches
        t0 = time.monotonic()
        check(cli.main(["-m", MODEL, "--data-format", "records",
                        "--data-root", data, "--workdir", work,
                        "--num-workers", "0", "--epochs", "1",
                        "--device", CLI_DEVICE]) == 0,
              "cli.train --num-workers 0 failed")
        out["cli_s"] = time.monotonic() - t0
        out["train_ingest_launches"] = train_ingest.launches
        out["native_batches"] = count.batches - before
        check(train_ingest.launches == steps,
              f"native input: train_ingest launched "
              f"{train_ingest.launches} times in {steps} steps")
        # train batches, the epoch's eval and the final eval
        check(out["native_batches"] == steps + 2 * val_batches,
              f"native input: the reader assembled {out['native_batches']} "
              f"batches, not {steps} train + 2 x {val_batches} eval")
        series = read_series(work)
        losses = [v for _, v in series.get("train_loss", [])]
        check(bool(losses) and all(math.isfinite(v) for v in losses),
              f"native input: losses {losses}")
        out["losses"] = losses
        out["step_ms"] = [v for _, v in series.get("train_step_ms", [])]
        out["input_stall_frac"] = [v for _, v in
                                   series.get("input_stall_frac", [])]
        out["workers_4"] = {"step_ms": training["step_ms_by_epoch"],
                            "input_stall_frac":
                                training["input_stall_frac"]}
        out["folder_refusal"] = folder_refusal(tmp)
    log(f"native input: {json.dumps(out)}")
    return out


def folder_refusal(tmp: str) -> str:
    """``cli.train --data-format folder`` on the card: an error that
    names PIL (blocked here for the check where the machine has it)."""
    import importlib.util

    from deep_vision_tpu_torch.cli import train as cli

    root = os.path.join(tmp, "folder")
    for d in ("train", "val"):
        os.makedirs(os.path.join(root, d))
    with open(os.path.join(root, "imagenet_2012_metadata.txt"), "w") as f:
        f.write("n01440764\ttench, Tinca tinca\n")
    have_pil = importlib.util.find_spec("PIL") is not None
    log(f"native input: PIL {'installed' if have_pil else 'absent'}, cv2 "
        f"{'installed' if importlib.util.find_spec('cv2') else 'absent'} "
        f"on this machine")
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "PIL" or k.startswith("PIL.")}
    if have_pil:
        sys.modules["PIL"] = None
    try:
        cli.main(["-m", MODEL, "--data-root", root, "--workdir",
                  os.path.join(tmp, "folder_work"), "--num-workers", "0",
                  "--device", CLI_DEVICE])
    except ImportError as e:
        message = str(e)
    else:
        message = ""
    finally:
        sys.modules.pop("PIL", None)
        sys.modules.update(saved)
    check("PIL" in message,
          f"cli.train --data-format folder did not fail naming PIL "
          f"({message!r})")
    log(f"native input: folder run refused (PIL installed: {have_pil}): "
        f"{message}")
    return message


def one_step(device: str, model_sd: dict, images, factors, workdir: str
             ) -> tuple[float, dict, dict]:
    """One float32 train step of full-width ResNet-50 on ``device``:
    (loss, state_dict before, state_dict after), both on the CPU."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.models.resnet import ResNet50
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    cfg = get_config(MODEL)
    cfg.batch_size = STEP_CHECK_BATCH
    model = ResNet50(dtype=torch.float32)
    model.load_state_dict(model_sd)
    f = factors.to(device)

    def preprocess(batch, generator, train):
        return {**batch, "image": train_ingest(batch["image"], f)}

    trainer = Trainer(cfg, model, ClassificationTask(1000), workdir=workdir,
                      preprocess_fn=preprocess, device=device)
    state = trainer.state_for(model)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    batch = {"image": images, "label": np.arange(STEP_CHECK_BATCH,
                                                 dtype=np.int32) * 97}
    state, m = trainer.train_step(state, batch)
    after = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    check(int(m["bad_steps"]) == 0, f"the {device} step was skipped")
    return float(m["loss"]), before, after


def update_errors(got, want) -> dict:
    """One step's updates (running statistics included) against another's:
    per tensor, ``max`` = max|Δgot − Δwant| / max|Δwant| and ``l2`` =
    ‖Δgot − Δwant‖ / ‖Δwant‖; and ``params`` / ``stats``, one L2 ratio
    over all parameters and over all running statistics (apart, since the
    statistics' updates are the larger and would hide the parameters')."""
    (_, gb, ga), (_, wb, wa) = got, want
    out = {"max": {}, "l2": {}}
    sums = {"params": [0.0, 0.0], "stats": [0.0, 0.0]}
    for k in wa:
        if k.endswith("num_batches_tracked"):
            continue
        dw, dg = wa[k] - wb[k], ga[k] - gb[k]
        err, ref = float((dg - dw).norm()), float(dw.norm())
        out["max"][k] = float((dg - dw).abs().max()) / max(
            float(dw.abs().max()), 1e-30)
        out["l2"][k] = err / max(ref, 1e-30)
        part = sums["stats" if k.endswith(("running_mean", "running_var"))
                    else "params"]
        part[0] += err ** 2
        part[1] += ref ** 2
    for part, (num, den) in sums.items():
        out[part] = (num / max(den, 1e-30)) ** 0.5
    return out


def compare_steps(got, want) -> list[str]:
    """Faults of step ``got`` against step ``want``: the loss beyond 1e-4
    relative, the parameters' updates beyond 1e-3 or the running
    statistics' beyond 1e-4 in L2, or one tensor's update beyond 5e-2 in
    L2.  A ReLU gate near zero flips under rounding, so single elements
    may differ by much more: on the H100 host, moving the CPU's own
    weights by 1e-7 (relative; ``floor`` in the output) moved its
    parameters' update 1.1e-4 in L2, one tensor 1.3e-2 in L2 and one
    element 0.12·max|Δ| of its tensor, the running statistics 3.8e-7; the
    card against the CPU read 8.4e-5, 6.0e-3, 4.9e-2·max|Δ| and 4.1e-7;
    the swapped-factor control 0.36 on the parameters."""
    faults = []
    if abs(got[0] - want[0]) > 1e-4 * abs(want[0]):
        faults.append(f"loss {got[0]} vs {want[0]}")
    errs = update_errors(got, want)
    if errs["params"] > 1e-3:
        faults.append(f"parameter updates {errs['params']:.3e} in L2")
    if errs["stats"] > 1e-4:
        faults.append(f"running statistics {errs['stats']:.3e} in L2")
    faults += [f"{k}: {e:.3e} in L2" for k, e in errs["l2"].items()
               if e > 5e-2]
    return faults


def branch_grad_share(step, decay: float) -> float:
    """The least share of a residual branch conv's update that is not
    weight decay: min ‖Δ + decay·p‖ / ‖Δ‖ over the blocks' convs."""
    _, before, after = step
    return min(float((after[k] - before[k] + decay * before[k]).norm()
                     / (after[k] - before[k]).norm())
               for k in after if k.startswith("layer") and ".conv" in k)


def phase_step_check() -> dict:
    """float32 step on the card (kernel) vs on the CPU (plain version)."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.models.resnet import ResNet50
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest_factors

    model = ResNet50().reset_parameters(torch.Generator().manual_seed(5))
    for stage in model.stages():
        for block in stage:
            torch.nn.init.constant_(getattr(block, f"bn{block.convs}").weight,
                                    STEP_CHECK_LAST_SCALE)
    sd = model.state_dict()
    images = np.random.default_rng(4).integers(
        0, 256, (STEP_CHECK_BATCH, 224, 224, 3), dtype=np.uint8)
    factors = train_ingest_factors(torch.from_numpy(images),
                                   torch.Generator().manual_seed(6))
    swapped = factors.clone()
    swapped[[0, 1]] = factors[[1, 0]]
    # the CPU's own step from weights moved by 1e-7 (relative): how far
    # rounding alone moves an update (the floor under the bounds)
    gen = torch.Generator().manual_seed(9)
    moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             if v.is_floating_point() else v for k, v in sd.items()}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        t0 = time.monotonic()
        cpu = one_step("cpu", sd, images, factors, os.path.join(tmp, "c"))
        cpu_s = time.monotonic() - t0
        floor = update_errors(one_step("cpu", moved, images, factors,
                                       os.path.join(tmp, "m")), cpu)
        gpu = one_step("cuda", sd, images, factors, os.path.join(tmp, "g"))
        control = one_step("cuda", sd, images, swapped,
                           os.path.join(tmp, "s"))
    opt = get_config(MODEL).optimizer
    share = branch_grad_share(cpu, opt.learning_rate * opt.weight_decay)
    faults = compare_steps(gpu, cpu)
    control_faults = compare_steps(control, cpu)
    errs = update_errors(gpu, cpu)
    out = {"loss_cuda": gpu[0], "loss_cpu": cpu[0],
           "branch_grad_share_min": share,
           "params_l2_update_err": errs["params"],
           "stats_l2_update_err": errs["stats"],
           "worst_tensor_l2_update_err": max(errs["l2"].values()),
           "worst_rel_elem_update_err": max(errs["max"].values()),
           "tensors_above_1e-2_elem": sorted(k for k, e in errs["max"].items()
                                             if e > 1e-2),
           "floor": {"params_l2": floor["params"],
                     "stats_l2": floor["stats"],
                     "worst_tensor_l2": max(floor["l2"].values()),
                     "worst_rel_elem": max(floor["max"].values())},
           "faults": faults, "control_faults": len(control_faults),
           "control_first_faults": control_faults[:3], "cpu_step_s": cpu_s}
    log(f"step check: {json.dumps(out)}")
    check(share >= 0.5, f"a residual branch's update is mostly weight "
                        f"decay (gradient share {share:.3f}): the check "
                        f"would not hold its backward")
    check(not faults, f"the card's float32 step disagrees with the CPU's: "
                      f"{faults[:5]}")
    check(bool(control_faults),
          "the step check passed with two images' factors swapped")
    return out


def write_detection_shards(root: str, n_train: int, n_val: int, size: int
                           ) -> None:
    """Seeded raw-payload detection shards (the reference's raw store)
    at ``size``²: synthetic scenes of 1-3 coloured boxes from 80
    classes, so un-cropped reads need no resize and cropped reads take
    the torch resize."""
    from deep_vision_tpu_torch.data.detection import (
        synthetic_detection_dataset,
    )
    from deep_vision_tpu_torch.data.records import (
        RecordWriter,
        encode_detection_sample,
        shard_name,
    )

    for split, n, shards in (("train", n_train, 3), ("val", n_val, 1)):
        for i in range(shards):
            scenes = synthetic_detection_dataset(
                n // shards, size, YOLO_CLASSES,
                seed=17 + i + (100 if split == "val" else 0))
            with RecordWriter(shard_name(root, split, i, shards)) as w:
                for scene in scenes:
                    w.write(*encode_detection_sample(
                        scene, store="raw", resize=size))


def write_pose_shards(root: str, n_train: int, n_val: int, size: int
                      ) -> None:
    """Seeded raw-payload pose shards (the reference's raw store) stored
    at ``size``²: synthetic poses of 16 keypoints, bright dots on dark
    noise; the loader crops around the keypoints and resizes."""
    from deep_vision_tpu_torch.data.pose import synthetic_pose_dataset
    from deep_vision_tpu_torch.data.records import (
        RecordWriter,
        encode_pose_sample,
        shard_name,
    )

    for split, n, shards in (("train", n_train, 3), ("val", n_val, 1)):
        for i in range(shards):
            poses = synthetic_pose_dataset(
                n // shards, size, 16,
                seed=31 + i + (100 if split == "val" else 0))
            with RecordWriter(shard_name(root, split, i, shards)) as w:
                for pose in poses:
                    w.write(*encode_pose_sample(pose, store="raw",
                                                   resize=size))


def read_series(workdir: str) -> dict[str, list]:
    series: dict[str, list] = {}
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            series.setdefault(d["name"], []).append((d["step"], d["value"]))
    return series


def train_and_resume(name: str, data: str, work: str, workers: int,
                     steps: int, counter=None, extra=(),
                     epochs: tuple = (EPOCHS, RESUME_EPOCHS)) -> dict:
    """``cli.train.main`` for ``name`` on the card over the records in
    ``data``: ``epochs[0]`` epochs (default ``EPOCHS``), then ``--resume
    --epochs epochs[1]`` (``RESUME_EPOCHS``).  Checks a checkpoint per epoch, that the resumed
    run starts from the last one with its weights, BN statistics and
    Adam state (one digest over all of them), every logged loss finite
    and no bad step (an optimizer without a count, SGD or RMSprop, is
    held by the digest alone).  ``counter`` reads a kernel's launch
    count, set to 0 just before the first run.  Returns the numbers and the metric
    series."""
    import torch

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.trainer import Trainer

    first_epochs, last_epochs = epochs
    argv = ["-m", name, "--data-root", data, "--workdir", work,
            "--num-workers", str(workers), "--device", "cuda", *extra]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    check(cli.main(argv + ["--epochs", str(first_epochs)]) == 0,
          f"cli.train -m {name} failed")
    first_s = time.monotonic() - t0
    first = counter() if counter else None
    ckpts = Checkpointer(os.path.join(work, "checkpoints"))
    check(ckpts.all_steps() == [steps * e for e in range(1, first_epochs + 1)],
          f"{name}: checkpoints {ckpts.all_steps()}, not one per epoch")
    saved = ckpts.load(first_epochs * steps)["state"]
    want_digest = state_digest(saved["model"], saved["optimizer"])
    resumed = {}
    original = Trainer.maybe_resume

    def spy(self, state):
        state = original(self, state)
        resumed.update(
            step=state.step, epoch=self.start_epoch,
            count=int(getattr(state.opt, "count", first_epochs * steps)),
            digest=state_digest(state.model.state_dict(),
                                state.opt.state_dict()))
        return state

    Trainer.maybe_resume = spy
    try:
        t0 = time.monotonic()
        check(cli.main(argv + ["--resume", "--epochs",
                               str(last_epochs)]) == 0,
              f"cli.train -m {name} --resume failed")
        resume_s = time.monotonic() - t0
    finally:
        Trainer.maybe_resume = original
    check(resumed == {"step": first_epochs * steps, "epoch": first_epochs + 1,
                      "count": first_epochs * steps, "digest": want_digest},
          f"{name}: resume restored {resumed}, not step {first_epochs * steps} "
          f"epoch {first_epochs + 1} digest {want_digest}")
    check(ckpts.all_steps() == [steps * e
                                for e in range(1, last_epochs + 1)],
          f"{name}: checkpoints after resume: {ckpts.all_steps()}")
    series = read_series(work)
    losses = series.get("train_loss", [])
    check(bool(losses), f"{name}: no train loss was logged")
    check(all(math.isfinite(v) for _, v in losses),
          f"{name}: non-finite train loss: {losses}")
    check(all(v == 0 for _, v in series["train_bad_steps"]),
          f"{name}: bad steps: {series['train_bad_steps']}")
    step_ms = [v for _, v in series["train_step_ms"]]
    out = {"train_steps": last_epochs * steps,
           "first_run_s": first_s, "resumed_run_s": resume_s,
           "step_ms_by_epoch": step_ms,
           "img_per_s_by_epoch": [v for _, v in series["images_per_sec"]],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses,
           "input_stall_frac": [v for _, v in
                                series.get("input_stall_frac", [])],
           "checkpoints": ckpts.all_steps(), "resumed": resumed}
    if counter:
        out.update(first_launches=first, launches=counter())
    return out, series


def phase_yolo_training(keep: str | None = None) -> dict:
    """cli.train end to end for yolov3_coco at full width on the card;
    with ``keep`` its records and workdir stay under that directory (for
    ``phase_cli_tools``'s ``cli.infer eval``)."""
    from deep_vision_tpu_torch.ops.best_iou import best_iou_max

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with (contextlib.nullcontext(keep) if keep else tempfile.
          TemporaryDirectory(dir=os.path.join(REPO, "_scratch"))) as tmp:
        data, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        t0 = time.monotonic()
        write_detection_shards(data, YOLO_TRAIN, YOLO_VAL, YOLO_SIZE)
        log(f"yolo training: wrote {YOLO_TRAIN}+{YOLO_VAL} raw detection "
            f"records in {time.monotonic() - t0:.1f} s")
        steps = YOLO_TRAIN // YOLO_BATCH
        evals = -(-YOLO_VAL // YOLO_BATCH)  # val batches per evaluation
        first_epochs, last_epochs = DETECT_EPOCHS
        best_iou_max.launches = 0
        out, series = train_and_resume(
            "yolov3_coco", data, work, YOLO_WORKERS, steps,
            lambda: best_iou_max.launches, epochs=DETECT_EPOCHS)
        # every epoch evaluates once, and cli.train once more at the end
        first, launches = out.pop("first_launches"), out.pop("launches")
        want = 3 * (first_epochs * steps + (first_epochs + 1) * evals)
        check(first == want, f"best_iou_max launched {first} times, not "
                             f"3 x ({first_epochs * steps} train steps + "
                             f"{(first_epochs + 1) * evals} eval batches)")
        more = last_epochs - first_epochs
        check(launches - first == 3 * (more * steps + (more + 1) * evals),
              f"the resumed run launched best_iou_max {launches - first} "
              f"times")
        ignored = [[v for _, v in series[f"train_ignored_{s}"]]
                   for s in range(3)]
        check(any(sum(col) > 0 for col in zip(*ignored)),
              f"the ignore mask hid no prediction in any logged step: "
              f"{ignored}")
        maps = [v for _, v in series["val_mAP"]]
        check(all(math.isfinite(v) for v in maps), f"val mAP {maps}")
        out.update(best_iou_max_launches=launches,
                   eval_batches=(last_epochs + 2) * evals,
                   ignored_share_by_scale=ignored, val_mAP=maps)
        log(f"yolo training: {json.dumps(out)}")
    return out


def phase_heatmap_training(name: str, keep: str | None = None) -> dict:
    """cli.train end to end for ``centernet`` or ``hourglass104`` at full
    width on the card (256², batch 32, bf16, Adam): seeded raw records
    stored at 256², loader workers, DETECT_EPOCHS: an epoch and a resumed
    one.  No hand-written kernel runs on these paths.  With ``keep`` the
    records and workdir stay under that directory (the pipeline phase
    trains on the same records)."""
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with (contextlib.nullcontext(keep) if keep else tempfile.
          TemporaryDirectory(dir=os.path.join(REPO, "_scratch"))) as tmp:
        data, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        t0 = time.monotonic()
        write = write_pose_shards if name == POSE_MODEL \
            else write_detection_shards
        write(data, HEAT_TRAIN, HEAT_VAL, HEAT_SIZE)
        log(f"{name} training: wrote {HEAT_TRAIN}+{HEAT_VAL} raw records "
            f"in {time.monotonic() - t0:.1f} s")
        out, series = train_and_resume(name, data, work, HEAT_WORKERS,
                                       HEAT_TRAIN // HEAT_BATCH,
                                       epochs=DETECT_EPOCHS)
        evals = {k: [v for _, v in series[f"val_{k}"]]
                 for k in ("loss", "mAP") if f"val_{k}" in series}
        check(all(math.isfinite(v) for vs in evals.values() for v in vs),
              f"{name}: val metrics {evals}")
        out["val"] = evals
        log(f"{name} training: {json.dumps(out)}")
    return out


def heatmap_batch(name: str, n: int, seed: int) -> dict:
    """``n`` seeded synthetic scenes (CenterNet) or poses (hourglass) at
    HEAT_CHECK_SIZE², un-augmented, with their encoded labels."""
    from deep_vision_tpu_torch.core.config import get_config

    cfg = get_config(name)
    size = HEAT_CHECK_SIZE
    if name == POSE_MODEL:
        from deep_vision_tpu_torch.data.pose import (
            PoseLoader,
            synthetic_pose_dataset,
        )

        loader = PoseLoader(synthetic_pose_dataset(n, size, 16, seed=seed),
                            n, size, size // 4, 16, train=False,
                            device_normalize=True)
    else:
        from deep_vision_tpu_torch.data.detection import (
            CenterNetLoader,
            synthetic_detection_dataset,
        )

        loader = CenterNetLoader(
            synthetic_detection_dataset(n, size, cfg.num_classes, seed=seed),
            n, cfg.num_classes, size, train=False, device_normalize=True)
    batch = next(iter(loader))
    batch.pop("weight")
    return batch


def heatmap_step(name: str, device: str, model_sd: dict, batch: dict
                 ) -> dict:
    """One float32 forward + backward (train mode) of config ``name``'s
    model on ``device``: the loss, its components and the gradients, on
    the CPU, but those of the biases whose gradient is rounding noise
    (``BN_FED_BIAS`` says which)."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import to_device
    from deep_vision_tpu_torch.models.common import Conv2d
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu_torch.tasks.centernet import CenterNetTask
    from deep_vision_tpu_torch.tasks.pose import PoseTask

    cfg = get_config(name)
    model = cfg.model().set_compute_dtype(torch.float32)
    model.load_state_dict(model_sd)
    model.to(device).train()
    if device == "cuda":
        model.to(memory_format=torch.channels_last)
    task = PoseTask() if cfg.task == "pose" else \
        CenterNetTask(cfg.num_classes)
    b = make_scale_preprocess()(to_device(batch, torch.device(device)),
                                None, True)
    loss, comps = task.loss(model(b["image"]), b)
    loss.backward()
    noise = {f"{n}.bias" for n, m in model.named_modules()
             if isinstance(m, Conv2d) and (
                 BN_FED_BIAS.search(f"{n}.bias") or
                 (cfg.task == "pose" and not n.endswith(".heat")))}
    return {"loss": float(loss.detach()),
            "comps": {k: float(v.detach()) for k, v in comps.items()},
            "grads": {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()
                      if n not in noise}}


def phase_heatmap_step_check(name: str) -> dict:
    """float32 step of full-width ``centernet`` or ``hourglass104`` at
    HEAT_CHECK_SIZE² on the card against the same step on the CPU.  At
    batch 8 every training BatchNorm normalizes over at least 8 values
    (CenterNet's order-5 hourglass reaches 1×1 at 128²): at batch 2 a
    1e-7 relative move of the weights moved CenterNet's gradients on the
    CPU by 1,285% in L2, at batch 8 by 0.16%."""
    import torch

    model = seeded_model(name, 11)
    sd = model.state_dict()
    batch = heatmap_batch(name, HEAT_CHECK_BATCH, seed=23)
    # the control: each image's labels on the next image
    rolled = {k: v if k == "image" else np.roll(v, 1, 0)
              for k, v in batch.items()}
    gen = torch.Generator().manual_seed(9)
    moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             if v.is_floating_point() else v for k, v in sd.items()}
    t0 = time.monotonic()
    cpu = heatmap_step(name, "cpu", sd, batch)
    cpu_s = time.monotonic() - t0
    moved_step = heatmap_step(name, "cpu", moved, batch)
    floor = grad_errors(moved_step["grads"], cpu["grads"])
    gpu = heatmap_step(name, "cuda", sd, batch)
    control = heatmap_step(name, "cuda", sd, rolled)
    # a gradient in every conv: every residual branch, every stack's
    # re-injection convs and every head
    dead = sorted(k for k, g in cpu["grads"].items()
                  if k.endswith("weight") and not float(g.norm()) > 0)
    reinject = [k for k in cpu["grads"] if "reinject" in k]
    bounds = {"total": max(1e-3, 10 * floor["total"]),
              "tensor": max(5e-2, 10 * max(floor["per"].values()))}
    faults = step_faults(gpu, cpu, bounds)
    control_faults = step_faults(control, cpu, bounds)
    errs = grad_errors(gpu["grads"], cpu["grads"])
    out = {"loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
           "comps_rel_err": comps_rel_err(gpu, cpu),
           "grad_l2_err": errs["total"],
           "worst_tensor_grad_l2_err": max(errs["per"].values()),
           "floor": {"comps_rel": comps_rel_err(moved_step, cpu),
                     "grad_l2": floor["total"],
                     "worst_tensor_grad_l2": max(floor["per"].values())},
           "bounds": bounds, "faults": faults,
           "reinject_tensors": len(reinject), "zero_grad_weights": dead,
           "control_loss_cuda": control["loss"],
           "control_faults": len(control_faults),
           "control_first_faults": control_faults[:3], "cpu_step_s": cpu_s}
    log(f"{name} step check: {json.dumps(out)}")
    check(not dead, f"{name}: no gradient reached {dead[:5]}")
    check(len(reinject) > 0, f"{name}: no re-injection conv in the model")
    check(not faults, f"{name}: the card's float32 step disagrees with the "
                      f"CPU's: {faults[:5]}")
    check(any(f.startswith(("loss", "heat", "mse")) for f in control_faults),
          f"{name}: the loss bound held with each image's labels on the "
          f"next image")
    return out


def yolo_step(device: str, model_sd: dict, batch: dict) -> dict:
    """One float32 forward + backward of full-width YOLOv3 (train mode)
    on ``device``: the loss, its components, each scale's ignore mask
    and the gradients, all on the CPU."""
    import torch

    from deep_vision_tpu_torch.core.trainer import to_device
    from deep_vision_tpu_torch.models.yolo import (
        ANCHOR_MASKS,
        YOLO_ANCHORS,
        YoloV3,
    )
    from deep_vision_tpu_torch.ops.best_iou import best_iou_max
    from deep_vision_tpu_torch.ops.boxes import xywh_to_corners
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu_torch.tasks.detection import YoloTask, decode_boxes

    model = YoloV3(YOLO_CLASSES, torch.float32)
    model.load_state_dict(model_sd)
    model.to(device).train()
    if device == "cuda":
        model.to(memory_format=torch.channels_last)
    task = YoloTask(YOLO_CLASSES)
    b = make_scale_preprocess()(to_device(batch, torch.device(device)),
                                None, True)
    outs = model(b["image"])
    loss, comps = task.loss(outs, b)
    loss.backward()
    with torch.no_grad():
        ignore = []
        for s, raw in enumerate(outs):
            anchors = torch.from_numpy(YOLO_ANCHORS[ANCHOR_MASKS[s]])
            corners = xywh_to_corners(decode_boxes(
                raw, anchors.to(raw.device))[0])
            best = best_iou_max(corners.reshape(len(raw), -1, 4).contiguous(),
                                b["boxes"], b["boxes_mask"])
            ignore.append((best < 0.5).cpu())
    return {"loss": float(loss.detach()),
            "comps": {k: float(v.detach()) for k, v in comps.items()},
            "ignore": ignore,
            "grads": {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()}}


def grad_errors(got: dict, want: dict) -> dict:
    """‖g − w‖ / ‖w‖ over all gradients (``total``) and per tensor."""
    per = {k: float((got[k] - w).norm() / max(float(w.norm()), 1e-30))
           for k, w in want.items()}
    num = sum(float((got[k] - w).norm()) ** 2 for k, w in want.items())
    den = sum(float(w.norm()) ** 2 for w in want.values())
    return {"total": (num / max(den, 1e-30)) ** 0.5, "per": per}


def comps_rel_err(got: dict, want: dict) -> float:
    """The worst per-scale loss component's relative error."""
    return max(abs(got["comps"][k] - v) / max(abs(v), 1e-2)
               for k, v in want["comps"].items()
               if not k.startswith("ignored"))


def step_faults(got: dict, want: dict, bounds: dict) -> list[str]:
    """The loss and each per-scale component beyond 1e-4 relative, the
    gradients beyond ``bounds`` (total and per tensor, in L2)."""
    faults = []
    if abs(got["loss"] - want["loss"]) > 1e-4 * abs(want["loss"]):
        faults.append(f"loss {got['loss']} vs {want['loss']}")
    for k, v in want["comps"].items():
        if k.startswith("ignored"):
            continue
        if abs(got["comps"][k] - v) > 1e-4 * max(abs(v), 1e-2):
            faults.append(f"{k} {got['comps'][k]} vs {v}")
    errs = grad_errors(got["grads"], want["grads"])
    if errs["total"] > bounds["total"]:
        faults.append(f"gradients {errs['total']:.3e} in L2")
    faults += [f"{k}: {e:.3e} in L2" for k, e in errs["per"].items()
               if e > bounds["tensor"]]
    return faults


def overlapping_batch(model, n: int, seed: int) -> dict:
    """``n`` seeded noise images at YOLO_CHECK_SIZE² with ground truths
    cut from ``model``'s own decoded predictions (train-mode forward on
    the CPU; weights and statistics restored after), 4 a scale, sides
    jittered by up to 5%: some predictions overlap a ground truth past
    the 0.5 ignore threshold by construction, most do not."""
    import torch

    from deep_vision_tpu_torch.models.yolo import ANCHOR_MASKS, YOLO_ANCHORS
    from deep_vision_tpu_torch.tasks.detection import (
        decode_boxes,
        encode_labels,
    )

    rng = np.random.default_rng(seed)
    size = YOLO_CHECK_SIZE
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        outs = model.train()(torch.from_numpy(images).float() / 255.0)
    model.load_state_dict(saved)
    items = []
    for i in range(n):
        boxes = []
        for s, raw in enumerate(outs):
            anchors = torch.from_numpy(YOLO_ANCHORS[ANCHOR_MASKS[s]])
            xywh = decode_boxes(raw[i:i + 1], anchors)[0].reshape(-1, 4)
            pick = rng.choice(len(xywh), 4, replace=False)
            boxes.append(xywh[pick].numpy()
                         * rng.uniform(0.95, 1.05, (4, 4)))
        xywh = np.concatenate(boxes).astype(np.float32)
        xywh[:, :2] = np.clip(xywh[:, :2], 0.01, 0.99)
        items.append(encode_labels(
            xywh, rng.integers(0, YOLO_CLASSES, len(xywh)), YOLO_CLASSES,
            grids=(size // 8, size // 16, size // 32)))
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    batch["image"] = images
    return batch


def phase_yolo_step_check() -> dict:
    """float32 YOLOv3 step on the card (kernel) vs on the CPU (plain)."""
    import torch

    from deep_vision_tpu_torch.models.yolo import YoloV3

    model = YoloV3(YOLO_CLASSES).reset_parameters(
        torch.Generator().manual_seed(7))
    sd = model.state_dict()
    batch = overlapping_batch(model, 2, seed=21)
    rolled = dict(batch, boxes=np.roll(batch["boxes"], 1, 0),
                  boxes_mask=np.roll(batch["boxes_mask"], 1, 0))
    gen = torch.Generator().manual_seed(9)
    moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             if v.is_floating_point() else v for k, v in sd.items()}
    t0 = time.monotonic()
    cpu = yolo_step("cpu", sd, batch)
    cpu_s = time.monotonic() - t0
    moved_step = yolo_step("cpu", moved, batch)
    floor = grad_errors(moved_step["grads"], cpu["grads"])
    gpu = yolo_step("cuda", sd, batch)
    control = yolo_step("cuda", sd, rolled)
    # bounds from the CPU's own rounding floor: ten times the change a
    # 1e-7 move of the weights makes, and never tighter than 1e-3 over
    # the model or 5e-2 per tensor
    bounds = {"total": max(1e-3, 10 * floor["total"]),
              "tensor": max(5e-2, 10 * max(floor["per"].values()))}
    faults = step_faults(gpu, cpu, bounds)
    control_faults = step_faults(control, cpu, bounds)
    errs = grad_errors(gpu["grads"], cpu["grads"])
    flips = [int((g != c).sum()) for g, c in zip(gpu["ignore"],
                                                  cpu["ignore"])]
    ignored = [int((~c).sum()) for c in cpu["ignore"]]
    out = {"loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
           "comps_rel_err": comps_rel_err(gpu, cpu),
           "ignored_predictions_by_scale": ignored,
           "ignore_flips_by_scale": flips,
           "grad_l2_err": errs["total"],
           "worst_tensor_grad_l2_err": max(errs["per"].values()),
           "floor": {"comps_rel": comps_rel_err(moved_step, cpu),
                     "grad_l2": floor["total"],
                     "worst_tensor_grad_l2": max(floor["per"].values())},
           "bounds": bounds, "faults": faults,
           "control_loss_cuda": control["loss"],
           "control_faults": len(control_faults),
           "control_first_faults": control_faults[:3], "cpu_step_s": cpu_s}
    log(f"yolo step check: {json.dumps(out)}")
    check(sum(ignored) > 0, "the ignore mask hid nothing in the step check")
    check(not faults, f"the card's float32 YOLOv3 step disagrees with the "
                      f"CPU's: {faults[:5]}")
    check(any(f.startswith(("loss", "obj")) for f in control_faults),
          "the loss bound held with each image's boxes in the next "
          "image's ignore mask")
    return out


# ---------------------------------------------------------------------------
# The classifier zoo
# ---------------------------------------------------------------------------


def phase_zoo_steps() -> dict:
    """Each zoo recipe's Trainer at its own batch and size, bf16, on a
    seeded uint8 batch on the card through train_ingest: ZOO_STEPS
    steps, finite losses, no bad step, one train_ingest launch a step.
    Step ms from CUDA events (the first step includes cuDNN's choice of
    algorithms), img/s and peak memory."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.preprocess import make_imagenet_preprocess
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    out = {}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    for i, name in enumerate(ZOO_STEP_MODELS):
        cfg = get_config(name)
        b, size = cfg.batch_size, cfg.image_size
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        batch = {"image": torch.randint(0, 256, (b, size, size, 3),
                                        dtype=torch.uint8, device="cuda",
                                        generator=gen),
                 "label": torch.randint(0, cfg.num_classes, (b,),
                                        device="cuda", generator=gen)}
        with tempfile.TemporaryDirectory(
                dir=os.path.join(REPO, "_scratch")) as work:
            t0 = time.monotonic()
            trainer = Trainer(cfg, cfg.model(), ClassificationTask(
                cfg.num_classes, cfg.label_smoothing), workdir=work,
                preprocess_fn=make_imagenet_preprocess(), device="cuda")
            state = trainer.init_state()
            state.opt.set_learning_rate(trainer.scheduler.epoch_begin(1))
            init_s = time.monotonic() - t0
            params = sum(p.numel() for p in state.model.parameters())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            train_ingest.launches = 0
            step_ms, losses = [], []
            for _ in range(ZOO_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = trainer.train_step(state, batch)
                end.record()
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(end))
                losses.append(float(m["loss"]))
            launches = train_ingest.launches
            bad = int(state.bad_steps)
            peak = torch.cuda.max_memory_allocated()
            finite = all(bool(torch.isfinite(p).all())
                         for p in state.model.parameters())
            del trainer, state, m
        torch.cuda.empty_cache()
        steady = sum(step_ms[1:]) / max(len(step_ms) - 1, 1)
        row = {"batch": b, "size": size, "params": params,
               "optimizer": cfg.optimizer.name, "step_ms": step_ms,
               "steady_step_ms": steady, "img_per_s": b * 1e3 / steady,
               "peak_memory_bytes": peak, "losses": losses,
               "bad_steps": bad, "train_ingest_launches": launches,
               "weights_finite": finite, "init_s": init_s}
        log(f"zoo step {name}: {json.dumps(row)}")
        nonfinite = sum(not math.isfinite(v) for v in losses)
        if name in ZOO_DIVERGING:
            check(math.isfinite(losses[0]) and bad >= nonfinite and finite,
                  f"{name}: the guard skipped {bad} steps for {nonfinite} "
                  f"non-finite losses {losses} (weights finite: {finite})")
        else:
            check(nonfinite == 0 and bad == 0,
                  f"{name}: losses {losses}, {bad} bad steps")
        check(launches == ZOO_STEPS, f"{name}: train_ingest launched "
                                     f"{launches} times in {ZOO_STEPS} steps")
        out[name] = row
    return out


def phase_zoo_training() -> dict:
    """cli.train for inception3 (InceptionV3, 299², bf16, batch 128,
    RMSprop) on seeded raw records stored at its resize, loader workers,
    2 epochs and a resumed third: exact resume of the weights, the BN
    statistics and RMSprop's nu and trace; one train_ingest launch a
    train step."""
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.data.transforms import imagenet_resize_for
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest

    cfg = get_config("inception3")
    stored = imagenet_resize_for(cfg.image_size)
    steps = ZOO_TRAIN // cfg.batch_size
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        data, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        t0 = time.monotonic()
        write_records(data, ZOO_TRAIN, ZOO_VAL, stored)
        log(f"inception3: wrote {ZOO_TRAIN}+{ZOO_VAL} raw records at "
            f"{stored}² in {time.monotonic() - t0:.1f} s")
        train_ingest.launches = 0
        out, series = train_and_resume(
            "inception3", data, work, ZOO_WORKERS, steps,
            lambda: train_ingest.launches,
            ("--data-format", "records"))
    check(out["first_launches"] == EPOCHS * steps
          and out["launches"] == RESUME_EPOCHS * steps,
          f"inception3: train_ingest launched {out['first_launches']} / "
          f"{out['launches']} times in {EPOCHS * steps} / "
          f"{RESUME_EPOCHS * steps} steps")
    out.update(batch=cfg.batch_size, stored=stored,
               val_loss=series["val_loss"][-1][1],
               val_top1=series["val_top1"][-1][1])
    check(math.isfinite(out["val_loss"]), "inception3: non-finite val loss")
    log(f"inception3 training: {json.dumps(out)}")
    return out


def serve_trained_workdir(name: str, work: str) -> dict:
    """``cli.serve -m name --workdir work`` (float32, uint8 wire) on the
    card over the workdir ``cli.train`` wrote: the served model holds
    the weights of the checkpoint the workdir's preference order names
    (``checkpoints_best`` first, its newest complete step) bit for bit,
    and 8 sequential then 24 concurrent /v1/classify answers equal a
    direct plain-ingest call at one of the buckets; one ``serve_ingest``
    launch a batch."""
    import torch

    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.restore import (
        CHECKPOINT_DIRS,
        checkpoint_weights,
    )
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    sub, step = next((sub, Checkpointer(os.path.join(work, sub))
                      .all_steps()[-1]) for sub in CHECKPOINT_DIRS
                     if os.path.isdir(os.path.join(work, sub)))
    want = checkpoint_weights(Checkpointer(os.path.join(work, sub))
                              .load(step))
    engine, server = boot_cli([
        "-m", name, "--workdir", work, "--wire-dtype", "uint8",
        "--infer-dtype", "float32", "--port", "0", "--device", "cuda",
        "--max-batch", str(max(BUCKETS)),
        "--buckets", ",".join(map(str, BUCKETS)), "--warmup"])
    sm = engine.model
    imgs = np.random.RandomState(5).randint(
        0, 256, (N_SEQ + N_CONC, *sm.input_shape), np.uint8)
    bodies = [json.dumps({"pixels": im.tolist(), "top_k": 5}).encode()
              for im in imgs]
    try:
        got = sm._model.state_dict()
        same = sorted(got) == sorted(want) and all(
            torch.equal(got[k].cpu(), want[k]) for k in want)
        serve_ingest.launches = 0
        replies = [post(server.port, b) for b in bodies[:N_SEQ]]
        with concurrent.futures.ThreadPoolExecutor(N_CONC) as pool:
            replies += list(pool.map(lambda b: post(server.port, b),
                                     bodies[N_SEQ:]))
        launches = serve_ingest.launches
        batches = engine.stats()["batches"]
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    check(sm.restored_step == step and same,
          f"{name} served step {sm.restored_step}, not the weights of "
          f"{sub} step {step} (equal: {same})")
    check(launches == batches > 0, f"{name} from its workdir: serve_ingest "
          f"launched {launches} times for {batches} batches")
    out = {"checkpoints": sub, "step": step, "launches": launches,
           "batches": batches}
    out.update(hold_answers(f"{name} from its cli.train workdir", sm, imgs,
                            replies, {"top_k": 5}, classify_diff,
                            control="unit"))
    log(f"{name} served from its cli.train workdir: {json.dumps(out)}")
    return out


def phase_lenet_training() -> dict:
    """cli.train for lenet5 (float32, batch 64, Adam) on seeded idx-ubyte
    files (MNIST_TRAIN train, MNIST_TEST test images of 28×28), 2 epochs
    and a resumed third: exact resume of the weights
    and Adam's moments and count; then ``cli.serve --workdir`` serves
    what it wrote."""
    from deep_vision_tpu_torch.data import mnist

    steps = MNIST_TRAIN // 64
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        data, work = os.path.join(tmp, "mnist"), os.path.join(tmp, "work")
        os.makedirs(data)
        rng = np.random.default_rng(8)
        for split, n in (("train", MNIST_TRAIN), ("test", MNIST_TEST)):
            mnist.write_idx(data, split,
                            rng.integers(0, 256, (n, 28, 28), np.uint8),
                            rng.integers(0, 10, n).astype(np.uint8))
        out, series = train_and_resume("lenet5", data, work, 0, steps)
        out["served"] = serve_trained_workdir("lenet5", work)
    out.update(val_loss=series["val_loss"][-1][1],
               val_top1=series["val_top1"][-1][1])
    check(math.isfinite(out["val_loss"]), "lenet5: non-finite val loss")
    log(f"lenet5 training: {json.dumps(out)}")
    return out


class MaskReplay:
    """Forward hooks on a model's Dropouts: the first run draws each
    mask on the CPU (in call order) and keeps it; later runs, on any
    device, apply the kept masks, copied there.  A CUDA and a CPU
    generator give different streams from one seed, so the card-vs-CPU
    step holds dropout through its masks."""

    def __init__(self, seed: int):
        import torch

        self.gen = torch.Generator().manual_seed(seed)
        self.masks: list = []
        self.calls = 0

    def attach(self, model) -> list:
        from deep_vision_tpu_torch.models.common import Dropout

        self.calls = 0
        return [m.register_forward_hook(self.hook) for m in model.modules()
                if isinstance(m, Dropout)]

    def hook(self, mod, inputs, out):
        import torch

        if not mod.training or mod.rate == 0.0:
            return out
        x = inputs[0]
        if self.calls == len(self.masks):
            self.masks.append(torch.rand(x.shape, generator=self.gen)
                              < 1.0 - mod.rate)
        keep = self.masks[self.calls].to(x.device)
        self.calls += 1
        return torch.where(keep, x / (1.0 - mod.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def zoo_step(name: str, device: str, model_sd: dict, images, labels,
             factors, masks: MaskReplay, workdir: str):
    """One float32 train step of config ``name`` at ZOO_CHECK_SIZE² on
    ``device`` with the config's optimizer (through train_ingest with
    fixed factors, the dropout masks of ``masks``): (loss, state_dict
    before, after), on the CPU."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    cfg = get_config(name)
    cfg.batch_size, cfg.image_size = ZOO_CHECK_BATCH, ZOO_CHECK_SIZE
    model = cfg.model().set_compute_dtype(torch.float32)
    model.load_state_dict(model_sd)
    f = factors.to(device)

    def preprocess(batch, generator, train):
        return {**batch, "image": train_ingest(batch["image"], f)}

    trainer = Trainer(cfg, model, ClassificationTask(1000), workdir=workdir,
                      preprocess_fn=preprocess, device=device)
    state = trainer.state_for(model)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    handles = masks.attach(model)
    try:
        state, m = trainer.train_step(state, {"image": images,
                                              "label": labels})
    finally:
        for h in handles:
            h.remove()
    after = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    check(int(m["bad_steps"]) == 0, f"{name}: the {device} step was skipped")
    return float(m["loss"]), before, after


def phase_zoo_step_check(name: str) -> dict:
    """float32 step of full-width ``mobilenet1`` (RMSprop, depthwise
    convs, BN) or ``inception1`` (SGD, LRN, two aux heads, dropout) at
    ZOO_CHECK_SIZE², batch ZOO_CHECK_BATCH, on the card (train_ingest
    kernel) against the same step on the CPU (plain version), same
    seeded weights (non-zero BN scales), factors and dropout masks
    (drawn on the CPU): the loss within 1e-4 relative, the parameters'
    update within max(1e-3, 10× the CPU's own floor) in L2, the running
    statistics' within max(1e-4, 10× floor), each tensor's within
    max(5e-2, 10× floor); the floor is the CPU's step from weights moved
    by 1e-7 (relative): at full depth MobileNet's forward drifts by
    rounding until ReLU gates flip.  Every weight's update must carry
    gradient, not weight decay alone (every branch of every Inception
    module and both aux heads); the same step with each image's label on
    the next image must fail the bounds."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest_factors

    cfg = get_config(name)
    cfg.image_size = ZOO_CHECK_SIZE
    gen = torch.Generator().manual_seed(12)
    model = cfg.model().reset_parameters(gen)
    nonzero_bn_(model, gen)
    sd = model.state_dict()
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (ZOO_CHECK_BATCH, ZOO_CHECK_SIZE,
                                   ZOO_CHECK_SIZE, 3), dtype=np.uint8)
    labels = (np.arange(ZOO_CHECK_BATCH) * 97).astype(np.int32)
    factors = train_ingest_factors(torch.from_numpy(images),
                                   torch.Generator().manual_seed(14))
    moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             if v.is_floating_point() else v for k, v in sd.items()}
    masks = MaskReplay(15)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        t0 = time.monotonic()
        cpu = zoo_step(name, "cpu", sd, images, labels, factors, masks,
                       os.path.join(tmp, "c"))
        cpu_s = time.monotonic() - t0
        floor = update_errors(zoo_step(name, "cpu", moved, images, labels,
                                       factors, masks,
                                       os.path.join(tmp, "m")), cpu)
        gpu = zoo_step(name, "cuda", sd, images, labels, factors, masks,
                       os.path.join(tmp, "g"))
        control = zoo_step(name, "cuda", sd, images, np.roll(labels, 1),
                           factors, masks, os.path.join(tmp, "r"))
    bounds = {"params": max(1e-3, 10 * floor["params"]),
              "stats": max(1e-4, 10 * floor["stats"]),
              "tensor": max(5e-2, 10 * max(floor["l2"].values()))}

    def faults_of(step):
        errs = update_errors(step, cpu)
        faults = []
        if abs(step[0] - cpu[0]) > 1e-4 * abs(cpu[0]):
            faults.append(f"loss {step[0]} vs {cpu[0]}")
        for part in ("params", "stats"):
            if errs[part] > bounds[part]:
                faults.append(f"{part} update {errs[part]:.3e} in L2")
        faults += [f"{k}: {e:.3e} in L2" for k, e in errs["l2"].items()
                   if e > bounds["tensor"]]
        return faults, errs

    faults, errs = faults_of(gpu)
    control_faults, _ = faults_of(control)
    # the share of each weight's update that is gradient, not decay
    decay = cfg.optimizer.learning_rate * cfg.optimizer.weight_decay \
        if cfg.optimizer.name == "sgd" else 0.0
    _, before, after = cpu
    shares = {k: float((after[k] - before[k] + decay * before[k]).norm()
                       / max(float((after[k] - before[k]).norm()), 1e-30))
              for k in after if k.endswith(".weight")
              and after[k].dim() > 1}
    aux = [k for k in shares if k.startswith(("aux1", "aux2"))]
    out = {"loss_cuda": gpu[0], "loss_cpu": cpu[0],
           "params_l2_update_err": errs["params"],
           "stats_l2_update_err": errs["stats"],
           "worst_tensor_l2_update_err": max(errs["l2"].values()),
           "floor": {"params_l2": floor["params"],
                     "stats_l2": floor["stats"],
                     "worst_tensor_l2": max(floor["l2"].values())},
           "bounds": bounds, "faults": faults,
           "dropout_masks": len(masks.masks),
           "min_grad_share": min(shares.values()),
           "weights_held": len(shares), "aux_weights": len(aux),
           "control_faults": len(control_faults),
           "control_first_faults": control_faults[:3], "cpu_step_s": cpu_s}
    log(f"{name} step check: {json.dumps(out)}")
    check(min(shares.values()) > 1e-2,
          f"{name}: some weight got no gradient: "
          f"{sorted(shares, key=shares.get)[:3]}")
    check(name != "inception1" or (len(aux) == 6 and len(masks.masks) == 3),
          f"{name}: the aux heads or their dropouts did not run")
    check(not faults, f"{name}: the card's float32 step disagrees with the "
                      f"CPU's: {faults[:5]}")
    check(bool(control_faults),
          f"{name}: the step check passed with the labels rolled")
    return out


def write_classifier_weights(name: str, path: str, seed: int) -> None:
    """Config ``name``'s model at the reference's init from the seed with
    non-zero BatchNorm scales and positive running variances, written in
    the reference's flax layout as a ``--weights`` npz."""
    import torch

    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.core.config import get_config

    model = get_config(name).model()
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    nonzero_bn_(model, gen)
    convert.save_npz(path, convert.classifier_to_flax(model.state_dict(),
                                                      model))


def phase_classify_serving() -> dict:
    """/v1/classify of lenet5 (float32 on the uint8 wire, "mnist") and
    inception3 (int8 on the uint8 wire, "imagenet") over HTTP on the
    card: 8 sequential and 24 concurrent requests each, every answer
    200 and equal to a direct plain-ingest call at one of the buckets
    within twice the card's own bucket-1-vs-32 spread, a control ingest
    without mean and std failing on most rows, one serve_ingest launch
    a batch formed."""
    import torch

    body = {"top_k": 5}
    out = {}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        for seed, (name, dtype, kind) in enumerate(CLASSIFY_MODELS):
            weights = os.path.join(tmp, f"{name}.npz")
            write_classifier_weights(name, weights, 20 + seed)
            sm, imgs, replies, row = serve_over_http(
                name, weights, "classify", body, infer_dtype=dtype,
                kind=kind)
            row.update(hold_answers(name, sm, imgs, replies, body,
                                    classify_diff, control="unit"))
            row.update(infer_dtype=dtype, kind=kind,
                       forward_ms_by_bucket=bucket_forward_ms(sm, BUCKETS))
            log(f"{name} classify serving: {json.dumps(row)}")
            out[name] = row
            del sm
            torch.cuda.empty_cache()
    return out


def gan_task(name: str, dtype):
    """The task of GAN config ``name`` with its networks in ``dtype``."""
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.models import gan
    from deep_vision_tpu_torch.tasks.gan import CycleGANTask, DCGANTask

    opt = get_config(name).optimizer
    if name == "dcgan":
        return DCGANTask(lambda: gan.DCGANGenerator(dtype=dtype),
                         lambda: gan.DCGANDiscriminator(dtype=dtype),
                         opt=opt)
    return CycleGANTask(lambda: gan.CycleGANGenerator(dtype=dtype),
                        lambda: gan.PatchGANDiscriminator(dtype=dtype),
                        opt=opt)


def gan_train_and_resume(name: str, work: str, extra=()) -> dict:
    """``cli.train.main`` for ``name`` on the card: EPOCHS epochs (a
    checkpoint at the last: the recipes save every 2), then ``--resume
    --epochs RESUME_EPOCHS``.  The resumed run must start from that
    checkpoint with every network's weights, BN statistics, Adam moments
    and count, and the scheduler's state; every logged loss finite, no
    bad step.  Returns the numbers."""
    import torch

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer

    steps = GAN_STEPS[name]
    argv = ["-m", name, "--workdir", work, "--device", "cuda", *extra]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    check(cli.main(argv + ["--epochs", str(EPOCHS)]) == 0,
          f"cli.train -m {name} failed")
    first_s = time.monotonic() - t0
    ckpts = Checkpointer(os.path.join(work, "checkpoints"))
    check(ckpts.all_steps() == [EPOCHS * steps],
          f"{name}: checkpoints {ckpts.all_steps()}, not one at epoch "
          f"{EPOCHS}")
    saved = ckpts.load()
    want = {"step": EPOCHS * steps, "epoch": EPOCHS + 1,
            "scheduler": saved["extras"]["scheduler"],
            "digests": {n: state_digest(s["model"], s["optimizer"])
                        for n, s in saved["states"].items()},
            "counts": {n: EPOCHS * steps for n in saved["states"]}}
    resumed = {}
    original = AdversarialTrainer.maybe_resume

    def spy(self, states):
        states = original(self, states)
        resumed.update(
            step=next(iter(states.values())).step, epoch=self.start_epoch,
            scheduler=self.scheduler.state_dict(),
            digests={n: state_digest(s.model.state_dict(),
                                     s.opt.state_dict())
                     for n, s in states.items()},
            counts={n: int(s.opt.count) for n, s in states.items()})
        return states

    AdversarialTrainer.maybe_resume = spy
    try:
        t0 = time.monotonic()
        check(cli.main(argv + ["--resume", "--epochs",
                               str(RESUME_EPOCHS)]) == 0,
              f"cli.train -m {name} --resume failed")
        resume_s = time.monotonic() - t0
    finally:
        AdversarialTrainer.maybe_resume = original
    check(resumed == want, f"{name}: resume restored {resumed}, not {want}")
    series = read_series(work)
    losses = {k: [v for _, v in series[k]] for k in series
              if k.endswith("loss") or k in ("gen_gan", "cycle", "ident",
                                             "disc_a", "disc_b")}
    check({"g_loss", "d_loss"} <= set(losses) and all(
        math.isfinite(v) for vs in losses.values() for v in vs),
          f"{name}: losses {losses}")
    check(all(v == 0 for _, v in series["bad_steps"]),
          f"{name}: bad steps: {series['bad_steps']}")
    return {"train_steps": RESUME_EPOCHS * steps, "steps_per_epoch": steps,
            "first_run_s": first_s, "resumed_run_s": resume_s,
            "step_ms_by_epoch": [v for _, v in series["train_step_ms"]],
            "img_per_s_by_epoch": [v for _, v in series["images_per_sec"]],
            "input_stall_frac": [v for _, v in
                                 series.get("input_stall_frac", [])],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "g_loss": losses["g_loss"][-3:], "d_loss": losses["d_loss"][-3:],
            "checkpoints": ckpts.all_steps(),
            "resumed": {k: resumed[k] for k in ("step", "epoch", "counts")}}


def phase_gan_training() -> dict:
    """cli.train for dcgan on seeded idx-ubyte files of MNIST's shape
    (through the staged prefetcher) and cyclegan on seeded synthetic
    domains at 256² (the pools), EPOCHS epochs and a resumed one each."""
    from deep_vision_tpu_torch.data import mnist

    out = {}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        data = os.path.join(tmp, "mnist")
        os.makedirs(data)
        rng = np.random.default_rng(30)
        mnist.write_idx(data, "train",
                        rng.integers(0, 256, (DCGAN_TRAIN, 28, 28), np.uint8),
                        rng.integers(0, 10, DCGAN_TRAIN).astype(np.uint8))
        out["dcgan"] = gan_train_and_resume(
            "dcgan", os.path.join(tmp, "dcgan"), ["--data-root", data])
        check(bool(out["dcgan"]["input_stall_frac"]),
              "dcgan: no input block: the prefetcher did not run")
        out["cyclegan"] = gan_train_and_resume(
            "cyclegan", os.path.join(tmp, "cyclegan"),
            ["--synthetic", "--synthetic-size", str(GAN_SYNTHETIC)])
    for name, row in out.items():
        log(f"{name} training: {json.dumps(row)}")
    return out


def gan_seeded_models(name: str, seed: int, dtype) -> dict:
    """Config ``name``'s networks at flax's init from the seed with
    NON-ZERO, non-unit BatchNorm scales and positive running variances
    (``nonzero_bn_``), on the CPU."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    models = gan_task(name, dtype).init_models(gen)
    for m in models.values():
        nonzero_bn_(m, gen)
    return models


def gan_step(name: str, device: str, sds: dict, batch: dict,
             draws: dict | None) -> dict:
    """One float32 adversarial step of ``name`` on ``device`` from the
    networks' state_dicts ``sds``: the losses, every network's
    state_dict before and after, and its gradients, all on the CPU."""
    import torch

    from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.ops.preprocess import make_gan_preprocess

    cfg = get_config(name)
    task = gan_task(name, torch.float32)
    models = task.init_models(torch.Generator().manual_seed(0))
    for n, m in models.items():
        m.load_state_dict(sds[n])
    grads = {}
    step_fn = task.train_step

    def spy(states, b, d):
        g, outputs, metrics = step_fn(states, b, d)
        grads.update({n: {k: t.detach().cpu().clone() for (k, _), t in
                          zip(states[n].model.named_parameters(), g[n])}
                      for n in g})
        return g, outputs, metrics

    task.train_step = spy
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        trainer = AdversarialTrainer(cfg, task, workdir=tmp,
                                     preprocess_fn=make_gan_preprocess(),
                                     device=device)
        states = trainer.states_for(models)
        before = {f"{n}/{k}": v.detach().cpu().clone()
                  for n, st in states.items()
                  for k, v in st.model.state_dict().items()}
        dev = torch.device(device)
        d = None if draws is None else {
            k: v.to(dev) if isinstance(v, torch.Tensor)
            else [m.to(dev) for m in v] for k, v in draws.items()}
        _, m = trainer.train_step(states, batch, draws=d)
        after = {f"{n}/{k}": v.detach().cpu().clone()
                 for n, st in states.items()
                 for k, v in st.model.state_dict().items()}
    check(int(m["bad_steps"]) == 0, f"{name}: the {device} step was skipped")
    return {"losses": {k: float(v) for k, v in m.items()
                       if k != "bad_steps"},
            "before": before, "after": after,
            "grads": {f"{n}/{k}": g for n, gs in grads.items()
                      for k, g in gs.items()}}


def gan_check_batch(name: str):
    """(batch, draws, control batch, control draws) of the step check:
    DCGAN's seeded uint8 images with z and masks drawn on the CPU (the
    control rolls z by one image); CycleGAN's synthetic domains at
    CYCLE_CHECK_SIZE² with seeded pooled fakes and ``pool_valid`` 1 (the
    control swaps the A and B domains)."""
    import torch

    from deep_vision_tpu_torch.data.gan import synthetic_unpaired

    rng = np.random.default_rng(31)
    if name == "dcgan":
        batch = {"image": rng.integers(0, 256, (DCGAN_CHECK_BATCH, 28, 28,
                                                1), dtype=np.uint8)}
        draws = gan_task(name, torch.float32).draw(
            DCGAN_CHECK_BATCH, torch.Generator().manual_seed(32), "cpu")
        rolled = dict(draws, z=torch.roll(draws["z"], 1, 0))
        return batch, draws, batch, rolled
    a, b = synthetic_unpaired(2, CYCLE_CHECK_SIZE, seed=33,
                              device_normalize=True)
    pa, pb = synthetic_unpaired(1, CYCLE_CHECK_SIZE, seed=34)
    batch = {"image_a": a[:1], "image_b": b[:1], "pool_a2b": pb,
             "pool_b2a": pa, "pool_valid": np.ones((), np.float32)}
    swapped = dict(batch, image_a=b[:1], image_b=a[:1])
    return batch, None, swapped, None


def adam_flip_share(step: dict, ref: dict, lr: float) -> float:
    """The share of the parameter elements that ``ref``'s update moves
    by at least lr/2 whose update in ``step`` is more than lr/100 off:
    Adam's first update is about lr·sign(g), so such an element is one
    whose gradient took the other sign."""
    off = held = 0
    for k, a in ref["after"].items():
        if k.endswith(("running_mean", "running_var",
                       "num_batches_tracked")):
            continue
        moved = (a - ref["before"][k]).abs() >= lr / 2
        held += int(moved.sum())
        off += int(((step["after"][k] - a).abs() > lr / 100)
                   .logical_and(moved).sum())
    return off / max(held, 1)


def phase_gan_step_check(name: str) -> dict:
    """One float32 step of full-width ``dcgan`` (batch 64) or
    ``cyclegan`` (9 blocks, 128², batch 1, pooled fakes) on the card
    against the same step on the CPU, from the same seeded networks
    (non-zero BN scales) and, for DCGAN, the same z and dropout masks
    drawn on the CPU: every loss within 1e-4 relative, the gradients
    within max(1e-3, 10× the CPU's own floor) in L2 over all networks
    (each tensor's within max(5e-2, 10× floor)), the BN statistics'
    updates within max(1e-4, 10× floor); the floor is the CPU's step
    from weights moved by 1e-7 (relative).  The recipes' Adam makes a
    first update of about lr·sign(g), so its update in L2 is printed and
    held by the share of the elements it moves by at least lr/2 that
    land more than lr/100 off (a gradient of the other sign): at most
    1%.  (On the card the DCGAN gradients came 3.4e-4 apart in L2 against
    a CPU floor of 4.5e-7, as one leaky-ReLU input within rounding of 0
    taking the other side moves them on the CPU, and Adam's update
    2.5e-2 against a floor of 1.1e-4.)  Every parameter must get a gradient (no GAN conv that
    feeds a BatchNorm has a bias, so none is zero in exact arithmetic).
    The control (rolled z; swapped domains) must fail."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config

    lr = get_config(name).optimizer.learning_rate
    models = gan_seeded_models(name, 35, torch.float32)
    sds = {n: m.state_dict() for n, m in models.items()}
    gen = torch.Generator().manual_seed(36)
    moved = {n: {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                 if v.is_floating_point() else v for k, v in sd.items()}
             for n, sd in sds.items()}
    batch, draws, cbatch, cdraws = gan_check_batch(name)
    t0 = time.monotonic()
    cpu = gan_step(name, "cpu", sds, batch, draws)
    cpu_s = time.monotonic() - t0
    moved_step = gan_step(name, "cpu", moved, batch, draws)
    gpu = gan_step(name, "cuda", sds, batch, draws)
    control = gan_step(name, "cuda", sds, cbatch, cdraws)

    def errs_of(step):
        return (update_errors((0, step["before"], step["after"]),
                              (0, cpu["before"], cpu["after"])),
                grad_errors(step["grads"], cpu["grads"]))

    floor_u, floor_g = errs_of(moved_step)
    bounds = {"grads": max(1e-3, 10 * floor_g["total"]),
              "tensor": max(5e-2, 10 * max(floor_g["per"].values())),
              "stats": max(1e-4, 10 * floor_u["stats"]),
              "adam_flip_share": 1e-2}

    def faults_of(step):
        faults = [f"{k} {v} vs {cpu['losses'][k]}"
                  for k, v in step["losses"].items()
                  if abs(v - cpu["losses"][k])
                  > 1e-4 * abs(cpu["losses"][k])]
        upd, grd = errs_of(step)
        if grd["total"] > bounds["grads"]:
            faults.append(f"gradients {grd['total']:.3e} in L2")
        faults += [f"{k}: gradient {e:.3e} in L2"
                   for k, e in grd["per"].items() if e > bounds["tensor"]]
        if upd["stats"] > bounds["stats"]:
            faults.append(f"stats update {upd['stats']:.3e} in L2")
        flips = adam_flip_share(step, cpu, lr)
        if flips > bounds["adam_flip_share"]:
            faults.append(f"Adam update of the other sign on {flips:.2%}")
        return faults, upd, grd, flips

    faults, upd, grd, flips = faults_of(gpu)
    control_faults, _, _, _ = faults_of(control)
    dead = sorted(k for k, g in cpu["grads"].items()
                  if not float(g.norm()) > 0)
    out = {"losses_cuda": gpu["losses"], "losses_cpu": cpu["losses"],
           "grad_l2_err": grd["total"],
           "worst_grad_tensors": dict(sorted(
               grd["per"].items(), key=lambda kv: -kv[1])[:4]),
           "stats_l2_update_err": upd["stats"],
           "params_l2_update_err": upd["params"],
           "worst_tensor_l2_update_err": max(upd["l2"].values()),
           "adam_flip_share": flips,
           "floor": {"grad_l2": floor_g["total"],
                     "worst_tensor_grad_l2": max(floor_g["per"].values()),
                     "stats_l2": floor_u["stats"],
                     "params_l2": floor_u["params"],
                     "adam_flip_share": adam_flip_share(moved_step, cpu,
                                                        lr)},
           "bounds": bounds, "faults": faults,
           "params_held": len(cpu["grads"]), "zero_grad_params": dead,
           "control_faults": len(control_faults),
           "control_first_faults": control_faults[:3], "cpu_step_s": cpu_s}
    log(f"{name} step check: {json.dumps(out)}")
    check(not dead, f"{name}: no gradient reached {dead[:5]}")
    check(not faults, f"{name}: the card's float32 step disagrees with the "
                      f"CPU's: {faults[:5]}")
    check(any(" vs " in f for f in control_faults),
          f"{name}: the loss bound held under the control")
    return out


def write_gan_weights(name: str, path: str, seed: int) -> None:
    """Config ``name``'s generator (bf16 compute, float32 weights) at
    flax's init from the seed with non-zero BN scales, written in the
    reference's flax layout as a ``--weights`` npz."""
    import torch

    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.core.config import get_config

    model = get_config(name).model()
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    nonzero_bn_(model, gen)
    convert.save_npz(path, convert.gan_to_flax(model.state_dict(), model))


def generate_rows(sm, inputs: np.ndarray, bucket: int,
                  kind: str | None = None) -> list:
    """The served generator called directly in batches of ``bucket``
    (zero padded): the PLAIN prologue of ``kind`` (by default the
    model's own "gan"; none on a float32 wire), the same forward and the
    same uint8 epilogue; one uint8 image per input."""
    import torch

    from deep_vision_tpu_torch.ops.preprocess import (
        quantize_activations,
        serve_normalize,
    )

    kind = kind or sm.preprocess_kind
    post = sm.workload.make_epilogue(sm)
    rows = []
    for i in range(0, len(inputs), bucket):
        chunk = inputs[i:i + bucket]
        batch = np.zeros((bucket, *sm.input_shape), sm.wire_dtype)
        batch[:len(chunk)] = chunk
        x = torch.from_numpy(batch).to(sm.device)
        with torch.inference_mode():
            if sm.wire_dtype == np.uint8:
                x = serve_normalize(x, kind)
            if sm.infer_dtype == "int8":
                s = float(sm.quant.act_scale)
                x = quantize_activations(x, s).to(torch.float32) * s
            out = post(sm._model(x).to(torch.float32)).cpu().numpy()
        rows += [out[j] for j in range(len(chunk))]
    return rows


def reply_image(reply: dict) -> np.ndarray:
    import base64

    img = reply["image"]
    return np.frombuffer(base64.b64decode(img["b64"]), img["dtype"]) \
        .reshape(img["shape"])


def code_diff(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def hold_images(replies, refs: dict, bound: int) -> list[str]:
    """Each reply's image against the direct images of its input at
    every bucket: within ``bound`` codes of one of them."""
    faults = []
    for i, (status, got, _) in enumerate(replies):
        if status != 200:
            faults.append(f"request {i}: HTTP {status}")
            continue
        img = reply_image(got)
        if min(code_diff(img, rows[i]) for rows in refs.values()) > bound:
            faults.append(f"request {i}: no bucket's direct image is "
                          f"within {bound} codes")
    return faults


def generate_bucket_ms(sm, iters: int = 10) -> dict:
    """Per bucket: the eager forward (prologue + generator + float32
    out) and, apart, the uint8 epilogue, from CUDA events on seeded
    input of the model's wire dtype on the card."""
    import torch

    post = sm.workload.make_epilogue(sm)
    gen = torch.Generator(device=sm.device).manual_seed(0)
    out = {}
    for b in BUCKETS:
        fn = sm.compile_bucket(b, epilogue=False)
        shape = (b, *sm.input_shape)
        x = torch.randn(shape, generator=gen, device=sm.device) \
            if sm.wire_dtype != np.uint8 else torch.randint(
                0, 256, shape, generator=gen, device=sm.device,
                dtype=torch.uint8)
        img = fn(x)
        with torch.inference_mode():
            out[str(b)] = {"forward_ms": call_ms(fn, [x], iters=iters,
                                                 warmup=2),
                           "epilogue_ms": call_ms(post, [img], iters=iters,
                                                  warmup=2)}
    return out


def serve_generate(name: str, wire: str, infer_dtype: str,
                   weights: str) -> dict:
    """``/v1/generate`` of ``name`` over HTTP on the card (buckets 1–32,
    warmed up): 8 sequential then 24 concurrent requests (DCGAN:
    ``{"seed"}``; CycleGAN: seeded synthetic domain-A images as
    ``pixels``) with ``serve_ingest``'s count set to 0 just before and
    read just after, which must stay 0; the first request again, which
    must answer the same bytes; every other verb, which must answer 400
    naming ``/v1/generate``.  Every answer must be 200 and within twice
    the card's own bucket-1-vs-32 spread (in codes) of a direct call at
    one of the buckets; for CycleGAN an "imagenet" prologue must fail
    on most rows.  D2H must be exactly one uint8 image a padded image."""
    from deep_vision_tpu_torch.cli import serve as cli
    from deep_vision_tpu_torch.data.gan import synthetic_unpaired
    from deep_vision_tpu_torch.ops.ingest import serve_ingest
    from deep_vision_tpu_torch.serve.workloads import WORKLOADS

    argv = ["-m", name, "--weights", weights, "--wire-dtype", wire,
            "--infer-dtype", infer_dtype, "--port", "0",
            "--max-batch", str(max(BUCKETS)),
            "--buckets", ",".join(map(str, BUCKETS)), "--device", "cuda",
            "--warmup"]
    t0 = time.monotonic()
    engine, server = cli.build_server(cli.build_parser().parse_args(argv))
    server.start_background()
    sm = engine.model
    boot_s = time.monotonic() - t0
    want_wire = "float32" if name == "dcgan" else wire
    check(sm.weights == weights and str(sm.wire_dtype) == want_wire
          and sm.output_wire == "uint8" and sm.preprocess_kind == "gan",
          f"{name}: served {sm.describe()}")
    n = N_SEQ + N_CONC
    if name == "dcgan":
        bodies = [{"seed": 100 + i} for i in range(n)]
        inputs = np.stack([sm.workload.decode(b, sm) for b in bodies])
    else:
        inputs = synthetic_unpaired(n, sm.input_shape[0], seed=37,
                                    device_normalize=True)[0]
        bodies = [{"pixels": im.tolist()} for im in inputs]
    blobs = [json.dumps(b).encode() for b in bodies]
    path = "/v1/generate"
    try:
        serve_ingest.launches = 0
        replies = [post(server.port, b, path) for b in blobs[:N_SEQ]]
        t1 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(N_CONC) as pool:
            replies += list(pool.map(lambda b: post(server.port, b, path),
                                     blobs[N_SEQ:]))
        conc_s = time.monotonic() - t1
        again = post(server.port, blobs[0], path)
        launches = serve_ingest.launches
        stats = engine.stats()
        wrong_verbs = {}
        for other in sorted(set(WORKLOADS) - {"generate"}):
            try:
                post(server.port, blobs[0], f"/v1/{other}")
                wrong_verbs[other] = (200, {})
            except urllib.error.HTTPError as e:
                wrong_verbs[other] = (e.code, json.loads(e.read()))
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    for other, (status, reply) in wrong_verbs.items():
        check(status == 400 and path in reply.get("error", ""),
              f"{name} on /v1/{other} answered {status} {reply}")
    check(launches == 0, f"{name}: serve_ingest launched {launches} times "
                         f"on the generate path")
    check(again[0] == 200 and np.array_equal(reply_image(again[1]),
                                             reply_image(replies[0][1])),
          f"{name}: the same request answered different bytes")
    pipe = stats["pipeline"]
    copied = stats["served"] + stats["padded_images"]
    check(pipe["d2h_bytes"] == copied * GENERATE_ROW_BYTES[name],
          f"{name}: D2H {pipe['d2h_bytes']} B for {copied} padded images")
    check(stats["batches"] - N_SEQ - 1 < N_CONC,
          f"{name}: concurrent requests were never batched together")
    shape = list(reply_image(replies[0][1]).shape)
    check(shape == list(sm.input_shape if name != "dcgan" else (28, 28, 1)),
          f"{name}: answered images of shape {shape}")
    refs = {b: generate_rows(sm, inputs, b) for b in BUCKETS}
    spread = max(code_diff(a, b) for a, b in zip(refs[min(BUCKETS)],
                                                 refs[max(BUCKETS)]))
    faults = hold_images(replies, refs, 2 * spread)
    check(not faults, f"{name} {infer_dtype} answers: {faults[:5]}")
    control = None
    if sm.wire_dtype == np.uint8:
        control = len(hold_images(replies, {b: generate_rows(
            sm, inputs, b, "imagenet") for b in BUCKETS}, 2 * spread))
        check(2 * control > len(replies),
              f"{name}: the answer check passed against an 'imagenet' "
              f"prologue")
    exact = sum(min(code_diff(reply_image(r[1]), rows[i])
                    for rows in refs.values()) == 0
                for i, r in enumerate(replies))
    lat = sorted(r[2] for r in replies)
    out = {"wire": str(sm.wire_dtype), "infer_dtype": infer_dtype,
           "boot_s": boot_s, "launches": launches,
           "requests": len(replies) + 1, "batches": stats["batches"],
           "padded_images": stats["padded_images"],
           "d2h_bytes": pipe["d2h_bytes"],
           "d2h_bytes_by_bucket": pipe["d2h_bytes_by_bucket"],
           "bucket_spread_codes": spread, "exact_answers": exact,
           "control_faults": control,
           "client_p50_ms": lat[len(lat) // 2] * 1e3,
           "concurrent_img_per_s": N_CONC / conc_s,
           "wrong_verbs": {k: v[0] for k, v in wrong_verbs.items()},
           "act_scale": sm.quant.act_scale if sm.quant else None,
           "ms_by_bucket": generate_bucket_ms(sm)}
    return out


def phase_generate_serving() -> dict:
    """/v1/generate of dcgan (float32, the float32 wire forced) and
    cyclegan (uint8 wire, float32 and int8) on the card."""
    import torch

    out = {}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        for seed, (name, wire, dtype) in enumerate(GENERATE_MODELS):
            weights = os.path.join(tmp, f"{name}.npz")
            if not os.path.exists(weights):
                write_gan_weights(name, weights, 40 + seed)
            row = serve_generate(name, wire, dtype, weights)
            log(f"{name} {dtype} generate serving: {json.dumps(row)}")
            out[f"{name}_{dtype}"] = row
            torch.cuda.empty_cache()
    return out


def write_checkpoint(workdir: str, step: int, model) -> str:
    """``model``'s weights as step ``step`` of a port training run under
    ``workdir``, as ``cli.train`` writes it (``Checkpointer`` over a
    ``TrainState``: ``<workdir>/checkpoints/<step>/checkpoint.pt``)."""
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.optim import (
        OptimizerConfig,
        build_optimizer,
    )
    from deep_vision_tpu_torch.core.state import TrainState

    state = TrainState(model, build_optimizer(OptimizerConfig(), model), 0)
    return Checkpointer(os.path.join(workdir, "checkpoints")).save(
        step, state, extras={"epoch": step})


def seeded_classifier(seed: int, name: str = MODEL):
    """ResNet-50 (or the ImageNet ResNet ``name``) at full width from the
    seed, with non-zero BatchNorm scales and a seeded classifier bias (as
    ``seeded_weights``)."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config

    gen = torch.Generator().manual_seed(seed)
    model = get_config(name).model().reset_parameters(gen)
    nonzero_bn_(model, gen)
    with torch.no_grad():
        model.fc.bias.normal_(0.0, 0.1, generator=gen)
    return model


def boot_cli(argv: list) -> tuple:
    """``cli/serve.py``'s ``build_server`` on ``argv``, HTTP started."""
    from deep_vision_tpu_torch.cli import serve as cli

    engine, server = cli.build_server(cli.build_parser().parse_args(argv))
    server.start_background()
    return engine, server


def post_h(port: int, body: bytes, path: str, headers: dict | None = None
           ) -> tuple[int, bytes, dict, float]:
    """POST one pre-encoded body → (status, raw answer, headers, seconds);
    an error status comes back with its body, not raised."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), dict(r.headers), \
                time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers), time.monotonic() - t0


def post_any(port: int, body: bytes, path: str = "/v1/classify"
             ) -> tuple[int, dict, float]:
    """:func:`post` that returns an error status with its body instead of
    raising (and NaN seconds)."""
    status, blob, _, s = post_h(port, body, path)
    return status, json.loads(blob), s if status < 400 else math.nan


def force_level(port: int, level: int | None) -> None:
    """Pin the brownout ladder at ``level`` (None hands it back)."""
    status, blob, _, _ = post_h(port, json.dumps({"force": level}).encode(),
                                "/v1/brownout")
    check(status == 200 and json.loads(blob)["forced"] == level,
          f"POST /v1/brownout {level}: {status}")


def get_url(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        blob = r.read()
        return r.status, blob


def drive(port: int, bodies: list, n_seq: int, path: str = "/v1/classify"
          ) -> list:
    """``n_seq`` sequential requests, then the rest concurrently."""
    replies = [post_any(port, b, path) for b in bodies[:n_seq]]
    with concurrent.futures.ThreadPoolExecutor(len(bodies) - n_seq) as pool:
        replies += list(pool.map(lambda b: post_any(port, b, path),
                                 bodies[n_seq:]))
    return replies


def parse_metrics(text: str) -> dict:
    """Prometheus text → {series with labels: value}; raises on a line
    that is not a comment or ``name{labels} value``."""
    line_re = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?) (\S+)$")
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        check(m is not None, f"/metrics line does not parse: {line!r}")
        out[m.group(1)] = float(m.group(3))
    return out


def wait_for(cond, timeout: float = 10.0) -> bool:
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def fault_server_args(workdir: str, *extra) -> list:
    return ["-m", MODEL, "--workdir", workdir, "--wire-dtype", "uint8",
            "--infer-dtype", "int8", "--port", "0", "--device", "cuda",
            "--max-batch", str(max(BUCKETS)),
            "--buckets", ",".join(map(str, BUCKETS)), *extra]


def poison_run(workdir: str, card_line: str) -> dict:
    """The poison server: one quarantined request, 31 served within the
    serving bound, launches = executed batches, /metrics parsing, and the
    MFU at bucket 32."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    t0 = time.monotonic()
    engine, server = boot_cli(fault_server_args(
        workdir, "--warmup", "--max-wait-ms", "20",
        "--faults", POISON_SPEC, "--fault-seed", "0"))
    boot_s = time.monotonic() - t0
    sm = engine.model
    n = FAULT_N_SEQ + FAULT_N_CONC
    imgs = np.random.RandomState(5).randint(
        0, 256, (n, *sm.input_shape), np.uint8)
    body = {"top_k": 5}
    bodies = [json.dumps(dict(body, pixels=im.tolist())).encode()
              for im in imgs]
    try:
        check(sm.restored_step == 1 and not sm.restore_fallback,
              f"served step {sm.restored_step}, not the workdir's step 1")
        serve_ingest.launches = 0
        replies = drive(server.port, bodies, FAULT_N_SEQ)
        launches = serve_ingest.launches
        stats = engine.stats()
        _, text = get_url(server.port, "/metrics")
        series = parse_metrics(text.decode())
        # full batches for the bucket-32 MFU, straight into the engine
        futs = [engine.submit(im) for im in np.concatenate([imgs] * 4)]
        check(all(isinstance(f.result(120), np.ndarray) for f in futs),
              "a bucket-32 batch was not served")
        _, blob = get_url(server.port, "/v1/stats")
        mfu = json.loads(blob)[MODEL]["mfu"]
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    health = stats["health"]
    bad = [i for i, r in enumerate(replies) if r[0] != 200]
    check(len(bad) == 1, f"{len(bad)} requests failed, not 1: "
                         f"{[replies[i][:2] for i in bad]}")
    q = bad[0]
    check(replies[q][0] == 500 and replies[q][1]["error"].startswith(
        "quarantined: poison"), f"the poisoned request answered "
                                f"{replies[q][:2]}")
    check(health["quarantined"] == 1 and health["batch_failures"] == 1
          and health["retry_executions"] >= 3,
          f"quarantined {health['quarantined']}, failures "
          f"{health['batch_failures']}, retries "
          f"{health['retry_executions']}")
    check(launches == stats["batches"] > 0,
          f"serve_ingest launched {launches} times for {stats['batches']} "
          f"executed batches (pipelined + retry executions)")
    keep = [i for i in range(n) if i != q]
    held = hold_answers(MODEL, sm, imgs[keep], [replies[i] for i in keep],
                        body, classify_diff, control="unit")
    check(series.get(f'dvt_serve_quarantined_total{{model="{MODEL}"}}')
          == 1.0, "/metrics does not count the quarantine")
    m32 = mfu["mfu_by_bucket"].get("32")
    log(f"serving MFU at bucket 32: {m32} ({mfu['flops_source']}, "
        f"{mfu['flops_by_bucket']['32']} FLOPs a batch, peak "
        f"{mfu['peak_flops_per_s']}) on {card_line}")
    check(m32 is not None and 0 < m32 <= 1 and
          mfu["flops_source"] == "flop_counter",
          f"bucket-32 MFU {m32} ({mfu['flops_source']})")
    lat = sorted(r[2] for i, r in enumerate(replies) if i != q)
    return {"boot_s": boot_s, "quarantined_index": q,
            "launches": launches, "batches": stats["batches"],
            "retry_executions": health["retry_executions"],
            "retry_seconds": health["retry_seconds"],
            "batch_failures": health["batch_failures"],
            "client_p50_ms": lat[len(lat) // 2] * 1e3,
            "poisoned_request_ms": replies[q][2] * 1e3
            if not math.isnan(replies[q][2]) else None,
            "metrics_series": len(series), "mfu": mfu, **held}


def restart_run(workdir: str) -> dict:
    """A batcher killed once is restarted by the watchdog; every request
    is answered and /v1/healthz reads 200 after the restart."""
    engine, server = boot_cli(fault_server_args(
        workdir, "--faults", "batcher:die:times=1"))
    try:
        check(wait_for(lambda: engine.health.watchdog_restarts >= 1),
              "the watchdog never restarted the killed batcher")
        bodies = [json.dumps({"pixels": im.tolist()}).encode()
                  for im in np.random.RandomState(6).randint(
                      0, 256, (8, *engine.model.input_shape), np.uint8)]
        replies = drive(server.port, bodies, 4)
        status, blob = get_url(server.port, "/v1/healthz")
        rep = engine.health_report()
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    check(all(r[0] == 200 for r in replies),
          f"after the restart: {[r[0] for r in replies]}")
    check(status == 200 and rep["watchdog_restarts"] == 1
          and rep["batcher_alive"],
          f"healthz {status}, restarts {rep['watchdog_restarts']}")
    return {"watchdog_restarts": rep["watchdog_restarts"],
            "healthz_after": status, "requests": len(replies)}


def hang_run(workdir: str) -> dict:
    """The third batch hangs in the D2H stage for 30 s: the watchdog
    fails it at its exec timeout (504), then the server serves again."""
    engine, server = boot_cli(fault_server_args(
        workdir, "--faults", HANG_SPEC))
    body = json.dumps({"pixels": np.random.RandomState(7).randint(
        0, 256, engine.model.input_shape).tolist()}).encode()
    try:
        first = [post_any(server.port, body) for _ in range(2)]
        limit = engine.exec_timeout_s(1)
        t0 = time.monotonic()
        hung = post_any(server.port, body)
        failed_after = time.monotonic() - t0
        after = post_any(server.port, body)
        timeouts = engine.exec_timeouts
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    log(f"hang: exec timeout {limit:.3f} s, the hung batch failed after "
        f"{failed_after:.3f} s with {hung[0]}")
    check([r[0] for r in first] == [200, 200] and after[0] == 200,
          f"around the hang: {[r[0] for r in first]}, {after[0]}")
    check(hung[0] == 504 and timeouts == 1 and
          limit <= failed_after < limit + 2.0,
          f"the hung batch answered {hung[:2]} after {failed_after} s "
          f"(limit {limit} s, {timeouts} timeouts)")
    return {"exec_timeout_s": limit, "failed_after_s": failed_after,
            "status": hung[0]}


def phase_faults(card_line: str) -> dict:
    """ResNet-50 int8 from a port checkpoint under the fault plane:
    poison → quarantine, a killed batcher restarted, a hung batch failed
    at its exec timeout, /metrics and the bucket-32 MFU."""
    import torch

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        workdir = os.path.join(tmp, MODEL)
        write_checkpoint(workdir, 1, seeded_classifier(0))
        out = {"poison": poison_run(workdir, card_line)}
        log(f"faults, poison: {json.dumps(out['poison'])}")
        out["restart"] = restart_run(workdir)
        out["hang"] = hang_run(workdir)
        log(f"faults, restart and hang: {json.dumps(out['restart'])} "
            f"{json.dumps(out['hang'])}")
        torch.cuda.empty_cache()
    return out


def rounded_bytes(sm) -> int:
    """The device bytes the caching allocator gives ``sm``'s weights:
    each tensor rounded up to its 512-byte block."""
    return sum(-(-t.numel() * t.element_size() // 512) * 512
               for t in sm._tensors())


def plane_reference(workdir: str) -> dict:
    """Each plane model loaded alone (no cache, nothing evicted): its
    weight bytes and its bucket-1 answers to seeded images, the
    reference the plane's answers must equal bit for bit; its evict and
    re-admit times (and the same answer after 6 cycles); and 32 images
    whose ResNet-50 top-1 the direct call decides (the reload's
    clients)."""
    import torch

    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    out = {}
    for seed, name in enumerate(PLANE_MODELS):
        sm = ModelRegistry().load_checkpoint(
            name, workdir=os.path.join(workdir, name), wire_dtype="uint8",
            infer_dtype="int8", device="cuda")
        imgs = np.random.RandomState(30 + seed).randint(
            0, 256, (PLANE_ROUNDS, *sm.input_shape), np.uint8)
        fn = sm.compile_bucket(1)
        body = PLANE_BODY[sm.workload.verb]
        answers = []
        for im in imgs:
            out_ = fn(im[None])
            row = out_[0].cpu().numpy() if isinstance(out_, torch.Tensor) \
                else {k: v[0].cpu().numpy() for k, v in out_.items()}
            answers.append(json.loads(json.dumps(
                sm.workload.respond(sm, body, row))))
        # evict and re-admit timed on the host clock around a
        # synchronize: the first spill copies to pinned host memory,
        # later ones only drop the device storage
        t0 = time.perf_counter()
        sm.spill_weights()
        first_spill_ms = (time.perf_counter() - t0) * 1e3
        evict_ms, readmit_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            sm.admit_weights()
            torch.cuda.synchronize()
            readmit_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            sm.spill_weights()
            torch.cuda.synchronize()
            evict_ms.append((time.perf_counter() - t0) * 1e3)
        sm.admit_weights()
        again = fn(imgs[:1])
        row = again[0].cpu().numpy() if isinstance(again, torch.Tensor) \
            else {k: v[0].cpu().numpy() for k, v in again.items()}
        check(json.loads(json.dumps(sm.workload.respond(sm, body, row)))
              == answers[0], f"{name} answers otherwise after 6 evictions")
        out[name] = {"bytes": sm.param_bytes(), "rounded": rounded_bytes(sm),
                     "tensors": len(sm._tensors()),
                     "first_spill_ms": first_spill_ms,
                     "evict_ms": sorted(evict_ms),
                     "readmit_ms": sorted(readmit_ms),
                     "images": imgs, "answers": answers,
                     "path": f"/v1/models/{name}/{sm.workload.verb}"}
        log(f"{name}: {out[name]['bytes']} B in {out[name]['tensors']} "
            f"tensors, first spill {first_spill_ms:.3f} ms, evict "
            f"{sorted(evict_ms)} ms, re-admit {sorted(readmit_ms)} ms")
        if name == MODEL:
            out["decided"], _ = decided_images(sm, PLANE_CLIENT_IMAGES)
        del sm, fn
        torch.cuda.empty_cache()
    return out


def tier_reply(i: int, reply) -> dict:
    """One answer of image ``i`` with its status, tier and degraded
    headers, JSON body and seconds."""
    status, blob, headers, s = reply
    return {"i": i, "status": status, "body": json.loads(blob),
            "tier": headers.get("X-DVT-Tier"),
            "degraded": headers.get("X-DVT-Degraded"), "s": s}


class Clients:
    """Closed-loop clients over ``bodies`` (thread k takes images k, k+n,
    ...), every answer kept as :func:`tier_reply`; ``unique`` appends a
    per-request field to each body, so no two requests share a cache
    key.  A shed client retries after ``retry_s``, whatever its
    Retry-After says.  A transport failure is a lost request:
    :meth:`finish` fails on any."""

    def __init__(self, port: int, path: str, bodies: list, n: int = 4,
                 headers: dict | None = None, unique: bool = False,
                 retry_s: float = 0.0):
        self.stop = threading.Event()
        self.replies: list = []
        self.errors: list = []
        self.threads = [threading.Thread(
            target=self._run, args=(port, path, bodies, headers, unique,
                                    retry_s, list(range(i, len(bodies), n))),
            daemon=True) for i in range(n)]
        for t in self.threads:
            t.start()

    def _run(self, port, path, bodies, headers, unique, retry_s, idxs):
        k = 0
        while not self.stop.is_set():
            i = idxs[k % len(idxs)]
            body = bodies[i]
            if unique:
                body = body[:-1] + f', "n": {k}}}'.encode()
            k += 1
            try:
                r = tier_reply(i, post_h(port, body, path, headers))
            except Exception as e:  # noqa: BLE001 — a transport failure is a lost request
                self.errors.append(repr(e))
                continue
            self.replies.append(r)
            if r["status"] == 429:
                time.sleep(retry_s)

    def finish(self):
        """Stop and join the clients; unless the caller is already
        failing, fail on a client that never returned or a lost
        request."""
        self.stop.set()
        for t in self.threads:
            t.join(300)
        if sys.exc_info()[0] is None:
            check(not any(t.is_alive() for t in self.threads),
                  "a client never returned")
            check(not self.errors, f"{len(self.errors)} lost requests: "
                                   f"{self.errors[:3]}")


def eviction_run(plane, port: int, ref: dict) -> dict:
    """Alternating sequential requests: each switch evicts one model and
    re-admits the other; the answers bit-identical to the reference,
    ``memory_allocated`` following the cache, no callable rebuilt,
    launches = batches."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    engines = {n: plane.active_engine(n) for n in PLANE_MODELS}
    cache = plane.cache
    bodies = {n: [json.dumps(dict(PLANE_BODY[engines[n].model.workload
                                             .verb],
                                  pixels=im.tolist())).encode()
                  for im in ref[n]["images"]] for n in PLANE_MODELS}
    other = {PLANE_MODELS[0]: PLANE_MODELS[1],
             PLANE_MODELS[1]: PLANE_MODELS[0]}
    # one request each first: an engine stream's first cuBLAS call keeps
    # a workspace allocated for that stream, which is no weight movement
    primed = []
    for n in PLANE_MODELS:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        status, reply, _ = post_any(port, bodies[n][0], ref[n]["path"])
        check(status == 200 and reply == ref[n]["answers"][0],
              f"{n}: the priming request answered {status} otherwise")
        torch.cuda.synchronize()
        primed.append(torch.cuda.memory_allocated() - before
                      - ref[n]["rounded"] + ref[other[n]]["rounded"])
    log(f"plane eviction: priming requests moved memory_allocated by "
        f"{primed} B beyond the weights")
    compiles = {n: e.compiles for n, e in engines.items()}
    batches = {n: e.stats()["batches"] for n, e in engines.items()}
    evictions0 = cache.stats()["evictions"]
    serve_ingest.launches = 0
    lat = {"miss": {n: [] for n in PLANE_MODELS},
           "hit": {n: [] for n in PLANE_MODELS}}
    mem = []
    for i in range(PLANE_ROUNDS):
        for n in PLANE_MODELS:
            for kind in ("miss", "hit"):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                status, reply, secs = post_any(port, bodies[n][i],
                                               ref[n]["path"])
                torch.cuda.synchronize()
                after = torch.cuda.memory_allocated()
                check(status == 200 and reply == ref[n]["answers"][i],
                      f"{n} image {i} ({kind}): {status}, not the answer "
                      f"before any eviction")
                check(cache.resident_models() == [n],
                      f"resident {cache.resident_models()} after {n}")
                lat[kind][n].append(secs * 1e3)
                mem.append((n, kind, after - before, after))
    launches = serve_ingest.launches
    ran = sum(e.stats()["batches"] - batches[n] for n, e in engines.items())
    st = cache.stats()
    check(launches == ran, f"serve_ingest launched {launches} times for "
                           f"{ran} batches")
    check({n: e.compiles for n, e in engines.items()} == compiles,
          "a bucket callable was rebuilt across eviction")
    check(st["evictions"] - evictions0 >= 2 * PLANE_ROUNDS - 1,
          f"only {st['evictions'] - evictions0} evictions")
    # a hit moves nothing; each model resident reads the same
    # memory_allocated every round (the evicted storage is freed); and
    # the two resident states differ by the two models' weight bytes,
    # up to the caching allocator's slack
    log(f"plane eviction: memory_allocated (model, request, change, "
        f"value): {mem}")
    check(all(d == 0 for _, kind, d, _ in mem if kind == "hit"),
          "a hit moved memory_allocated")
    resident = {n: {a for m, _, _, a in mem if m == n}
                for n in PLANE_MODELS}
    check(all(len(v) == 1 for v in resident.values()),
          f"memory_allocated differs between rounds: {resident}")
    a, b = (resident[n].pop() for n in PLANE_MODELS)
    worst = abs((b - a) - (ref[PLANE_MODELS[1]]["rounded"]
                           - ref[PLANE_MODELS[0]]["rounded"]))
    check(worst <= PLANE_MEM_SLACK,
          f"the resident states differ by {b - a} B, {worst} B off the "
          f"weights' bytes")

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    return {"launches": launches, "batches": ran,
            "evictions": st["evictions"] - evictions0,
            "admits": st["admits"], "spilled_bytes_total":
            st["spilled_bytes_total"], "bytes": {n: ref[n]["bytes"]
                                                 for n in PLANE_MODELS},
            "max_memory_error_bytes": worst,
            "priming_extra_bytes": primed,
            "miss_ms_median": {n: med(v) for n, v in lat["miss"].items()},
            "hit_ms_median": {n: med(v) for n, v in lat["hit"].items()},
            "readmit_ms_median": {n: med(lat["miss"][n]) - med(lat["hit"][n])
                                  for n in PLANE_MODELS}}


def reload_run(plane, port: int, workdir: str, ref: dict, step: int,
               model) -> dict:
    """Write ``model`` as step ``step`` and reload it under 4 closed-loop
    clients on ResNet-50; returns the lifecycle's numbers."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    write_checkpoint(os.path.join(workdir, MODEL), step, model)
    bodies = [json.dumps({"pixels": im.tolist(), "top_k": 5}).encode()
              for im in ref["decided"]]
    batches0 = sum(mv.engine.stats()["batches"]
                   for mv in plane.versions(MODEL))
    serve_ingest.launches = 0
    clients = Clients(port, ref[MODEL]["path"], bodies)
    try:
        t0 = time.monotonic()
        status, out, _ = post_any(port, json.dumps({"wait": True}).encode(),
                                  f"/v1/models/{MODEL}/reload")
        reload_s = time.monotonic() - t0
    finally:
        clients.finish()
    launches = serve_ingest.launches
    ran = sum(mv.engine.stats()["batches"]
              for mv in plane.versions(MODEL)) - batches0
    # the new version's engine ran every bucket once at warmup
    check(launches == ran + len(BUCKETS),
          f"serve_ingest launched {launches} times for {ran} batches and "
          f"{len(BUCKETS)} warmup calls")
    check(status == 200 and out.get("status") == "done",
          f"reload answered {status} {out}")
    codes = [r["status"] for r in clients.replies]
    return {"version": out["version"], "reload_s": reload_s,
            "client_requests": len(codes),
            "client_statuses": sorted(set(codes)),
            "client_replies": clients.replies,
            "launches": launches, "batches": ran}


def nan_rollback(plane, port: int, workdir: str, ref: dict, step: int,
                 model, imgs) -> dict:
    """Reload ResNet-50 to ``model``, which holds a NaN, under 4 clients:
    the canary's error-rate gate retires it, version 2 stays active and
    answers finite logits after."""
    run = reload_run(plane, port, workdir, ref, step, model)
    v = run.pop("version")
    replies = run.pop("client_replies")
    log(f"plane NaN reload (step {step}): {json.dumps(v)} "
        f"{json.dumps(run)}")
    check(v["state"] == "retired" and "canary error rate" in
          (v["state_reason"] or ""), f"the NaN step {step}: {v}")
    check(plane.stats()["models"][MODEL]["active_version"] == 2,
          f"the rollback of step {step} did not keep version 2")
    finite = drive(port, [json.dumps({"pixels": im.tolist(), "top_k": 5}
                                     ).encode() for im in imgs],
                   2, ref[MODEL]["path"])
    check(all(r[0] == 200 and all(math.isfinite(t["logit"])
                                  for t in r[1]["top"]) for r in finite),
          f"answers after the rollback of step {step} are not finite")
    return dict(run, state_reason=v["state_reason"], canary=v["canary"],
                nan_answers_during_canary=sum(
                    1 for r in replies if r["status"] == 200 and not all(
                        math.isfinite(t["logit"])
                        for t in r["body"]["top"])))


def phase_plane() -> dict:
    """``--models resnet50,yolov3_coco`` with a weight-cache budget
    between the larger model's bytes and their sum: eviction and
    readmission, a hot reload through shadow and canary under 4 clients,
    NaN candidates rolled back by the canary gate, torn newest
    checkpoints falling back at a fresh boot."""
    import torch

    from deep_vision_tpu_torch.core.restore import params_digest
    from deep_vision_tpu_torch.serve.models import CanaryPolicy

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as workdir:
        step1 = seeded_classifier(1)
        write_checkpoint(os.path.join(workdir, MODEL), 1, step1)
        write_checkpoint(os.path.join(workdir, "yolov3_coco"), 1,
                         seeded_model("yolov3_coco", 2))
        ref = plane_reference(workdir)
        sizes = [ref[n]["bytes"] for n in PLANE_MODELS]
        budget_mb = (max(sizes) + sum(sizes)) / 2 / 2**20
        timing = {n: {k: ref[n][k] for k in ("tensors", "first_spill_ms",
                                             "evict_ms", "readmit_ms")}
                  for n in PLANE_MODELS}
        t0 = time.monotonic()
        plane, server = boot_cli([
            "--models", ",".join(PLANE_MODELS), "--workdir", workdir,
            "--wire-dtype", "uint8", "--infer-dtype", "int8", "--warmup",
            "--port", "0", "--device", "cuda",
            "--max-batch", str(max(BUCKETS)),
            "--buckets", ",".join(map(str, BUCKETS)),
            "--hbm-budget-mb", f"{budget_mb:.6f}",
            "--canary-frac", "0.25", "--canary-min-requests", "8",
            "--shadow-frac", "0.5", "--phase-timeout-s", "120"])
        out = {"boot_s": time.monotonic() - t0, "budget_mb": budget_mb,
               "weights_alone": timing}
        try:
            cache = plane.cache.stats()
            check({n: cache["models"][n]["bytes"] for n in PLANE_MODELS}
                  == dict(zip(PLANE_MODELS, sizes))
                  and max(sizes) < cache["budget_bytes"] < sum(sizes),
                  f"cache {cache} for weights of {sizes} B")
            out["eviction"] = eviction_run(plane, server.port, ref)
            log(f"plane eviction: {json.dumps(out['eviction'])}")
            # a new step: step 1 with the classifier bias moved (every
            # logit moves; top-1 stays on the decided images, which the
            # shadow's top-1 agreement gate reads)
            step2 = seeded_classifier(1)
            gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                step2.fc.bias.add_(0.25 + 1e-3 * torch.randn(
                    step2.fc.bias.shape, generator=gen))
            run = reload_run(plane, server.port, workdir, ref, 2, step2)
            v = run.pop("version")
            replies = run.pop("client_replies")
            log(f"plane reload to step 2: {json.dumps(v)} "
                f"{json.dumps(run)}")
            check(v["state"] == "active" and v["version"] == 2
                  and v["step"] == 2, f"step 2 reached {v}")
            check(v.get("shadow", {}).get("compared", 0) >= 10
                  and v.get("canary", {}).get("requests", 0) >= 8,
                  f"no shadow or canary on the way: {v}")
            check(run["client_statuses"] == [200],
                  f"clients lost requests: {run['client_statuses']}")
            _, blob = get_url(server.port, "/v1/models")
            listing = json.loads(blob)["models"][MODEL]
            check(listing["active_version"] == 2 and
                  listing["model"]["params_digest"] == params_digest(step2),
                  f"/v1/models shows {listing['model']['params_digest']}")
            sm2 = plane.resolve(MODEL)
            imgs = ref["decided"][:N_SEQ]
            after = drive(server.port, [json.dumps(
                {"pixels": im.tolist(), "top_k": 5}).encode()
                for im in imgs], 2, ref[MODEL]["path"])
            with sm2.weights_in_use():  # direct calls read the weights
                run.update(hold_answers(f"{MODEL} v2", sm2, imgs, after,
                                        {"top_k": 5}, classify_diff,
                                        control="unit"))
            out["reload"] = dict(run, shadow=v["shadow"],
                                 canary=v["canary"])
            # NaN candidates, one in the classifier's weight matrix
            # (int8 codes 0 and a NaN scale for its channel) and one in
            # its bias (kept in float32); these reloads skip the shadow
            # phase, whose top-1 gate would catch them first, so the
            # canary's error-rate gate is the one exercised
            plane.policy = CanaryPolicy(canary_frac=0.25, min_requests=8,
                                        phase_timeout_s=120.0)
            out["nan_rollback"] = {}
            for step, where in ((3, "weight"), (4, "bias")):
                bad = copy.deepcopy(step2)
                with torch.no_grad():
                    getattr(bad.fc, where).view(-1)[0] = float("nan")
                out["nan_rollback"][where] = nan_rollback(
                    plane, server.port, workdir, ref, step, bad, imgs)
        finally:
            server.shutdown()
            plane.stop(drain_deadline=10.0)
        # torn newest steps (both NaN candidates): a fresh boot falls
        # back past them to step 2
        for step in (4, 3):
            path = os.path.join(workdir, MODEL, "checkpoints", str(step),
                                "checkpoint.pt")
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
        del plane, server
        torch.cuda.empty_cache()
        engine, server = boot_cli(fault_server_args(
            os.path.join(workdir, MODEL)))
        try:
            reply = post_any(server.port, json.dumps(
                {"pixels": ref["decided"][0].tolist()}).encode())
            _, blob = get_url(server.port, "/v1/models")
            described = json.loads(blob)["models"][MODEL]["model"]
        finally:
            server.shutdown()
            engine.stop(drain_deadline=10.0)
        check(described["restored_step"] == 2 and
              described["restore_fallback"] is True and reply[0] == 200,
              f"the torn boot served {described['restored_step']} "
              f"(fallback {described['restore_fallback']}): {reply[0]}")
        out["torn"] = {"restored_step": 2, "restore_fallback": True}
        torch.cuda.empty_cache()
    return out


def bucket_answers(sm, imgs: np.ndarray, body: dict,
                   kind: str | None = None) -> dict:
    """bucket → each image's answer (JSON round-tripped) from a direct
    call at that bucket: the model's own bucket callable (the single
    engine's, through ``serve_ingest``, its epilogue included), or with
    ``kind`` the PLAIN ingest of that kind (a control)."""
    import torch

    from deep_vision_tpu_torch.serve.engine import map_leaves

    out = {}
    for b in BUCKETS:
        if kind is not None:
            rows = direct_rows(sm, imgs, b, kind)
        else:
            fn, rows = sm.compile_bucket(b), []
            for i in range(0, len(imgs), b):
                chunk = imgs[i:i + b]
                batch = np.zeros((b, *sm.input_shape), np.uint8)
                batch[:len(chunk)] = chunk
                res = map_leaves(lambda t: t.cpu().numpy(), fn(batch))
                torch.cuda.synchronize()
                rows += [map_leaves(lambda a, j=j: a[j], res)
                         for j in range(len(chunk))]
        out[b] = [json.loads(json.dumps(sm.workload.respond(sm, body, r)))
                  for r in rows]
    return out


def exact_buckets(replies, refs: dict) -> tuple[list, list]:
    """For each reply, the buckets whose direct answer it equals bit for
    bit (JSON equality: the same top-5 classes and float32 logits);
    returns those lists and the faults (a non-200, or no bucket)."""
    faults, hits = [], []
    for i, (status, got, _) in enumerate(replies):
        if status != 200:
            faults.append(f"request {i}: HTTP {status} {got}")
            hits.append([])
            continue
        hits.append([b for b, rows in refs.items() if rows[i] == got])
        if not hits[-1]:
            faults.append(f"request {i}: equal to no bucket's answer")
    return hits, faults


def closed_loop_img_s(engine, imgs) -> float:
    """Submit every image at once and wait for all: images a second."""
    t0 = time.perf_counter()
    futs = [engine.submit(im) for im in imgs]
    for f in futs:
        check(isinstance(f.result(120), np.ndarray), "a timed request "
              "was not served")
    return len(imgs) / (time.perf_counter() - t0)


def memory_idle(clear_workspaces: bool) -> int:
    """``memory_allocated`` with nothing in flight; with
    ``clear_workspaces`` the per-(thread, stream) cuBLAS workspaces are
    dropped first (a stream's first GEMM allocates one, and it outlives
    the stream's engine: library state, not weights)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if clear_workspaces:
        torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def phase_fleet() -> dict:
    """ResNet-50 int8 on the uint8 wire from a port checkpoint, served by
    ``ReplicatedEngine(devices=[cuda:0, cuda:0])`` behind the HTTP front
    end: answers bit-identical to the single engine's at a bucket, both
    replicas routed, launches = batches; replica 1 forced DEAD under
    load; both DEAD; a replica added and removed under load with the
    memory given back; the autoscaler on the real engine."""
    import threading

    import torch

    from deep_vision_tpu_torch.deploy import ReplicaAutoscaler
    from deep_vision_tpu_torch.ops.ingest import serve_ingest
    from deep_vision_tpu_torch.serve.admission import AdmissionController
    from deep_vision_tpu_torch.serve.engine import BatchingEngine
    from deep_vision_tpu_torch.serve.http import ServeServer
    from deep_vision_tpu_torch.serve.registry import ModelRegistry
    from deep_vision_tpu_torch.serve.replicas import ReplicatedEngine

    body = {"top_k": 5}
    out: dict = {}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        workdir = os.path.join(tmp, MODEL)
        write_checkpoint(workdir, 1, seeded_classifier(4))
        registry = ModelRegistry()
        sm = registry.load_checkpoint(MODEL, workdir=workdir,
                                      wire_dtype="uint8",
                                      infer_dtype="int8",
                                      device=FLEET_DEVICE)
        t0 = time.monotonic()
        engine = ReplicatedEngine(
            sm, devices=[FLEET_DEVICE] * 2, buckets=list(BUCKETS),
            admission=AdmissionController(max_queue=1024),
            watchdog_interval_s=0.05).start()
        engine.warmup()
        out["build_and_warm_s"] = time.monotonic() - t0
        server = ServeServer(registry, {MODEL: engine}, port=0
                             ).start_background()
        port = server.port
        try:
            imgs = np.random.RandomState(40).randint(
                0, 256, (FLEET_DEAD_N, *sm.input_shape), np.uint8)
            refs = bucket_answers(sm, imgs, body)
            bodies = [json.dumps({"pixels": im.tolist(), **body}).encode()
                      for im in imgs]
            n = FLEET_N_SEQ + FLEET_N_CONC
            batches0 = engine.stats()["batches"]
            routed0 = list(engine.routed_batches)
            serve_ingest.launches = 0
            replies = drive(port, bodies[:n], FLEET_N_SEQ)
            launches = serve_ingest.launches
            st = engine.stats()
            ran = st["batches"] - batches0
            routed = [a - b for a, b in zip(engine.routed_batches, routed0)]
            hits, faults = exact_buckets(replies, refs)
            check(not faults, f"fleet answers: {faults[:5]}")
            check(all(r > 0 for r in routed), f"routed batches {routed}")
            check(launches == ran, f"serve_ingest launched {launches} "
                                   f"times for {ran} batches")
            control = exact_buckets(replies, bucket_answers(
                sm, imgs[:n], body, kind="unit"))[1]
            check(2 * len(control) > n, "the fleet answer check passed "
                                        "against a 'unit' ingest")
            out["serve"] = {
                "requests": n, "batches": ran, "launches": launches,
                "routed_batches": routed,
                "answers_by_bucket": {str(b): sum(b in h for h in hits)
                                      for b in BUCKETS},
                "control_faults": len(control)}
            log(f"fleet: {json.dumps(out['serve'])}")

            # replica 1 DEAD under 96 concurrent requests, 24 requests
            # in; the supervisor's evacuation timed from the kill
            ev0 = engine.evacuations
            done = threading.Event()
            evac_ms: list = []

            def kill():
                while engine.submitted < st["submitted"] + 24 \
                        and not done.is_set():
                    time.sleep(0.001)
                t_kill = time.monotonic()
                engine.replicas[1].health.force_dead("chip smoke kill")
                while engine.evacuations == ev0 \
                        and time.monotonic() < t_kill + 10.0:
                    time.sleep(0.0005)
                evac_ms.append((time.monotonic() - t_kill) * 1e3)

            killer = threading.Thread(target=kill, daemon=True)
            killer.start()
            try:
                dead_replies = drive(port, bodies, 0)
            finally:
                done.set()
                killer.join(60)
            check(bool(evac_ms) and engine.evacuations > ev0,
                  "no evacuation after replica 1 died")
            hits, faults = exact_buckets(dead_replies, refs)
            check(not faults, f"answers with replica 1 DEAD: {faults[:5]}")
            status, health = get_url(port, "/v1/healthz")
            health = json.loads(health)
            rep = health["engines"][MODEL]
            check(status == 200 and rep["state"] == "degraded"
                  and rep["replicas"]["1"]["state"] == "dead",
                  f"healthz {status} {rep['state']} with replica 1 DEAD")
            engine.replicas[0].health.force_dead("chip smoke kill")
            try:
                get_url(port, "/v1/healthz")
                all_dead = 200
            except urllib.error.HTTPError as e:
                all_dead = e.code
            shed = post_any(port, bodies[0])
            check(all_dead == 503 and shed[0] == 429,
                  f"all DEAD: healthz {all_dead}, request {shed[0]}")
            st = engine.stats()
            out["dead"] = {
                "requests": len(dead_replies), "lost": 0,
                "evacuations": st["routing"]["evacuations"],
                "rescued_requests": st["routing"]["rescued_requests"],
                "answers_by_bucket": {str(b): sum(b in h for h in hits)
                                      for b in BUCKETS},
                "healthz_one_dead": status, "healthz_all_dead": all_dead,
                "all_dead_request": shed[0],
                "kill_to_evacuation_ms": evac_ms[0],
                "shed_all_dead": st["routing"]["shed_all_dead"]}
            log(f"fleet, replica DEAD: {json.dumps(out['dead'])}")
            for r in engine.replicas:
                r.health.revive()
            check(wait_for(lambda: engine.health_report()["state"] == "ok",
                           10.0), "the revived fleet is not ok")

            # a replica added and removed under 4 clients
            mem_before = {k: memory_idle(k) for k in (False, True)}
            clients = Clients(port, "/v1/classify", bodies)
            try:
                t0 = time.monotonic()
                i = engine.add_replica(FLEET_DEVICE)
                add_s = time.monotonic() - t0
                check(wait_for(lambda: engine.routed_batches[i] >= 3, 60.0),
                      f"the added replica routed {engine.routed_batches[i]}"
                      f" batches")
                t0 = time.monotonic()
                engine.remove_replica(i, drain_deadline=10.0)
                remove_s = time.monotonic() - t0
                time.sleep(0.5)
            finally:
                clients.finish()
            codes = sorted({r["status"] for r in clients.replies})
            check(codes == [200], f"clients across add/remove: {codes}")
            mem_after = {k: memory_idle(k) for k in (False, True)}
            delta = mem_after[True] - mem_before[True]
            check(abs(delta) <= PLANE_MEM_SLACK,
                  f"memory_allocated moved by {delta} B across an added "
                  f"and removed replica")
            out["elastic"] = {
                "added": i, "add_s": add_s, "remove_s": remove_s,
                "routed_to_added": engine.routed_batches[i],
                "client_requests": len(clients.replies),
                "weight_bytes": sm.param_bytes(),
                "memory_delta_bytes": delta,
                # idle bytes of cuBLAS workspaces, before the add and
                # after the remove
                "cublas_workspace_bytes": [
                    mem_before[False] - mem_before[True],
                    mem_after[False] - mem_after[True]]}
            log(f"fleet, add and remove: {json.dumps(out['elastic'])}")

            # the autoscaler on the real engine: finite signals; forced
            # pressure with no spare device costs one error and a
            # cooldown
            scaler = ReplicaAutoscaler(engine, min_replicas=1,
                                       max_replicas=3, up_window=1,
                                       cooldown_s=60.0)
            sig = scaler.signals()
            check(all(math.isfinite(sig[k]) for k in
                      ("pressure_ms", "exec_ewma_ms", "occupancy")),
                  f"autoscaler signals {sig}")
            scaler.signals = lambda: dict(
                ReplicaAutoscaler.signals(scaler), pressure_ms=1e6)
            first, second = scaler.tick(), scaler.tick()
            check(first is None and second is None
                  and scaler.scale_errors == 1 and scaler.ticks == 2,
                  f"forced pressure without a spare device: "
                  f"{scaler.stats()}")
            out["autoscaler"] = {"signals": sig,
                                 "scale_errors": scaler.scale_errors,
                                 "live": engine.live_replicas()}

            # information only: a single engine and the 2-replica fleet
            # on the same closed-loop batch, in turns
            single = BatchingEngine(sm, buckets=list(BUCKETS),
                                    admission=AdmissionController(
                                        max_queue=1024)).start()
            try:
                single.warmup()
                timed = imgs[np.arange(FLEET_TIMED_N) % len(imgs)]
                rates = {"single": [], "fleet": []}
                for _ in range(FLEET_TIMED_ROUNDS):
                    for name, eng in (("single", single),
                                      ("fleet", engine),
                                      ("fleet", engine),
                                      ("single", single)):
                        rates[name].append(closed_loop_img_s(eng, timed))
            finally:
                single.stop()
            out["img_per_s"] = rates
            log(f"fleet img/s (closed loop of {FLEET_TIMED_N}, in turns): "
                f"{json.dumps(rates)}")
        finally:
            server.shutdown()
            engine.stop(drain_deadline=10.0)
        del engine, sm
        torch.cuda.empty_cache()
    return out


def history_outcomes(port: int) -> list:
    _, blob = get_url(port, f"/v1/deploy/{MODEL}/history")
    return [e["outcome"] for e in json.loads(blob)["entries"]]


def sequential_answers(port: int, bodies: list) -> list:
    """One request at a time: each forms a bucket-1 batch alone."""
    out = []
    for b in bodies:
        status, reply, _ = post_any(port, b)
        check(status == 200, f"a sequential request answered {status}")
        out.append(reply)
    return out


def phase_deploy() -> dict:
    """``--models resnet50 --watch --gate-dir`` over HTTP under 4
    closed-loop clients: a new step rolls out through the gate, shadow
    and canary; a NaN step is refused by the gate; a revert restores
    v1's answers; the ledger survives a restart."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    size = get_config(MODEL).image_size
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as workdir:
        mdir = os.path.join(workdir, MODEL)
        step1 = seeded_classifier(1)
        write_checkpoint(mdir, 1, step1)
        gate_dir = os.path.join(workdir, "holdout")
        os.makedirs(gate_dir)
        rng = np.random.RandomState(50)
        for k in range(DEPLOY_GATE_IMAGES):
            np.save(os.path.join(gate_dir, f"img_{k:02d}.npy"),
                    rng.randint(0, 256, (size, size, 3), np.uint8))
        argv = ["--models", MODEL, "--workdir", workdir,
                "--wire-dtype", "uint8", "--infer-dtype", "int8",
                "--port", "0", "--device", FLEET_DEVICE,
                "--max-batch", str(max(BUCKETS)),
                "--buckets", ",".join(map(str, BUCKETS)),
                "--watch", "--watch-interval-s", str(DEPLOY_POLL_S),
                "--gate-dir", gate_dir, "--canary-frac", "0.25",
                "--canary-min-requests", "8", "--shadow-frac", "0.5",
                "--phase-timeout-s", "120"]
        t0 = time.monotonic()
        plane, server = boot_cli(argv + ["--warmup"])
        out["boot_s"] = time.monotonic() - t0
        port = server.port
        deploy = server.httpd.deploy
        try:
            # step 2 moves every logit by the same 0.25, so the shadow's
            # top-1 agreement holds on any image
            imgs = np.random.RandomState(51).randint(
                0, 256, (16, size, size, 3), np.uint8)
            bodies = [json.dumps({"pixels": im.tolist(), "top_k": 5}
                                 ).encode() for im in imgs]
            v1 = sequential_answers(port, bodies[:4])
            serve_ingest.launches = 0
            clients = Clients(port, f"/v1/models/{MODEL}/classify", bodies)
            try:
                # step 2: the classifier bias moved (every logit moves,
                # top-1 stays) rolls out on its own
                step2 = copy.deepcopy(step1)
                with torch.no_grad():
                    step2.fc.bias.add_(0.25)
                polls0 = deploy.watcher.stats()["polls"]
                t0 = time.monotonic()
                write_checkpoint(mdir, 2, step2)
                check(wait_for(lambda: deploy.watcher.stats()["deploys"]
                               >= 1, DEPLOY_TIMEOUT_S),
                      f"step 2 never deployed: {deploy.stats()}")
                rollout_s = time.monotonic() - t0
                polls = deploy.watcher.stats()["polls"] - polls0
                version = plane.models()[MODEL]["versions"][-1]
                check(version["state"] == "active" and version["step"] == 2
                      and version.get("shadow", {}).get("compared", 0)
                      >= 10 and version.get("canary", {}).get(
                          "requests", 0) >= 8 and polls >= 2,
                      f"step 2 reached {version} after {polls} polls")
                # step 3: a NaN in the classifier's weight matrix
                reloads = plane.stats()["plane"]["reloads"]
                step3 = copy.deepcopy(step2)
                with torch.no_grad():
                    step3.fc.weight.view(-1)[0] = float("nan")
                t0 = time.monotonic()
                write_checkpoint(mdir, 3, step3)
                check(wait_for(lambda: deploy.watcher.stats()
                               ["gate_failures"] >= 1, DEPLOY_TIMEOUT_S),
                      f"the NaN step was never gated: {deploy.stats()}")
                refuse_s = time.monotonic() - t0
                time.sleep(2 * DEPLOY_POLL_S)
                check(plane.stats()["plane"]["reloads"] == reloads
                      and plane.active_version(MODEL).version == 2,
                      "the NaN step started a reload or displaced v2")
            finally:
                clients.finish()
            codes = sorted({r["status"] for r in clients.replies})
            check(codes == [200], f"clients across the rollout: {codes}")
            launches = serve_ingest.launches
            v2 = sequential_answers(port, bodies[:4])
            check(v2 != v1, "step 2 answers as step 1")
            t0 = time.monotonic()
            status, rv, _ = post_any(port, b"{}",
                                     f"/v1/deploy/{MODEL}/revert")
            revert_s = time.monotonic() - t0
            check(status == 200 and rv["status"] == "reverted"
                  and rv["restores"] == 1, f"revert: {status} {rv}")
            check(sequential_answers(port, bodies[:4]) == v1,
                  "the reverted version answers otherwise than v1")
            outcomes = history_outcomes(port)
            want = ["candidate", "gate_passed", "promoted", "candidate",
                    "gate_failed", "reverted"]
            check(outcomes == want, f"ledger {outcomes}")
            entries = deploy.history.entries(MODEL)
            gate = next(e["gate"] for e in entries
                        if e["outcome"] == "gate_failed")
            ts = {e["outcome"]: e["ts"] for e in entries[:3]}
            out.update({
                "rollout_s": rollout_s, "polls_to_deploy": polls,
                "gate_pass_to_active_s": ts["promoted"] - ts["gate_passed"],
                "candidate_to_gate_s": ts["gate_passed"] - ts["candidate"],
                "shadow": version["shadow"], "canary": version["canary"],
                "nan_refused_s": refuse_s, "nan_gate": gate,
                "revert_s": revert_s, "client_requests": len(clients.replies),
                "launches": launches, "ledger": outcomes})
            log(f"deploy: {json.dumps(out)}")
        finally:
            deploy.stop()
            server.shutdown()
            plane.stop(drain_deadline=10.0)
        # a restart on the same workdir (the refused step taken away by
        # its operator) reads the same ledger back
        import shutil

        shutil.rmtree(os.path.join(mdir, "checkpoints", "3"))
        del plane, server
        torch.cuda.empty_cache()
        plane, server = boot_cli(argv)
        try:
            again = history_outcomes(server.port)
        finally:
            server.httpd.deploy.stop()
            server.shutdown()
            plane.stop(drain_deadline=10.0)
        check(again == outcomes, f"ledger after a restart {again}")
        out["ledger_after_restart"] = again
        del plane, server
        torch.cuda.empty_cache()
    return out


def prob_spread(refs: dict) -> float:
    """The card's own spread of a top-K answer's probabilities between
    the smallest bucket and the largest (1 and 32), over the entries
    whose class agrees."""
    spread = 0.0
    for a, b in zip(refs[min(refs)], refs[max(refs)]):
        for x, y in zip(a["top"], b["top"]):
            if x["class"] == y["class"]:
                spread = max(spread, abs(x["prob"] - y["prob"]))
    return spread


def topk_bucket(got: list, refs: dict, i: int, bound: float):
    """The first bucket whose direct answer for image ``i`` has the same
    top-K classes as ``got`` and probabilities within ``bound``."""
    for b, rows in refs.items():
        want = rows[i]["top"]
        if [t["class"] for t in want] == [t["class"] for t in got] and \
                max(abs(x["prob"] - y["prob"])
                    for x, y in zip(got, want)) <= bound:
            return b
    return None


def tier_batches(plane, names) -> int:
    """Executed batches summed over every version of every tier."""
    return sum(mv.engine.stats()["batches"] for n in names
               for mv in plane.versions(n))


def settled_launches(plane, names, batches0: int, extra: int = 0
                     ) -> tuple[int, int]:
    """``serve_ingest``'s launches and the tiers' executed batches since
    ``batches0``, read once they agree (launches = batches + ``extra``)
    or 30 s have passed: a dual-run sample's big-tier batch may still be
    running after its client's answer came back from the front."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    def read():
        return serve_ingest.launches, tier_batches(plane, names) - batches0

    def agree():
        launches, ran = read()
        return launches == ran + extra

    wait_for(agree, 30.0)
    return read()


def p50_ms(seconds: list):
    return sorted(seconds)[len(seconds) // 2] * 1e3 if seconds else None


def reload_under(port: int, plane, name: str, step: int, feed: list,
                 path: str) -> float:
    """``POST /v1/models/<name>/reload`` (force) while closed-loop
    clients run; ``feed`` bodies go one by one to ``path``, each made
    unique (a cache hit would starve the canary), until version ``step``
    is active.  Returns its seconds."""
    t0 = time.monotonic()
    status, blob, _, _ = post_h(port, json.dumps({"force": True}).encode(),
                                f"/v1/models/{name}/reload")
    check(status == 200 and json.loads(blob)["status"] == "reloading",
          f"reload {name}: {status} {blob[:200]}")
    k = 0
    while plane.active_version(name).version != step:
        check(time.monotonic() - t0 < CASCADE_TIMEOUT_S,
              f"{name} never reached version {step}: "
              f"{plane.versions(name)[-1].describe()}")
        if feed:
            r = post_h(port, feed[k % len(feed)][:-1]
                       + f', "feed": {k}}}'.encode(), path)
            check(r[0] == 200, f"{name}'s own route answered {r[0]}")
            k += 1
        else:
            time.sleep(0.02)
    return time.monotonic() - t0


def ledger_resets(root: str) -> list:
    """The reset records of the cascade's ledger, as (model, hop)."""
    out = []
    for path in os.listdir(root):
        with open(os.path.join(root, path), encoding="utf-8") as f:
            for line in f:
                rec = json.loads(line)
                if rec["event"] == "reset":
                    out.append((rec["model"], rec.get("hop")))
    return out


class DigestPlane:
    """The plane as a restarted router sees it, with tier ``changed``'s
    params digest moved (its weights changed while the router was down)
    or none (``None``).  It takes no version listener: the live router
    alone keeps the ledger."""

    def __init__(self, plane, changed: str):
        self.plane, self.changed = plane, changed

    def add_version_listener(self, fn):
        pass

    def resolve(self, name):
        import types

        m = self.plane.resolve(name)
        return types.SimpleNamespace(
            params_digest=m.params_digest + ("-new" if name == self.changed
                                             else ""),
            workload=m.workload)

    def canary_active(self, name):
        return False


def cascade_classify(workdir: str, card_line: str) -> dict:
    """The 3-tier ResNet cascade: calibration, always-big tenants,
    reloads under load, the ledger across a restart, launches, the
    brownout hooks with the router attached, and the controls."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest
    from deep_vision_tpu_torch.serve.cascade import CascadeRouter

    front, mid, big = CASCADE_TIERS
    for seed, name in enumerate(CASCADE_TIERS):
        write_checkpoint(os.path.join(workdir, name), 1,
                         seeded_classifier(70 + seed, name))
    t0 = time.monotonic()
    plane, server = boot_cli([
        "--models", ",".join(CASCADE_TIERS), "--workdir", workdir,
        "--cascade", ":".join(CASCADE_TIERS), "--cascade-quant-front",
        "--cascade-min-agreement", "0",
        "--cascade-sample-period", str(CASCADE_SAMPLE_PERIOD),
        "--cascade-min-sample", str(CASCADE_MIN_SAMPLE),
        "--cascade-topk", str(CASCADE_TOPK),
        "--wire-dtype", "uint8", "--infer-dtype", "bfloat16",
        "--port", "0", "--device", "cuda",
        "--max-batch", str(max(BUCKETS)),
        "--buckets", ",".join(map(str, BUCKETS)),
        "--canary-frac", "0.5", "--canary-min-requests", "4",
        "--canary-max-p99-ratio", "50", "--phase-timeout-s", "120",
        "--qos", CASCADE_QOS, "--brownout", "--brownout-force", "0",
        "--warmup"])
    out: dict = {"card": card_line, "boot_s": time.monotonic() - t0}
    port = server.port
    router = server.httpd.cascade
    path = f"/v1/models/{big}/classify"
    body = {"top_k": CASCADE_TOPK}
    try:
        fsm, bsm = plane.resolve(front), plane.resolve(big)
        check(fsm.infer_dtype == "int8" and fsm.cascade_topk == CASCADE_TOPK
              and plane.resolve(mid).cascade_topk == CASCADE_TOPK
              and bsm.cascade_topk == 0,
              "a tier's dtype or epilogue is not the cascade's")
        imgs = np.random.RandomState(71).randint(
            0, 256, (CASCADE_IMAGES, *bsm.input_shape), np.uint8)
        bodies = [json.dumps(dict(body, pixels=im.tolist())).encode()
                  for im in imgs]
        # the direct calls the answers are held against, made before the
        # launch count is set to 0
        big_refs = bucket_answers(bsm, imgs, body)
        front_refs = bucket_answers(fsm, imgs, body)
        spread = prob_spread(front_refs)
        fengine = plane.active_engine(front)
        f0 = fengine.stats()
        batches0 = tier_batches(plane, CASCADE_TIERS)
        serve_ingest.launches = 0

        # before calibration: every answer big, equal to a bucket call
        seq = [tier_reply(i, post_h(port, bodies[i], path))
               for i in range(CASCADE_SEQ)]
        for r in seq:
            check(r["status"] == 200 and r["tier"] == "big"
                  and any(rows[r["i"]] == r["body"]
                          for rows in big_refs.values()),
                  f"uncalibrated answer {r['i']}: {r['status']} "
                  f"{r['tier']}, equal to no bucket call of {big}")
        check(not any(h["calibrated"] for h in router.stats()["hops"]),
              "a hop calibrated within the first requests")

        # calibration under closed-loop clients: hop 0 flips to "front"
        clients = Clients(port, path, bodies, n=CASCADE_CLIENTS)
        try:
            t0 = time.monotonic()
            check(wait_for(lambda: router.hops[0].threshold is not None
                           and sum(r["tier"] == "front" for r in
                                   list(clients.replies)) >= 8,
                           CASCADE_TIMEOUT_S),
                  f"hop 0 never served: {router.stats()['served']}")
            out["calibrate_s"] = time.monotonic() - t0
        finally:
            clients.finish()
        f1 = fengine.stats()
        before = clients.replies  # the first front weights' answers
        forced = [tier_reply(i, post_h(port, bodies[i], path, PREMIUM))
                  for i in range(4)]
        check(all(r["status"] == 200 and r["tier"] == "big"
                  for r in forced), "an always-big tenant left big")
        # the ledger across a restart (at rest, every record of the
        # weights now served): a new router restores the live
        # thresholds, and refuses them once a tier's digest moved
        again = CascadeRouter(DigestPlane(plane, None), router.spec,
                              root=router._root)
        check([h.threshold for h in again.hops]
              == [h.threshold for h in router.hops] and again.restored,
              f"restored {[h.threshold for h in again.hops]}, live "
              f"{[h.threshold for h in router.hops]}")
        moved = CascadeRouter(DigestPlane(plane, big), router.spec,
                              root=router._root)
        check(not moved.restored and all(h.threshold is None
                                         for h in moved.hops),
              "a ledger of other weights was restored")
        out["ledger"] = {"restored_thresholds": [h.threshold
                                                 for h in again.hops],
                         "rejected_after_digest_change": True}

        clients = Clients(port, path, bodies, n=CASCADE_CLIENTS)
        try:
            # a reload of the front resets hop 0 alone; the traffic then
            # escalated through calibrates hop 1 to serve "t1"
            hop1 = router.hops[1].hist.stats()["samples"]
            write_checkpoint(os.path.join(workdir, front), 2,
                             seeded_classifier(80, front))
            out["front_reload_s"] = reload_under(port, plane, front, 2,
                                                 [], path)
            check(wait_for(lambda: ledger_resets(router._root)
                           == [(front, 0)]),
                  f"resets after the front reload: "
                  f"{ledger_resets(router._root)}")
            check(router.hops[1].hist.stats()["samples"] >= hop1,
                  "hop 1's sample did not survive the front reload")
            check(wait_for(lambda: any(r["tier"] == "t1" for r in
                                       list(clients.replies)),
                           CASCADE_TIMEOUT_S),
                  f"hop 1 never served: {router.stats()['hops']}")
            check(wait_for(lambda: router.hops[0].threshold is not None,
                           CASCADE_TIMEOUT_S), "hop 0 never recalibrated")
            # a reload of the mid tier resets hop 1 alone (its canary is
            # fed on its own route: a calibrated hop 0 lets little pass)
            write_checkpoint(os.path.join(workdir, mid), 2,
                             seeded_classifier(81, mid))
            out["mid_reload_s"] = reload_under(
                port, plane, mid, 2, bodies, f"/v1/models/{mid}/classify")
            check(wait_for(lambda: ledger_resets(router._root)
                           == [(front, 0), (mid, 1)]),
                  f"resets after the mid reload: "
                  f"{ledger_resets(router._root)}")
            check(router.hops[0].threshold is not None,
                  "the mid reload reset hop 0")
        finally:
            clients.finish()
        launches, ran = settled_launches(plane, CASCADE_TIERS, batches0,
                                         2 * len(BUCKETS))
        replies = seq + before + forced + clients.replies
        check(all(r["status"] == 200 for r in replies),
              f"client statuses: {sorted({r['status'] for r in replies})}")
        check(launches == ran + 2 * len(BUCKETS),
              f"serve_ingest launched {launches} times for {ran} batches "
              f"over the tiers and two reloads' {len(BUCKETS)} warmups")
        st = router.stats()
        check(st["escalated_error"] == 0,
              f"{st['escalated_error']} tier errors on a healthy card")
        check(st["served"]["front"] > 0 and st["served"]["t1"] > 0,
              f"served {st['served']}")
        # the first front version's answers against its direct calls,
        # its D2H, and the control: the same answers against big's calls
        fronts = [r for r in before if r["tier"] == "front"]
        hits = [topk_bucket(r["body"]["top"], front_refs, r["i"],
                            2 * spread) for r in fronts]
        check(fronts and all(h is not None for h in hits),
              f"{sum(h is None for h in hits)} of {len(fronts)} front "
              f"answers equal to no direct call of {front}")
        control = [r for r in fronts if not any(
            rows[r["i"]]["top"] == r["body"]["top"]
            for rows in big_refs.values())]
        check(2 * len(control) > len(fronts),
              f"front answers passed as {big}'s on "
              f"{len(fronts) - len(control)} of {len(fronts)} rows")
        copied = (f1["served"] - f0["served"]) \
            + (f1["padded_images"] - f0["padded_images"])
        d2h = f1["pipeline"]["d2h_bytes"] - f0["pipeline"]["d2h_bytes"]
        check(copied > 0 and d2h == copied * 3 * CASCADE_TOPK * 4,
              f"front D2H {d2h} B for {copied} padded images")
        out.update({
            "launches": launches, "batches": ran, "requests": len(replies),
            "served": st["served"], "escalation_rate": st["escalation_rate"],
            "escalated_lowconf": st["escalated_lowconf"],
            "escalated_error": st["escalated_error"],
            "samples": st["samples"], "calibrations": st["calibrations"],
            "resets": st["resets"], "forced_big": st["forced_big"],
            "thresholds": [h["threshold"] for h in st["hops"]],
            "client_p50_ms_by_tier": {
                t: p50_ms([r["s"] for r in before + clients.replies
                           if r["tier"] == t])
                for t in ("front", "t1", "big")},
            "front_d2h_bytes_per_image": d2h / copied,
            "front_prob_spread_b1_b32": spread,
            "front_answers_checked": len(fronts),
            "front_answers_by_bucket": {
                str(b): sum(h == b for h in hits) for b in BUCKETS},
            "control_front_vs_big_faults": len(control)})
        out["ledger"]["resets"] = ledger_resets(router._root)
        log(f"cascade: {json.dumps(out)}")
        out["brownout"] = cascade_brownout(port, router, bodies, path)
        out["control_epilogue_raises"] = epilogue_control(
            plane, port, router, bodies, path)
    finally:
        server.httpd.brownout.stop()
        server.shutdown()
        plane.stop(drain_deadline=10.0)
        del plane, server
        torch.cuda.empty_cache()
    return out


def cascade_brownout(port: int, router, bodies: list, path: str) -> dict:
    """The ladder pinned over HTTP with the router attached: L1 pauses
    the dual-run samples; L2 serves a hop below its threshold as
    ``front``, marked degraded, to a standard tenant and not to a
    premium one.  Seeded weights put the front's confidences where the
    calibrated threshold admits them, so the threshold is raised above
    every confidence by hand first."""
    st0 = router.stats()
    force_level(port, 1)
    l1 = [tier_reply(i, post_h(port, bodies[i], path))
          for i in range(2 * CASCADE_SAMPLE_PERIOD)]
    st1 = router.stats()
    check(all(r["status"] == 200 for r in l1)
          and st1["samples"] == st0["samples"]
          and st1["samples_paused"] > st0["samples_paused"],
          f"L1: samples {st0['samples']} → {st1['samples']}, paused "
          f"{st0['samples_paused']} → {st1['samples_paused']}")
    with router._lock:
        router.hops[0].threshold = 2.0
    force_level(port, 2)
    std = tier_reply(0, post_h(port, bodies[0], path))
    prem = tier_reply(0, post_h(port, bodies[0], path, PREMIUM))
    check(std["status"] == 200 and std["tier"] == "front"
          and std["degraded"] == "1", f"L2 standard: {std['tier']} "
                                      f"{std['degraded']}")
    check(prem["status"] == 200 and prem["tier"] == "big"
          and prem["degraded"] is None, f"L2 premium: {prem['tier']} "
                                        f"{prem['degraded']}")
    force_level(port, 0)
    _, blob = get_url(port, "/metrics")
    series = parse_metrics(blob.decode())
    for name in ("dvt_cascade_requests_total", "dvt_cascade_threshold",
                 "dvt_cascade_samples_paused_total",
                 "dvt_cascade_degraded_served_total",
                 "dvt_brownout_level", "dvt_brownout_transitions_total"):
        check(any(k.split("{")[0] == name for k in series),
              f"/metrics lacks {name}")
    st2 = router.stats()
    return {"samples_paused": st1["samples_paused"]
            - st0["samples_paused"],
            "degraded_served": st2["degraded_served"],
            "metrics_series": len(series)}


def epilogue_control(plane, port: int, router, bodies: list,
                     path: str) -> int:
    """Control: with the front tier's callables raising after their
    forward, its requests fail and the router escalates them as tier
    errors (the count a healthy run holds at 0), every answer still
    200 from big.  The front engine is left failed: this runs last."""
    front = CASCADE_TIERS[0]
    eng = plane.active_engine(front)

    def raising(fn):
        def call(x):
            fn(x)
            raise RuntimeError("control: the front tier's epilogue raised")
        return call

    for b, fn in list(eng._executables.items()):
        eng._executables[b] = raising(fn)
    err0 = router.stats()["escalated_error"]
    replies = [tier_reply(i, post_h(port, bodies[i], path))
               for i in range(2 * CASCADE_SAMPLE_PERIOD)]
    errors = router.stats()["escalated_error"] - err0
    check(errors > 0 and all(r["status"] == 200 and r["tier"] == "big"
                             for r in replies),
          f"a raising front: {errors} tier errors, "
          f"{[(r['status'], r['tier']) for r in replies]}")
    return errors


def cascade_detect(workdir: str, card_line: str) -> dict:
    """``yolov3_toy416:yolov3_coco``, both 416² int8 on the uint8 wire:
    the front's escalation signal is its device-decoded rows; every
    answer 200 with its tier; a front answer's kept set equals the
    front's direct call at one of the buckets; launches = batches."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    front, big = CASCADE_DETECT
    for seed, name in enumerate(CASCADE_DETECT):
        write_checkpoint(os.path.join(workdir, name), 1,
                         seeded_model(name, 90 + seed))
    t0 = time.monotonic()
    plane, server = boot_cli([
        "--models", ",".join(CASCADE_DETECT), "--workdir", workdir,
        "--cascade", ":".join(CASCADE_DETECT),
        "--cascade-min-agreement", "0",
        "--cascade-sample-period", str(CASCADE_SAMPLE_PERIOD),
        "--cascade-min-sample", str(CASCADE_DETECT_MIN_SAMPLE),
        "--wire-dtype", "uint8", "--infer-dtype", "int8",
        "--port", "0", "--device", "cuda",
        "--max-batch", str(max(BUCKETS)),
        "--buckets", ",".join(map(str, BUCKETS)), "--warmup"])
    out: dict = {"card": card_line, "boot_s": time.monotonic() - t0}
    port = server.port
    router = server.httpd.cascade
    path = f"/v1/models/{big}/detect"
    body = PLANE_BODY["detect"]
    try:
        fsm = plane.resolve(front)
        imgs = np.random.RandomState(91).randint(
            0, 256, (CASCADE_IMAGES, *fsm.input_shape), np.uint8)
        bodies = [json.dumps(dict(body, pixels=im.tolist())).encode()
                  for im in imgs]
        refs = bucket_answers(fsm, imgs, body)
        batches0 = tier_batches(plane, CASCADE_DETECT)
        serve_ingest.launches = 0
        seq = [tier_reply(i, post_h(port, bodies[i], path))
               for i in range(CASCADE_SEQ)]
        clients = Clients(port, path, bodies, n=CASCADE_CLIENTS)
        try:
            check(wait_for(lambda: sum(r["tier"] == "front" for r in
                                       list(clients.replies)) >= 8,
                           CASCADE_TIMEOUT_S),
                  f"the detect front never served: "
                  f"{router.stats()['served']}")
        finally:
            clients.finish()
        launches, ran = settled_launches(plane, CASCADE_DETECT, batches0)
        replies = seq + clients.replies
        check(all(r["status"] == 200 and r["tier"] in ("front", "big")
                  for r in replies),
              f"detect cascade answers: "
              f"{sorted({(r['status'], r['tier']) for r in replies})}")
        check(launches == ran, f"serve_ingest launched {launches} times "
                               f"for {ran} detect cascade batches")
        fronts = [r for r in replies if r["tier"] == "front"]
        kept = [next((b for b, rows in refs.items()
                      if answer_diff(r["body"], rows[r["i"]])[0]), None)
                for r in fronts]
        check(all(b is not None for b in kept),
              f"{sum(b is None for b in kept)} of {len(fronts)} front "
              f"detect answers kept another set than {front}'s calls")
        st = router.stats()
        check(st["escalated_error"] == 0,
              f"{st['escalated_error']} detect tier errors")
        out.update({
            "tiers": list(CASCADE_DETECT), "launches": launches,
            "batches": ran, "requests": len(replies), "served": st["served"],
            "escalation_rate": st["escalation_rate"],
            "thresholds": [h["threshold"] for h in st["hops"]],
            "front_detections": sum(r["body"]["num_detections"]
                                    for r in fronts),
            "front_answers_by_bucket": {str(b): sum(k == b for k in kept)
                                        for b in BUCKETS},
            "client_p50_ms_by_tier": {
                t: p50_ms([r["s"] for r in clients.replies
                           if r["tier"] == t]) for t in ("front", "big")}})
    finally:
        server.shutdown()
        plane.stop(drain_deadline=10.0)
        del plane, server
        torch.cuda.empty_cache()
    return out


def phase_cascade(card_line: str) -> dict:
    """The model cascade: the 3-tier ResNet classify chain at full width
    and the 416² detect lane."""
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as workdir:
        out["classify"] = cascade_classify(workdir, card_line)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as workdir:
        out["detect"] = cascade_detect(workdir, card_line)
        log(f"cascade detect: {json.dumps(out['detect'])}")
    return out


def ladder_level(port: int) -> dict:
    _, blob = get_url(port, "/v1/brownout")
    return json.loads(blob)


def herd_episode(port: int, bo, herd_path: str, path: str, herd: list,
                 repeat: bytes, hold_s: float, walk_down: bool) -> dict:
    """The brownout herd on ``herd_path`` and one premium client on
    ``path`` until ``hold_s`` after the ladder reaches L2; with
    ``walk_down``, until the moment it reads L2 or more again, and then
    the levels on the way down to L0, polled far faster than a release
    step (down_window ticks and the cooldown).  The requests in flight
    at the stop may still raise the ladder (its engage is fast); a rise
    after they are all answered is ``up_in_release``, and the release
    is the walk after the last rise.  Every body carries the herd's
    route, so no episode answers from another's cache entries."""
    def tag(b):
        return b[:-1] + f', "route": "{herd_path}"}}'.encode()

    t0 = time.monotonic()
    clients = Clients(port, herd_path, [tag(b) for b in herd],
                      n=BROWNOUT_HERD, unique=True, retry_s=BROWNOUT_RETRY_S)
    premium = Clients(port, path, [tag(repeat)], n=1, headers=PREMIUM,
                      unique=True)
    try:
        check(wait_for(lambda: bo.level >= 2, 60.0),
              f"the ladder never reached L2: {bo.stats()}")
        engage_s = time.monotonic() - t0
        time.sleep(hold_s)
        if walk_down:
            check(wait_for(lambda: bo.level >= 2, 30.0),
                  f"the ladder left L2 for good: {bo.stats()}")
        clients.stop.set()
        premium.stop.set()
        out = {"engage_s": engage_s, "overload_s": time.monotonic() - t0}
        # the load has stopped once every request in flight is answered;
        # until then the queue it left may still raise the ladder
        t0 = time.monotonic()
        drained = threading.Event()
        drain_s = []

        def drain():
            for t in clients.threads + premium.threads:
                t.join(60)
            drain_s.append(time.monotonic() - t0)
            drained.set()

        threading.Thread(target=drain, daemon=True).start()
        walk = [(bo.level, drained.is_set(), 0.0)]
        while walk_down and not (drained.is_set() and walk[-1][0] == 0):
            check(time.monotonic() - t0 < 60.0,
                  f"the ladder never released: {walk}, {bo.stats()}")
            level = bo.level
            if level != walk[-1][0]:
                walk.append((level, drained.is_set(),
                             time.monotonic() - t0))
            time.sleep(0.002)
        if walk_down:
            ups = [i for i in range(1, len(walk))
                   if walk[i][0] > walk[i - 1][0]]
            out.update({"drain_s": drain_s[0], "release_s": walk[-1][2],
                        "walk_from_stop": [lv for lv, _, _ in walk],
                        "walk_s": [s for _, _, s in walk],
                        "release_walk": [lv for lv, _, _ in
                                         walk[max(ups, default=0):]],
                        "up_while_draining": sum(not walk[i][1]
                                                 for i in ups),
                        "up_in_release": sum(walk[i][1] for i in ups)})
    finally:
        clients.finish()
        premium.finish()
    seconds = [r["s"] for r in premium.replies]
    return {**out, "standard_requests": len(clients.replies),
            "standard_shed_429": sum(r["status"] == 429
                                     for r in clients.replies),
            "standard_statuses": sorted({r["status"]
                                         for r in clients.replies}),
            "premium_requests": len(premium.replies),
            "premium_statuses": sorted({r["status"]
                                        for r in premium.replies}),
            "premium_p50_ms": p50_ms(seconds),
            "premium_max_ms": 1e3 * max(seconds, default=math.nan),
            "level_entries": bo.stats()["level_entries"]}


def phase_brownout(card_line: str) -> dict:
    """ResNet-50 int8 under ``--brownout``, ``--qos`` (premium and
    standard) and a response cache: an overload episode engages the
    ladder to L2 or more and releases it one level at a time; premium
    never sees a 5xx (and the same herd on the parse-first route is
    recorded beside it); at a forced L3 standard sheds and premium
    answers; at L2 after a reload a repeated payload answers the retired
    version's bytes, marked degraded; /metrics parses."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest
    from deep_vision_tpu_torch.serve.http import decode_pixels

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    out: dict = {"card": card_line}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as workdir:
        step1 = seeded_classifier(60)
        write_checkpoint(os.path.join(workdir, MODEL), 1, step1)
        t0 = time.monotonic()
        plane, server = boot_cli([
            "--models", MODEL, "--workdir", workdir, "--wire-dtype",
            "uint8", "--infer-dtype", "int8", "--port", "0", "--device",
            "cuda", "--max-batch", "1", "--buckets", "1",
            "--faults", BROWNOUT_FAULT, "--qos", CASCADE_QOS,
            "--response-cache-mb", "64", "--canary-frac", "1.0",
            "--canary-min-requests", "2", "--canary-max-p99-ratio", "50",
            "--phase-timeout-s", "120", *BROWNOUT_FLAGS, "--warmup"])
        out["boot_s"] = time.monotonic() - t0
        port = server.port
        bo = server.httpd.brownout
        path = f"/v1/models/{MODEL}/classify"
        try:
            rng = np.random.RandomState(61)
            imgs = rng.randint(0, 256, (BROWNOUT_HERD + 1,
                                        *plane.resolve(MODEL).input_shape),
                               np.uint8)
            bodies = [json.dumps({"pixels": im.tolist(), "top_k": 5}
                                 ).encode() for im in imgs]
            repeat, herd = bodies[-1], bodies[:-1]
            batches0 = tier_batches(plane, [MODEL])
            serve_ingest.launches = 0
            first = post_h(port, repeat, path)
            hit = post_h(port, repeat, path)
            check(first[0] == 200 and hit[2].get("X-DVT-Cache") == "hit"
                  and hit[1] == first[1], "the repeated payload missed")

            # one herd body's JSON parse and pixel decode on the card
            # host's interpreter: what the path form no longer spends on a
            # request it sheds
            parse_s, decode_s = [], []
            for b in herd * 2:
                t1 = time.perf_counter()
                parsed = json.loads(b)
                t2 = time.perf_counter()
                decode_pixels(parsed, plane.resolve(MODEL))
                parse_s.append(t2 - t1)
                decode_s.append(time.perf_counter() - t2)
            out["host_parse_ms"] = p50_ms(parse_s)
            out["host_decode_ms"] = p50_ms(decode_s)
            out["body_bytes"] = len(herd[0])

            # an overload episode on the path form, which sheds before it
            # parses: the ladder engages to L2 or more, premium sees no
            # 5xx, and from L2 or more the ladder steps down to L0 one
            # level at a time once the load stops
            check(ladder_level(port)["level"] == 0, "the ladder is up idle")
            ep = herd_episode(port, bo, path, path, herd, repeat,
                              BROWNOUT_EPISODE_S, walk_down=True)
            log(f"brownout episode: {json.dumps(ep)}")
            walk = ep["release_walk"]
            check(walk[0] >= 2 and len(walk) >= 3 and ep["up_in_release"] == 0
                  and all(a - b == 1 for a, b in zip(walk, walk[1:])),
                  f"the release went {walk} (from the stop "
                  f"{ep['walk_from_stop']}), {ep['up_in_release']} up "
                  f"once drained")
            check(all(c in (200, 429) for c in ep["standard_statuses"]),
                  f"standard during the episode: {ep['standard_statuses']}")
            check(ep["premium_statuses"] == [200]
                  and ep["premium_requests"] >= 2,
                  f"premium during the episode: {ep['premium_requests']} "
                  f"answers, {ep['premium_statuses']}")
            out["episode"] = ep
            # the recorded control: the same herd on /v1/classify, which
            # names its model in the body and so parses before it sheds
            # (the reference's order on every route); premium as above
            out["control_parse_first"] = herd_episode(
                port, bo, "/v1/classify", path, herd, repeat,
                BROWNOUT_CONTROL_S, walk_down=False)
            log(f"brownout control: {json.dumps(out['control_parse_first'])}")

            # pinned L2 then L3 under the herd: premium's latency at each,
            # and at L3 standard sheds while premium answers
            clients = Clients(port, path, herd, n=BROWNOUT_HERD,
                              unique=True, retry_s=BROWNOUT_RETRY_S)
            pinned = {}
            try:
                for level in (2, 3):
                    force_level(port, level)
                    time.sleep(0.3)
                    rs = [tier_reply(0, post_h(
                        port, repeat[:-1] + f', "q": {level * 10 + k}}}'
                        .encode(), path, PREMIUM)) for k in range(5)]
                    std = [tier_reply(0, post_h(
                        port, repeat[:-1] + f', "s": {level * 10 + k}}}'
                        .encode(), path)) for k in range(3)]
                    check(all(r["status"] == 200 for r in rs),
                          f"premium at L{level}: "
                          f"{[r['status'] for r in rs]}")
                    want = 429 if level == 3 else 200
                    check(all(r["status"] == want for r in std),
                          f"standard at L{level}: "
                          f"{[r['status'] for r in std]}")
                    pinned[f"L{level}"] = {
                        "premium_p50_ms": p50_ms([r["s"] for r in rs]),
                        "standard_statuses": [r["status"] for r in std]}
            finally:
                clients.finish()
            force_level(port, None)
            check(wait_for(lambda: bo.level == 0, 60.0),
                  f"the ladder never released after the pin: {bo.stats()}")
            check(all(r["status"] in (200, 429) for r in clients.replies),
                  "standard under the pinned levels saw an error")
            out["pinned"] = pinned

            # a reload, then at L2 the repeated payload answers the
            # retired version's bytes, marked degraded
            step2 = copy.deepcopy(step1)
            with torch.no_grad():
                step2.fc.bias.add_(0.25)
            write_checkpoint(os.path.join(workdir, MODEL), 2, step2)
            feed = [b[:-1] + b', "r": 1}' for b in herd]
            out["reload_s"] = reload_under(port, plane, MODEL, 2, feed, path)
            force_level(port, 2)
            stale = post_h(port, repeat, path)
            force_level(port, 0)
            fresh = post_h(port, repeat, path)
            force_level(port, None)
            check(stale[0] == 200 and stale[2].get("X-DVT-Degraded") == "1"
                  and stale[2].get("X-DVT-Cache") == "hit"
                  and stale[1] == first[1],
                  f"the stale answer: {stale[0]} {stale[2]}")
            check(fresh[0] == 200 and "X-DVT-Degraded" not in fresh[2]
                  and fresh[1] != first[1], "the answer at L0 after the "
                                            "reload is not the new one")
            launches = serve_ingest.launches
            ran = tier_batches(plane, [MODEL]) - batches0
            check(launches == ran + 1, f"serve_ingest launched {launches} "
                                       f"times for {ran} batches and one "
                                       f"reload warmup")
            _, blob = get_url(port, "/metrics")
            series = parse_metrics(blob.decode())
            for name in ("dvt_brownout_level", "dvt_brownout_pressure_ms",
                         "dvt_brownout_level_entries_total",
                         "dvt_brownout_transitions_total",
                         "dvt_serve_cache_stale_hits_total"):
                check(any(k.split("{")[0] == name for k in series),
                      f"/metrics lacks {name}")
            rc = json.loads(get_url(port, "/v1/stats")[1])["response_cache"]
            check(rc["stale_hits"] == 1, f"stale hits {rc['stale_hits']}")
            out.update({"launches": launches, "batches": ran,
                        "stale_hit": True, "ladder": bo.stats()})
            log(f"brownout: {json.dumps(out)}")
        finally:
            bo.stop()
            server.shutdown()
            plane.stop(drain_deadline=10.0)
        del plane, server
        torch.cuda.empty_cache()
    return out


class BackendProcess:
    """One ``python -m deep_vision_tpu_torch.cli.serve`` child process:
    its listening port is read off the URL line it prints at boot, its
    stderr goes to ``log_path``."""

    URL_RE = re.compile(r"http://[^\s/:]+:(\d+)/v1/")

    def __init__(self, workdir: str, log_path: str, *extra):
        argv = [sys.executable, "-m", "deep_vision_tpu_torch.cli.serve",
                "-m", MODEL, "--workdir", workdir, "--wire-dtype", "uint8",
                "--infer-dtype", "int8", "--warmup",
                "--response-cache-mb", "64", "--port", "0",
                "--device", GATEWAY_DEVICE,
                "--max-batch", str(max(BUCKETS)),
                "--buckets", ",".join(map(str, BUCKETS)), *extra]
        self.log_path = log_path
        self.started = time.monotonic()
        self.boot_s: float | None = None
        self.port: int | None = None
        self._err = open(log_path, "w")
        self.proc = subprocess.Popen(
            argv, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=self._err, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            m = self.URL_RE.search(line)
            if m and self.port is None:
                self.port = int(m.group(1))
                self.boot_s = time.monotonic() - self.started

    def wait_ready(self, timeout: float = GATEWAY_BOOT_TIMEOUT_S) -> int:
        wait_for(lambda: self.port is not None
                 or self.proc.poll() is not None, timeout)
        if self.port is None:
            self.stop()
            with open(self.log_path) as f:
                tail = f.read()[-3000:]
            check(False, f"cli.serve did not come up (exit "
                         f"{self.proc.poll()}):\n{tail}")
        return self.port

    @property
    def url(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stats(self) -> dict:
        return json.loads(get_url(self.port, "/v1/stats")[1])

    def stop(self, sig: str = "terminate") -> None:
        if self.proc.poll() is None:
            getattr(self.proc, sig)()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self._reader.join(5)
        self._err.close()


def backend_counts(bp: BackendProcess) -> dict:
    """One backend's serve_ingest launches, executed batches, health and
    edge counters from its own ``/v1/stats``."""
    s = bp.stats()
    eng = s[MODEL]
    return {"launches": s["kernels"]["serve_ingest"],
            "batches": eng["batches"], "served": eng["served"],
            "retry_executions": eng["health"]["retry_executions"],
            "batch_failures": eng["health"]["batch_failures"],
            "edge": s["edge"]}


def http_status(port: int, path: str) -> tuple[int, dict]:
    try:
        status, blob = get_url(port, path)
    except urllib.error.HTTPError as e:
        status, blob = e.code, e.read()
    return status, json.loads(blob)


def exact_replies(replies, idx: list, refs: dict) -> list:
    """``exact_buckets`` for replies to the images at ``idx``."""
    sub = {b: [rows[i] for i in idx] for b, rows in refs.items()}
    return exact_buckets(replies, sub)[1]


def launches_match(before: dict, after: dict, what: str) -> int:
    """Each backend's serve_ingest launches rose by its executed batches
    (on the card; the plain version on the CPU launches nothing)."""
    ran = after["batches"] - before["batches"]
    launched = after["launches"] - before["launches"]
    want = ran if GATEWAY_DEVICE.startswith("cuda") else 0
    check(launched == want, f"{what}: serve_ingest launched {launched} "
                            f"times for {ran} batches")
    return launched


def build_gateway_cli(argv: list):
    """``cli/gateway.py``'s ``build_gateway`` on ``argv``, started."""
    from deep_vision_tpu_torch.cli import gateway as cli

    gw, server = cli.build_gateway(cli.build_parser().parse_args(
        ["--port", "0", "--probe-interval-ms", str(GATEWAY_PROBE_MS),
         *argv]))
    server.start_background()
    return gw, server


def gateway_healthz(server) -> int:
    return http_status(server.port, "/v1/healthz")[0]


def phase_gateway(card_line: str) -> dict:
    """Two ``cli.serve`` processes (ResNet-50 int8 from one seeded port
    checkpoint, the default edge, backend 0 with one injected compute
    exception) behind ``cli.gateway``'s ``build_gateway``: answers equal
    to the bucket callable at a bucket through the gateway, launches =
    batches in each backend, keep-alive reuse, a SIGKILL of backend 1
    under 4 closed-loop clients losing nothing, affinity over a restarted
    backend 1 (one batch for 8 repeats), ``gateway:conn_reset`` absorbed
    by retries, and a drain turning the gateway's healthz 503."""
    import torch

    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    t_phase = time.monotonic()
    body = {"top_k": 5}
    out: dict = {"card": card_line}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    procs: list = []
    gateways: list = []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        workdir = os.path.join(tmp, MODEL)
        write_checkpoint(workdir, 1, seeded_classifier(7))
        try:
            # both backends boot cold, in parallel, while this process
            # computes the reference answers
            procs += [BackendProcess(workdir, os.path.join(tmp, "b0.log"),
                                     "--faults", GATEWAY_FAULT),
                      BackendProcess(workdir, os.path.join(tmp, "b1.log"))]
            registry = ModelRegistry()
            sm = registry.load_checkpoint(MODEL, workdir=workdir,
                                          wire_dtype="uint8",
                                          infer_dtype="int8",
                                          device=FLEET_DEVICE)
            n_img = GATEWAY_N + 1 + 2 * GATEWAY_HOP_N
            imgs = np.random.RandomState(50).randint(
                0, 256, (n_img, *sm.input_shape), np.uint8)
            refs = bucket_answers(sm, imgs, body)
            del sm, registry
            torch.cuda.empty_cache()
            bodies = [json.dumps({"pixels": im.tolist(), **body}).encode()
                      for im in imgs]
            for bp in procs:
                bp.wait_ready()
            out["backend_boot_s"] = [bp.boot_s for bp in procs]
            b0, b1 = procs
            gw, gsrv = build_gateway_cli(["--backend", b0.url,
                                          "--backend", b1.url])
            gateways.append((gw, gsrv))
            gport = gsrv.port
            direct = 0  # this script's own connections to the backends
            base = [backend_counts(bp) for bp in procs]
            direct += 2
            # 1. answers: 8 sequential, then 24 concurrent
            replies = drive(gport, bodies[:GATEWAY_N], GATEWAY_N_SEQ)
            faults = exact_replies(replies, list(range(GATEWAY_N)), refs)
            check(not faults, f"gateway answers: {faults[:5]}")
            after = [backend_counts(bp) for bp in procs]
            direct += 2
            served = [a["served"] - b["served"]
                      for a, b in zip(after, base)]
            check(all(s > 0 for s in served) and sum(served) == GATEWAY_N,
                  f"served by each backend {served}")
            answers_launches = [launches_match(b, a, f"backend {i}")
                                for i, (b, a) in enumerate(zip(base,
                                                               after))]
            check(after[0]["retry_executions"] >= 1
                  and after[0]["batch_failures"] >= 1,
                  f"backend 0's injected exception was not retried: "
                  f"{after[0]}")
            reports = gw.healthz()[1]["backends"]
            out["answers"] = {
                "requests": GATEWAY_N, "served": served,
                "launches": answers_launches,
                "batches": [a["batches"] - b["batches"]
                            for a, b in zip(after, base)],
                "retry_executions": after[0]["retry_executions"],
                "gateway_successes": [reports[bp.url]["successes"]
                                      for bp in procs]}
            log(f"gateway answers: {json.dumps(out['answers'])}")

            # 2. keep-alive: the gateway's pools reuse backend sockets
            keep = []
            for bp, a in zip(procs, after):
                rep = reports[bp.url]
                edge = a["edge"]
                bound = rep["conns"]["created"] + rep["probes"] + direct
                check(edge["keepalive_reuses"] > 0,
                      f"{bp.url}: no keep-alive reuse {edge}")
                check(edge["accepted"] <= bound,
                      f"{bp.url}: accepted {edge['accepted']} > pool "
                      f"{rep['conns']['created']} + probes "
                      f"{rep['probes']} + direct {direct}")
                keep.append({"accepted": edge["accepted"],
                             "keepalive_reuses": edge["keepalive_reuses"],
                             "pool_created": rep["conns"]["created"],
                             "pool_reused": rep["conns"]["reused"],
                             "probes": rep["probes"]})
            out["keepalive"] = keep
            log(f"gateway keep-alive: {json.dumps(keep)}")

            # the hop's cost: bucket-1 requests of fresh images through
            # the gateway and straight to backend 0 (information only)
            hop0 = GATEWAY_N + 1
            via = [post_any(gport, bodies[i])
                   for i in range(hop0, hop0 + GATEWAY_HOP_N)]
            straight = [post_any(b0.port, bodies[i])
                        for i in range(hop0 + GATEWAY_HOP_N,
                                       hop0 + 2 * GATEWAY_HOP_N)]
            direct += GATEWAY_HOP_N
            hop_faults = exact_replies(
                [r for r in via + straight],
                list(range(hop0, hop0 + 2 * GATEWAY_HOP_N)), refs)
            check(not hop_faults, f"hop answers: {hop_faults[:5]}")
            out["hop"] = {"gateway_p50_ms": p50_ms([r[2] for r in via]),
                          "direct_p50_ms": p50_ms([r[2] for r in straight])}
            before_kill = [backend_counts(bp) for bp in procs]
            direct += 2
            for i, (b, a) in enumerate(zip(after, before_kill)):
                launches_match(b, a, f"backend {i} over the hop")

            # 3. SIGKILL backend 1 under 4 closed-loop clients
            stop = threading.Event()
            lock = threading.Lock()
            kill_replies: list = []
            errors: list = []

            def client(k):
                i = k
                while not stop.is_set():
                    j = i % GATEWAY_N
                    try:
                        status, got, _ = post_any(gport, bodies[j])
                        with lock:
                            kill_replies.append((j, (status, got, 0.0)))
                    except Exception as e:  # noqa: BLE001 — a lost request
                        with lock:
                            errors.append(repr(e))
                    i += GATEWAY_CLIENTS

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(GATEWAY_CLIENTS)]
            for t in threads:
                t.start()
            wait_for(lambda: len(kill_replies) >= 8, 60)
            t_kill = time.monotonic()
            b1.proc.kill()
            routed_off = wait_for(lambda: not gw.backends[1].routable(), 10)
            kill_ms = (time.monotonic() - t_kill) * 1e3
            breaker = gw.backends[1].report()
            restart = BackendProcess(workdir, os.path.join(tmp, "b1r.log"))
            procs.append(restart)
            time.sleep(GATEWAY_KILL_TAIL_S)
            stop.set()
            for t in threads:
                t.join(120)
            b1.stop("kill")
            check(routed_off, "the gateway still routes to the killed "
                              "backend 10 s after the SIGKILL")
            check(breaker["breaker"] == "open"
                  and breaker["breaker_opens"] >= 1,
                  f"killed backend's breaker: {breaker['breaker']}, "
                  f"opens {breaker['breaker_opens']}")
            check(not errors, f"requests lost to the SIGKILL: {errors[:3]}")
            kill_faults = exact_replies([r for _, r in kill_replies],
                                        [j for j, _ in kill_replies], refs)
            check(not kill_faults, f"answers under the SIGKILL: "
                                   f"{kill_faults[:5]}")
            check(gateway_healthz(gsrv) == 200,
                  "gateway healthz is not 200 with one backend alive")
            after_kill = backend_counts(b0)
            direct += 1
            out["sigkill"] = {
                "requests": len(kill_replies), "errors": len(errors),
                "kill_to_unroutable_ms": kill_ms,
                "breaker_opens": breaker["breaker_opens"],
                "failovers": gw.counters()["failovers"],
                "retries": gw.counters()["retries"],
                "launches_b0": launches_match(before_kill[0], after_kill,
                                              "backend 0 under the kill"),
                "launches_b1_before_kill": before_kill[1]["launches"]
                - base[1]["launches"]}
            log(f"gateway sigkill: {json.dumps(out['sigkill'])}")

            # 4. affinity over the survivor and a restarted backend 1
            b1r = restart
            b1r.wait_ready()
            out["restart_boot_s"] = b1r.boot_s
            agw, agsrv = build_gateway_cli(["--backend", b0.url,
                                            "--backend", b1r.url,
                                            "--affinity"])
            gateways.append((agw, agsrv))
            pre = [backend_counts(bp) for bp in (b0, b1r)]
            direct += 2
            aff = GATEWAY_N  # a payload no backend has seen
            aff_replies = [post_h(agsrv.port, bodies[aff], "/v1/classify")
                           for _ in range(GATEWAY_AFFINITY_REPEATS)]
            post = [backend_counts(bp) for bp in (b0, b1r)]
            direct += 2
            check(all(r[0] == 200 for r in aff_replies),
                  f"affinity statuses {[r[0] for r in aff_replies]}")
            answers = [json.loads(r[1]) for r in aff_replies]
            check(all(a == answers[0] for a in answers)
                  and any(answers[0] == rows[aff] for rows in refs.values()),
                  "affinity answers differ from each other or from every "
                  "bucket's")
            hits = sum(r[2].get("X-DVT-Cache") == "hit" for r in aff_replies)
            served_aff = [a["served"] - b["served"]
                          for a, b in zip(post, pre)]
            launched = [a["launches"] - b["launches"]
                        for a, b in zip(post, pre)]
            ran = [a["batches"] - b["batches"] for a, b in zip(post, pre)]
            home = int(np.argmax(served_aff))
            per_launch = 1 if GATEWAY_DEVICE.startswith("cuda") else 0
            check(served_aff[1 - home] == 0 and ran[1 - home] == 0
                  and launched[1 - home] == 0,
                  f"affinity reached both backends: served {served_aff}, "
                  f"launches {launched}")
            check(ran[home] == 1 and launched[home] == per_launch
                  and hits == GATEWAY_AFFINITY_REPEATS - 1,
                  f"affinity: {ran[home]} batches, {launched[home]} "
                  f"launches, {hits} cache hits for "
                  f"{GATEWAY_AFFINITY_REPEATS} repeats")
            succ = [agw.backends[i].report()["successes"] for i in (0, 1)]
            check(succ[home] == GATEWAY_AFFINITY_REPEATS
                  and succ[1 - home] == 0, f"affinity routed {succ}")
            out["affinity"] = {"home": ["b0", "b1_restarted"][home],
                               "batches": ran, "launches": launched,
                               "cache_hits": hits}
            log(f"gateway affinity: {json.dumps(out['affinity'])}")

            # 5. network faults between gateway and backends
            fgw, fgsrv = build_gateway_cli(["--backend", b0.url,
                                            "--backend", b1r.url,
                                            "--faults", GATEWAY_NET_FAULT,
                                            "--fault-seed",
                                            str(GATEWAY_NET_SEED)])
            gateways.append((fgw, fgsrv))
            net = [post_h(fgsrv.port, bodies[i], "/v1/classify")
                   for i in range(GATEWAY_NET_N)]
            check(all(r[0] == 200 for r in net),
                  f"conn_reset statuses {[r[0] for r in net]}")
            net_faults = exact_replies(
                [(r[0], json.loads(r[1]), 0.0) for r in net],
                list(range(GATEWAY_NET_N)), refs)
            check(not net_faults, f"conn_reset answers: {net_faults[:5]}")
            check(all("X-DVT-Retry-Budget" in r[2] for r in net),
                  "an answer lacks X-DVT-Retry-Budget")
            fc = fgw.counters()
            fired = fgw.faults.stats()
            check(fc["retries"] >= 1, f"conn_reset: no retries {fc}")
            out["conn_reset"] = {"requests": GATEWAY_NET_N,
                                 "retries": fc["retries"],
                                 "failovers": fc["failovers"],
                                 "faults": fired}
            log(f"gateway conn_reset: {json.dumps(out['conn_reset'])}")
            final = [backend_counts(bp) for bp in (b0, b1r)]
            for i, (b, a) in enumerate(zip(post, final)):
                launches_match(b, a, f"backend {i} under conn_reset")
            launches_match(after_kill, pre[0], "backend 0 across the "
                                               "restart")
            # every launch this phase's traffic made, each window held to
            # its batches above: backend 0 throughout, backend 1 until the
            # kill (its last moments die with it), the restarted one after
            # its warmup
            out["launches"] = (
                launches_match(base[0], final[0], "backend 0 in all")
                + before_kill[1]["launches"] - base[1]["launches"]
                + final[1]["launches"] - pre[1]["launches"])

            # 6. drain every live backend: healthz 503, then the gateway's
            for bp in (b0, b1r):
                status, blob, _, _ = post_h(
                    bp.port, json.dumps({"drain_deadline_s": 10}).encode(),
                    "/v1/drain")
                check(status == 200 and json.loads(blob)["status"]
                      == "draining", f"drain {bp.url}: {status}")
                status, doc = http_status(bp.port, "/v1/healthz")
                check(status == 503 and doc["status"] == "draining",
                      f"{bp.url} healthz after drain: {status} {doc}")
            t_drain = time.monotonic()
            check(wait_for(lambda: gateway_healthz(agsrv) == 503,
                           20 * GATEWAY_PROBE_MS / 1e3),
                  "the gateway's healthz is not 503 after every backend "
                  "drained")
            out["drain_to_503_ms"] = (time.monotonic() - t_drain) * 1e3
        finally:
            for gw_, srv_ in gateways:
                srv_.shutdown()
                gw_.stop()
            for bp in procs:
                bp.stop()
        # 7. every backend process reaped, and off the card
        check(all(bp.proc.poll() is not None for bp in procs),
              "a backend process outlived the phase")
        pids = {bp.proc.pid for bp in procs}
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split() \
            if GATEWAY_DEVICE.startswith("cuda") else []
        check(not pids & {int(p) for p in apps if p.isdigit()},
              f"backend processes still on the card: {apps}")
    out["phase_s"] = time.monotonic() - t_phase
    log(f"gateway ({card_line}): boot {out['backend_boot_s']} s, restart "
        f"{out['restart_boot_s']:.1f} s, p50 via gateway "
        f"{out['hop']['gateway_p50_ms']:.2f} ms vs direct "
        f"{out['hop']['direct_p50_ms']:.2f} ms, kill -> unroutable "
        f"{out['sigkill']['kill_to_unroutable_ms']:.0f} ms, reused "
        f"{[k['keepalive_reuses'] for k in out['keepalive']]}, "
        f"{out['phase_s']:.1f} s")
    return out


def batch_argv(workdir: str, jobs_dir: str) -> list:
    """``cli.serve`` of the batch phase: ResNet-50 int8 on the uint8 wire
    from the port checkpoint in ``workdir``, buckets 1-32 warmed, the
    batch tier's ledger in ``jobs_dir``."""
    return ["-m", MODEL, "--workdir", workdir, "--wire-dtype", "uint8",
            "--infer-dtype", "int8", "--port", "0", "--device",
            BATCH_DEVICE, "--max-batch", str(max(BUCKETS)),
            "--buckets", ",".join(map(str, BUCKETS)), "--warmup",
            "--jobs-dir", jobs_dir, *BATCH_FLAGS]


def manifest_blob(items: list) -> bytes:
    """A ``POST /v1/jobs`` body of manifest ``items``, encoded."""
    return json.dumps({"items": items}).encode()


def submit_job(port: int, blob: bytes) -> tuple[dict, float]:
    """POST a job body → (its 202 handle, seconds)."""
    status, raw, _, s = post_h(port, blob, "/v1/jobs")
    check(status == 202, f"POST /v1/jobs answered {status}: {raw[:300]!r}")
    return json.loads(raw), s


def job_state(port: int, jid: str) -> dict:
    return json.loads(get_url(port, f"/v1/jobs/{jid}")[1])


def wait_job(port: int, jid: str, what: str) -> dict:
    """Poll a job until it is done (fail on failed or on the timeout)."""
    t_end = time.monotonic() + BATCH_TIMEOUT_S
    st = job_state(port, jid)
    while st["state"] not in ("done", "failed") \
            and time.monotonic() < t_end:
        time.sleep(0.01)
        st = job_state(port, jid)
    check(st["state"] == "done", f"{what}: the job ended {st}")
    return st


def stream_rows(port: int, jid: str, n: int, what: str) -> list:
    """``GET /v1/jobs/<id>/results``: chunked, indices 0..n-1 each once
    and in order, then a ``done`` status line; returns the rows."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/jobs/{jid}/results",
            timeout=300) as r:
        te = r.headers.get("Transfer-Encoding")
        lines = [json.loads(ln) for ln in r.read().splitlines()]
    check(te == "chunked", f"{what}: results sent with Transfer-Encoding "
                           f"{te}")
    idx = [ln.get("index") for ln in lines[:-1]]
    check(idx == list(range(n)), f"{what}: streamed {len(idx)} indices, "
                                 f"not 0..{n - 1} in order: {idx[:8]}")
    check((lines[-1].get("status") or {}).get("state") == "done",
          f"{what}: the stream ended {lines[-1]}")
    return lines[:-1]


def bucket_logits(sm, imgs: np.ndarray, bucket: int) -> np.ndarray:
    """The served model's own bucket callable (the ``serve_ingest``
    kernel, the forward, float32 logits) in batches of ``bucket``, zero
    padded: one logits row an image."""
    fn = sm.compile_bucket(bucket)
    out = []
    for i in range(0, len(imgs), bucket):
        chunk = imgs[i:i + bucket]
        batch = np.zeros((bucket, *sm.input_shape), np.uint8)
        batch[:len(chunk)] = chunk
        out.append(fn(batch).float().cpu().numpy()[:len(chunk)])
    return np.concatenate(out)


def top5_faults(rows: list, refs: dict) -> list[str]:
    """Each row's top-5 against the direct logits of its image in each of
    ``refs`` (one array a bucket, or a control): a row holds when, for
    one of them, every served logit lies within the serving bound
    (3e-2·max|ref|) of the direct logit of its class, with top-1 equal
    where the direct margin exceeds the bound.  One fault a row that
    holds for none."""
    bounds = {k: BF16_BOUND * float(np.abs(r).max()) for k, r in refs.items()}
    faults = []
    for i, row in enumerate(rows):
        top = row.get("top") or []
        classes = [t["class"] for t in top]
        logits = np.array([t["logit"] for t in top], np.float64)
        if len(top) != 5 or not np.isfinite(logits).all():
            faults.append(f"row {i}: {len(top)} classes, finite "
                          f"{bool(np.isfinite(logits).all())}")
            continue
        held = False
        for k, ref in refs.items():
            r = ref[i]
            top2 = np.sort(r)[-2:]
            if float(np.abs(logits - r[classes]).max()) <= bounds[k] and (
                    top2[1] - top2[0] <= bounds[k]
                    or classes[0] == int(r.argmax())):
                held = True
                break
        if not held:
            faults.append(f"row {i}: top-5 {classes} held by no direct call")
    return faults


def p99_s(seconds: list) -> float:
    """The reference test's p99: the sorted sample at ⌊0.99·n⌋ − 1."""
    return sorted(seconds)[max(0, int(len(seconds) * 0.99) - 1)]


def stop_server(engine, server) -> None:
    """``cli.serve``'s shutdown order: the batch scheduler and the
    ladder, then the server, then the engine; once a server."""
    if getattr(server, "stopped", False):
        return
    server.stopped = True
    srv = server.httpd
    if srv.batch_sched is not None:
        srv.batch_sched.stop()
    if srv.brownout is not None:
        srv.brownout.stop()
    server.shutdown()
    engine.stop(drain_deadline=10.0)


def batch_drain(port: int, engine, imgs: np.ndarray, bodies: list
                ) -> tuple[dict, list]:
    """Check 1: a job of ``BATCH_DRAIN_SHARDS`` shards drains while
    ``BATCH_CLIENTS`` closed-loop clients send bucket-1 requests (after a
    baseline of the same clients alone); every interactive answer is
    200, the job is done before they stop, the stream is whole.

    The baseline runs with the ladder free, and the level it reached and
    its signals are recorded (``ladder_unpinned``); the drain runs with
    the ladder pinned at L0.  These clients alone hold the interpreter,
    which stretches every batch's measured execution (the engine's exec
    EWMA and occupancy are wall time from dispatch to the drained
    result), so the free ladder climbs and would freeze the tier for as
    long as they run.  The signals it reads under the pin are recorded
    too (``ladder_signals``)."""
    base = Clients(port, "/v1/classify", bodies, n=BATCH_CLIENTS)
    check(wait_for(lambda: len(base.replies)
                   >= BATCH_CLIENTS * BATCH_BASE_N, 120.0),
          "the baseline clients never finished")
    free = json.loads(get_url(port, "/v1/brownout")[1])
    base_ewma = engine.stats()["admission"]["exec_ewma_ms_by_bucket"]
    base.finish()
    force_level(port, 0)
    n = len(imgs)
    blob = manifest_blob([{"pixels": im.tolist()} for im in imgs])
    t0 = time.perf_counter()
    json.loads(blob)
    parse_s = time.perf_counter() - t0
    clients = Clients(port, "/v1/classify", bodies, n=BATCH_CLIENTS)
    try:
        view, post_s = submit_job(port, blob)
        # the answers before the 202 waited on the POST's own parse and
        # the job record's append, each one call that holds the
        # interpreter for seconds; the drain's own answers come after it
        at_202 = len(clients.replies)
        t0 = time.monotonic()
        check(view["n_shards"] == BATCH_DRAIN_SHARDS and view["n_items"]
              == n, f"the drain job's handle: {view}")
        st = wait_job(port, view["job_id"], "the drain under clients")
        drain_s = time.monotonic() - t0
        check(all(t.is_alive() for t in clients.threads),
              "a client stopped before the job was done")
        ladder = json.loads(get_url(port, "/v1/brownout")[1])
    finally:
        clients.finish()
        force_level(port, None)
    replies = base.replies + clients.replies
    bad = [r["status"] for r in replies if r["status"] != 200]
    check(not bad, f"{len(bad)} interactive answers were not 200: {bad[:5]}")
    rows = stream_rows(port, view["job_id"], n, "the drain job")
    base_s = [r["s"] for r in base.replies]
    post_lat = [r["s"] for r in clients.replies[:at_202]]
    drain_lat = [r["s"] for r in clients.replies[at_202:]]
    check(drain_lat, "no interactive request was answered during the "
                     "drain")
    out = {"items": n, "body_bytes": len(blob), "post_s": post_s,
           "host_parse_s": parse_s, "drain_s": drain_s,
           "batch_img_per_s": n / drain_s,
           "images_done": st["images_done"],
           "interactive_requests": {"base": len(base_s),
                                    "post": len(post_lat),
                                    "drain": len(drain_lat)},
           "interactive_p50_ms": {"base": p50_ms(base_s),
                                  "post": p50_ms(post_lat),
                                  "drain": p50_ms(drain_lat)},
           "interactive_p99_ms": {"base": p99_s(base_s) * 1e3,
                                  "post": p99_s(post_lat) * 1e3
                                  if post_lat else None,
                                  "drain": p99_s(drain_lat) * 1e3},
           "p99_envelope_ms": (5 * p99_s(base_s) + 0.25) * 1e3,
           "ladder_unpinned": {k: free[k] for k in (
               "level", "level_entries", "signals")},
           "exec_ewma_ms_by_bucket_base": base_ewma,
           "ladder_signals": ladder["signals"],
           "exec_ewma_ms_by_bucket": engine.stats()["admission"][
               "exec_ewma_ms_by_bucket"]}
    out["within_envelope"] = out["interactive_p99_ms"]["drain"] \
        <= out["p99_envelope_ms"]
    return out, rows


def batch_freeze(port: int, imgs: np.ndarray) -> dict:
    """Check 2: at a pinned L1 a one-shard job waits ``BATCH_FREEZE_S``
    with no shard done while ``frozen_deferred`` grows; released, it
    drains."""
    force_level(port, 1)
    try:
        sched0 = json.loads(get_url(port, "/v1/stats")[1])["batch"][
            "scheduler"]
        view, _ = submit_job(port, manifest_blob(
            [{"pixels": im.tolist()} for im in imgs]))
        time.sleep(BATCH_FREEZE_S)
        st = job_state(port, view["job_id"])
        sched1 = json.loads(get_url(port, "/v1/stats")[1])["batch"][
            "scheduler"]
    finally:
        force_level(port, None)
    check(st["shards_done"] == 0 and st["state"] == "pending",
          f"a shard ran at brownout L1: {st}")
    check(sched1["shards_done"] == sched0["shards_done"],
          f"the scheduler recorded shards at L1: {sched1}")
    frozen = sched1["frozen_deferred"] - sched0["frozen_deferred"]
    check(frozen > 0, f"frozen_deferred did not grow at L1: {sched1}")
    t0 = time.monotonic()
    wait_job(port, view["job_id"], "the frozen job after the release")
    return {"frozen_deferred": frozen, "freeze_s": BATCH_FREEZE_S,
            "release_to_done_s": time.monotonic() - t0}


def batch_restart(workdir: str, jobs_dir: str, imgs: np.ndarray,
                  engine, server) -> tuple[dict, list]:
    """Check 3: a job of ``BATCH_RESTART_SHARDS`` shards is stopped once a
    shard is done (scheduler, then server, then engine; the ladder is
    pinned at L1 as the first shard is recorded, so that the scheduler
    stops between shards 1 and 2 however fast they run), a half-written
    shard line is appended to its ledger, and a second server over the
    same ``--jobs-dir`` replays every shard the first recorded, counts
    the torn line, resumes the job with no resubmit and executes exactly
    the images of the shards left; the stream holds every index once."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    port = server.port
    shard = max(BUCKETS)
    store1, ladder = server.httpd.jobs, server.httpd.brownout
    known = {j["job_id"] for j in store1.jobs()}
    record = store1.record_shard

    def record_then_freeze(job_id, *args, **kwargs):
        ok = record(job_id, *args, **kwargs)
        if job_id not in known:
            ladder.force(1)
        return ok

    store1.record_shard = record_then_freeze
    view, _ = submit_job(port, manifest_blob(
        [{"pixels": im.tolist()} for im in imgs]))
    jid = view["job_id"]
    check(wait_for(lambda: job_state(port, jid)["shards_done"] >= 1,
                   BATCH_TIMEOUT_S), "no shard of the restart job ran")
    sched = server.httpd.batch_sched
    sched.stop()
    check(not sched._thread.is_alive(), "the batch scheduler did not stop")
    # every shard the first server recorded, of every job
    recorded = sum(j["shards_done"] for j in server.httpd.jobs.jobs())
    done1 = server.httpd.jobs.status(jid)["shards_done"]
    stop_server(engine, server)
    check(1 <= done1 < BATCH_RESTART_SHARDS,
          f"the stop came after {done1} shards")
    with open(os.path.join(jobs_dir, f"{jid}.jsonl"), "a",
              encoding="utf-8") as f:
        f.write('{"kind": "shard", "job": "%s", "index": %d, "res'
                % (jid, done1))
    launches0 = serve_ingest.launches
    t0 = time.monotonic()
    engine2, server2 = boot_cli(batch_argv(workdir, jobs_dir))
    boot_s = time.monotonic() - t0
    try:
        store = server2.httpd.jobs
        st0 = store.stats()
        check(st0["resumed"] == 1 and st0["torn_lines"] == 1
              and st0["replayed_shards"] == recorded,
              f"the second server's replay of {recorded} shards: {st0}")
        st = wait_job(server2.port, jid, "the resumed job")
        resume_s = time.monotonic() - t0
        rows = stream_rows(server2.port, jid, len(imgs), "the resumed job")
        served = engine2.stats()["served"]
        check(served == len(imgs) - shard * done1,
              f"the second engine served {served} images, not "
              f"{len(imgs)} - {shard}·{done1}")
        check(store.stats()["submitted"] == 0, "the job was resubmitted")
        check(st["images_done"] == len(imgs), f"the resumed job: {st}")
        batches2 = engine2.stats()["batches"]
        launches2 = serve_ingest.launches - launches0
    finally:
        stop_server(engine2, server2)
    return {"items": len(imgs), "shards_before_stop": done1,
            "replayed_shards": st0["replayed_shards"],
            "torn_lines": st0["torn_lines"], "resumed": st0["resumed"],
            "second_served": served, "boot_s": boot_s,
            "resume_s": resume_s, "second_batches": batches2,
            "second_launches_with_warmup": launches2}, rows


def batch_gan(tmp: str) -> dict:
    """Check 4: a job of ``{"seed": i}`` items on a DCGAN int8 server;
    each image within twice the card's own bucket-1-vs-32 spread (codes)
    of a direct bucket-callable call on ``default_rng(i)``'s latent, and
    the same rows against the latents of seed i + 1 fail on most;
    ``serve_ingest`` never launches."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    weights = os.path.join(tmp, "dcgan.npz")
    write_gan_weights("dcgan", weights, 71)
    n = BATCH_GAN_SHARDS * max(BUCKETS)
    t0 = time.monotonic()
    engine, server = boot_cli([
        "-m", "dcgan", "--weights", weights, "--infer-dtype", "int8",
        "--port", "0", "--device", BATCH_DEVICE,
        "--max-batch", str(max(BUCKETS)),
        "--buckets", ",".join(map(str, BUCKETS)), "--warmup",
        "--jobs-dir", os.path.join(tmp, "gan_jobs")])
    boot_s = time.monotonic() - t0
    sm = engine.model
    try:
        check(sm.infer_dtype == "int8" and str(sm.wire_dtype) == "float32",
              f"dcgan served {sm.describe()}")
        serve_ingest.launches = 0
        t0 = time.monotonic()
        view, _ = submit_job(server.port, manifest_blob(
            [{"seed": i} for i in range(n)]))
        check(view["verb"] == "generate", f"the seed job's handle: {view}")
        wait_job(server.port, view["job_id"], "the DCGAN seed job")
        drain_s = time.monotonic() - t0
        rows = stream_rows(server.port, view["job_id"], n, "the seed job")
        launches = serve_ingest.launches
        stats = engine.stats()
    finally:
        stop_server(engine, server)
    check(launches == 0, f"serve_ingest launched {launches} times on the "
                         f"generate path")

    def latents(seeds):
        return np.stack([np.random.default_rng(s).standard_normal(
            sm.input_shape).astype(np.float32) for s in seeds])

    def direct(z):
        out = {}
        for b in BUCKETS:
            fn, imgs = sm.compile_bucket(b), []
            for i in range(0, len(z), b):
                batch = np.zeros((b, *sm.input_shape), np.float32)
                batch[:len(z[i:i + b])] = z[i:i + b]
                imgs += list(fn(batch).cpu().numpy()[:len(z[i:i + b])])
            out[b] = imgs
        return out

    replies = [(200, r, 0.0) for r in rows]
    refs = direct(latents(range(n)))
    spread = max(code_diff(a, b) for a, b in zip(refs[min(BUCKETS)],
                                                 refs[max(BUCKETS)]))
    faults = hold_images(replies, refs, 2 * spread)
    check(not faults, f"dcgan int8 seed rows: {faults[:5]}")
    control = len(hold_images(replies, direct(latents(range(1, n + 1))),
                              2 * spread))
    check(2 * control > n, f"dcgan: only {control} of {n} rows failed "
                           f"against the latents of the next seed")
    exact = sum(min(code_diff(reply_image(r), rs[i]) for rs in refs.values())
                == 0 for i, r in enumerate(rows))
    return {"items": n, "boot_s": boot_s, "drain_s": drain_s,
            "img_per_s": n / drain_s, "launches": launches,
            "batches": stats["batches"], "bucket_spread_codes": spread,
            "exact_rows": exact, "control_faults": control}


def phase_batch(card_line: str) -> dict:
    """The offline batch tier through ``cli.serve``'s ``build_server``:
    ResNet-50 int8 bulk jobs beside interactive clients, the brownout
    freeze, a restart that resumes exactly once, and DCGAN int8 seed
    jobs (checks 1-4 of the docstring's ``batch`` phase)."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    shard = max(BUCKETS)
    out: dict = {"card": card_line}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        workdir = os.path.join(tmp, MODEL)
        write_checkpoint(workdir, 1, seeded_classifier(70))
        jobs_dir = os.path.join(tmp, "jobs")
        t0 = time.monotonic()
        engine, server = boot_cli(batch_argv(workdir, jobs_dir))
        out["boot_s"] = time.monotonic() - t0
        sm = engine.model
        port = server.port
        rng = np.random.RandomState(72)
        n_drain = BATCH_DRAIN_SHARDS * shard
        imgs = rng.randint(0, 256, (n_drain + shard + BATCH_CLIENTS,
                                    *sm.input_shape), np.uint8)
        drain_imgs = imgs[:n_drain]
        freeze_imgs = imgs[n_drain:n_drain + shard]
        bodies = [json.dumps({"pixels": im.tolist(), "top_k": 5}).encode()
                  for im in imgs[n_drain + shard:]]
        try:
            batches0 = engine.stats()["batches"]
            serve_ingest.launches = 0
            out["drain"], rows = batch_drain(port, engine, drain_imgs,
                                             bodies)
            out["freeze"] = batch_freeze(port, freeze_imgs)
            launches = serve_ingest.launches
            batches = engine.stats()["batches"] - batches0
            check(launches == batches, f"serve_ingest launched {launches} "
                                       f"times for {batches} batches")
            jobs = json.loads(get_url(port, "/v1/stats")[1])["batch"]["jobs"]
            check(jobs["spilled_shards"] >= 1,
                  f"no shard spilled to the ledger: {jobs}")
            metrics = parse_metrics(get_url(port, "/metrics")[1].decode())
            check(metrics.get("dvt_batch_images_total")
                  == n_drain + shard, "dvt_batch_images_total is "
                  f"{metrics.get('dvt_batch_images_total')}")
            out.update(launches=launches, batches=batches,
                       spilled_shards=jobs["spilled_shards"])
            restart_imgs = np.random.RandomState(73).randint(
                0, 256, (BATCH_RESTART_SHARDS * shard, *sm.input_shape),
                np.uint8)
            out["restart"], restart_rows = batch_restart(
                workdir, jobs_dir, restart_imgs, engine, server)
        finally:
            stop_server(engine, server)
        # the answers, held once every launch is counted
        refs = {b: bucket_logits(sm, drain_imgs, b) for b in BUCKETS}
        faults = top5_faults(rows, refs)
        check(not faults, f"batch rows vs the bucket callables: "
                          f"{faults[:5]}")
        wrong = top5_faults(rows, {"unit": direct_logits(sm, drain_imgs,
                                                         "unit")})
        check(2 * len(wrong) > len(rows),
              f"only {len(wrong)} of {len(rows)} rows failed against a "
              f"'unit' ingest")
        rfaults = top5_faults(restart_rows, {
            b: bucket_logits(sm, restart_imgs, b) for b in BUCKETS})
        check(not rfaults, f"resumed rows vs the bucket callables: "
                           f"{rfaults[:5]}")
        out["drain"]["control_faults"] = len(wrong)
        out["gan"] = batch_gan(tmp)
    return out


def profile_steps(run, n: int = 2) -> dict:
    """``run()`` ``n`` times under ``torch.profiler``: per call, the
    host's launch calls (kernel launches, graph launches, async copies
    and sets) and the device's kernels, and every device kernel's name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    host = device = 0
    names = set()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                                 "cudaMemcpyAsync", "cudaMemsetAsync")):
                host += e.count
        elif e.self_device_time_total > 0:
            device += e.count
            names.add(e.key)
    return {"host_launches": host / n, "device_kernels": device / n,
            "kernels": sorted(names)}


def states_of(trainer) -> dict:
    """A trainer's ``{name: TrainState}`` of its scan runner."""
    owner = trainer._runner.owner
    return owner if isinstance(owner, dict) else {"model": owner}


def weights_of(states: dict) -> dict:
    return {f"{name}/{k}": v.detach().cpu().clone()
            for name, st in states.items()
            for k, v in st.model.state_dict().items()}


def weights_diff(got: dict, want: dict) -> tuple[bool, float]:
    """(bit-identical, the worst tensor's max|got − want| / max|want|)."""
    import torch

    same = all(torch.equal(got[k], want[k]) for k in want)
    worst = 0.0
    for k, w in want.items():
        if w.numel() == 0 or not w.is_floating_point():
            continue
        d = float((got[k].double() - w.double()).abs().max())
        worst = max(worst, d / max(float(w.double().abs().max()), 1e-30))
    return same, worst


def recipe_trainer(name: str, K: int, work: str, device: str = "cuda"):
    """(trainer, loader) of ``name`` (``lenet5`` or ``dcgan``) with
    ``scan_steps = K`` over RECIPE_STEPS seeded uint8 batches at the
    recipe's batch, one epoch."""
    import torch

    from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.data.gan import GANLoader
    from deep_vision_tpu_torch.data.loader import ArrayLoader
    from deep_vision_tpu_torch.ops.preprocess import (
        make_gan_preprocess,
        make_mnist_preprocess,
    )
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    cfg = get_config(name)
    cfg.scan_steps, cfg.total_epochs, cfg.log_every_steps = K, 1, 1
    cfg.checkpoint_every_epochs = 10  # no checkpoint: weights are read
    rng = np.random.default_rng(21)
    n = RECIPE_STEPS * cfg.batch_size
    if name == "dcgan":
        dtype = torch.bfloat16 if cfg.half_precision else torch.float32
        loader = GANLoader(rng.integers(0, 256, (n, 28, 28, 1), np.uint8),
                           cfg.batch_size, seed=cfg.seed)
        trainer = AdversarialTrainer(cfg, gan_task(name, dtype),
                                     workdir=work,
                                     preprocess_fn=make_gan_preprocess(),
                                     device=device)
    else:
        loader = ArrayLoader(
            {"image": rng.integers(0, 256, (n, 32, 32, 1), np.uint8),
             "label": rng.integers(0, 10, n).astype(np.int32)},
            cfg.batch_size, seed=cfg.seed)
        trainer = Trainer(cfg, cfg.model(), ClassificationTask(10),
                          workdir=work, preprocess_fn=make_mnist_preprocess(),
                          device=device)
    return trainer, loader


def recipe_fit(trainer, loader) -> dict:
    """``fit`` for one epoch; the states."""
    if hasattr(trainer, "init_states"):
        return trainer.fit(loader, epochs=1)
    return {"model": trainer.fit(loader)}


def scan_equivalence(name: str, tmp: str) -> dict:
    """(a): RECIPE_STEPS steps of ``name`` from one seed with
    ``--scan-steps RECIPE_SCAN`` and with 1: the final weights must be
    bit-identical or within 1e-6 relative; a run whose replays are not
    re-seeded (DCGAN) and one whose warmup steps are thrown away must
    fail that.  Step ms (the trainer's device-clock mean: the replays,
    or the eager steps after the first) and launches a step, eager and
    graph, are information."""
    import torch

    from deep_vision_tpu_torch.core.step_graph import (
        WARMUP_STEPS,
        StepRunner,
    )

    out = {}
    runs = {}
    for K in (1, RECIPE_SCAN):
        work = os.path.join(tmp, f"{name}_scan{K}")
        trainer, loader = recipe_trainer(name, K, work)
        states = recipe_fit(trainer, loader)
        runs[K] = weights_of(states)
        series = read_series(work)
        out[f"step_ms_scan{K}"] = series["train_step_ms"][-1][1]
        bad = [v for k, s in series.items() if k.endswith("bad_steps")
               for _, v in s]
        check(bad and all(v == 0 for v in bad),
              f"{name} scan {K}: bad steps {bad}")
        batch = next(iter(loader))
        dev = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
        if K == 1:
            out["eager"] = profile_steps(
                lambda: trainer.train_step(states if name == "dcgan"
                                           else states["model"], batch))
            del out["eager"]["kernels"]
        else:
            runner = trainer._runner
            check(runner.graph is not None and runner.replays
                  == RECIPE_STEPS - WARMUP_STEPS,
                  f"{name} scan {K}: {runner.replays} replays, "
                  f"{runner.eager_steps} eager steps")
            out.update(replays=runner.replays,
                       eager_steps=runner.eager_steps)
            seed = trainer.seed_step
            st = states if name == "dcgan" else states["model"]

            def replay():
                seed(st)
                runner._row = 0  # each replay writes the group's first row
                runner.step(dev)
            out["graph"] = profile_steps(replay)
            del out["graph"]["kernels"]
        del trainer
    same, rel = weights_diff(runs[RECIPE_SCAN], runs[1])
    check(same or rel <= 1e-6,
          f"{name}: --scan-steps {RECIPE_SCAN} ended {rel:.3e} (relative) "
          f"from --scan-steps 1")
    out.update(bit_identical=same, rel=rel)
    controls = {}
    # a run whose warmup steps are thrown away: each one's update undone
    orig_warm = StepRunner._warm

    def throwaway(runner, batch):
        sts = states_of(holder["trainer"])
        saved = {k: (copy.deepcopy(st.model.state_dict()),
                     copy.deepcopy(st.opt.state_dict()))
                 for k, st in sts.items()}
        vec = orig_warm(runner, batch)
        for k, st in sts.items():
            st.model.load_state_dict(saved[k][0])
            st.opt.load_state_dict(saved[k][1])
        return vec

    holder = {}
    kinds = ["warmup_thrown_away"] + (["not_reseeded"] if name == "dcgan"
                                      else [])
    for kind in kinds:
        work = os.path.join(tmp, f"{name}_{kind}")
        trainer, loader = recipe_trainer(name, RECIPE_SCAN, work)
        holder["trainer"] = trainer
        if kind == "not_reseeded":
            seed = trainer.seed_step

            def seed_before_capture(sts, trainer=trainer, seed=seed):
                r = trainer._runner
                if r is None or r.graph is None:
                    seed(sts)
            trainer.seed_step = seed_before_capture
        else:
            StepRunner._warm = throwaway
        try:
            got = weights_of(recipe_fit(trainer, loader))
        finally:
            StepRunner._warm = orig_warm
        same_c, rel_c = weights_diff(got, runs[1])
        check(not same_c and rel_c > 1e-6,
              f"{name}: the control '{kind}' did not fail the check "
              f"({rel_c:.3e})")
        controls[kind] = rel_c
        del trainer
    out["controls_rel"] = controls
    torch.cuda.empty_cache()
    log(f"trainer recipes (a) {name}: {json.dumps(out)}")
    return out


def tasks_capture(tmp: str) -> dict:
    """(a) for the other Trainer tasks: yolov3_toy, centernet_toy and
    hourglass_toy, yolov3_toy with accumulation and the EMA, and
    hourglass_toy on a pipe grid of one card (RECIPE_TOY_PIPE), through
    ``cli.train --synthetic`` for RECIPE_TOY_STEPS steps with
    ``--scan-steps RECIPE_R50_SCAN`` and with 1, under deterministic
    algorithms (cuDNN's atomics otherwise make two eager runs differ):
    the checkpoints (the EMA included) bit-identical, and YOLOv3's
    ``best_iou_max`` launches equal, counted by replay."""
    import torch

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.ops.best_iou import best_iou_max

    out = {}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, extra in RECIPE_TOY_TASKS:
            label = " ".join((name,) + extra)
            n = RECIPE_TOY_STEPS * get_config(name).batch_size
            got = {}
            for K in (1, RECIPE_R50_SCAN):
                work = os.path.join(tmp, f"{name}_{len(extra)}_scan{K}")
                best_iou_max.launches = 0
                check(cli.main(["-m", name, "--synthetic", "--synthetic-size",
                                str(n), "--workdir", work, "--epochs", "1",
                                "--num-workers", "0", "--device", "cuda",
                                "--scan-steps", str(K), *extra]) == 0,
                      f"cli.train -m {label} --scan-steps {K} failed")
                saved = Checkpointer(os.path.join(work, "checkpoints")) \
                    .load()["state"]
                tensors = {f"model/{k}": v for k, v in saved["model"].items()}
                tensors.update({f"ema/{k}": v
                                for k, v in (saved.get("ema") or {}).items()})
                got[K] = (tensors, best_iou_max.launches)
            single, scan = got[1], got[RECIPE_R50_SCAN]
            same = single[0].keys() == scan[0].keys() and all(
                torch.equal(single[0][k], scan[0][k]) for k in single[0])
            ema = sum(k.startswith("ema/") for k in single[0])
            check(same and single[1] == scan[1]
                  and (ema > 0) == ("--ema-decay" in extra),
                  f"{label}: --scan-steps {RECIPE_R50_SCAN} is not "
                  f"bit-identical to single steps (best_iou_max "
                  f"{scan[1]} vs {single[1]} launches, {ema} EMA tensors)")
            out[label] = {"bit_identical": same, "ema_tensors": ema,
                          "best_iou_max_launches": scan[1]}
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    log(f"trainer recipes (a) the other tasks: {json.dumps(out)}")
    return out


def ema_digest(tensors: dict) -> str:
    """One hash over ``{name: tensor}``, in name order."""
    import hashlib

    import torch

    h = hashlib.blake2b(digest_size=8)
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def recipe_resnet50(tmp: str, training: dict) -> dict:
    """(b): resnet50 through cli.train on the training phase's records
    (rewritten from their seed) with ``--scan-steps RECIPE_R50_SCAN
    --ema-decay RECIPE_EMA``, 2 epochs and a resumed third: one
    ``train_ingest`` launch a step counted by replay, the kernel named in
    a profiler trace of one replay, the logged losses within 1e-4 of
    the training phase's ``--scan-steps 1`` run at the same steps, no
    bad step, the EMA in every checkpoint and carried through the
    resume (which captures anew), ``load_state`` of the workdir serving
    the EMA, and ``cli.serve --workdir`` answering from it."""
    import torch

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.restore import (
        EMA_WEIGHTS,
        checkpoint_weights,
        load_state,
        params_digest,
    )
    from deep_vision_tpu_torch.core.step_graph import StepRunner
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest

    data, work = os.path.join(tmp, "r50_data"), os.path.join(tmp, "r50")
    write_records(data)
    argv = ["-m", MODEL, "--data-format", "records", "--data-root", data,
            "--workdir", work, "--num-workers", str(WORKERS), "--device",
            "cuda", "--scan-steps", str(RECIPE_R50_SCAN), "--ema-decay",
            str(RECIPE_EMA)]
    steps = N_TRAIN // BATCH
    seen = {"captures": 0, "trace": None}
    orig_capture, orig_step = StepRunner._capture, StepRunner.step

    def counting_capture(runner, batch):
        seen["captures"] += 1
        return orig_capture(runner, batch)

    def traced_step(runner, batch):
        if runner.graph is None or seen["trace"] is not None:
            return orig_step(runner, batch)
        before = train_ingest.launches
        seen["trace"] = profile_steps(lambda: orig_step(runner, batch), 1)
        seen["trace_launches"] = train_ingest.launches - before
    StepRunner._capture, StepRunner.step = counting_capture, traced_step
    resumed = {}
    orig_resume = Trainer.maybe_resume

    def spy(self, state):
        state = orig_resume(self, state)
        resumed.update(step=state.step,
                       ema=ema_digest(state.ema_named()))
        return state
    Trainer.maybe_resume = spy
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        train_ingest.launches = 0
        check(cli.main(argv + ["--epochs", str(EPOCHS)]) == 0,
              "cli.train --scan-steps failed")
        first = train_ingest.launches
        peak = torch.cuda.max_memory_allocated()
        captures_first = seen["captures"]
        ckpts = Checkpointer(os.path.join(work, "checkpoints"))
        saved = ckpts.load(EPOCHS * steps)["state"]
        check(bool(saved.get("ema")), "the checkpoint holds no EMA")
        saved_ema = ema_digest(saved["ema"])
        check(cli.main(argv + ["--resume", "--epochs",
                               str(RESUME_EPOCHS)]) == 0,
              "cli.train --scan-steps --resume failed")
    finally:
        StepRunner._capture, StepRunner.step = orig_capture, orig_step
        Trainer.maybe_resume = orig_resume
    launches = train_ingest.launches
    check(first == EPOCHS * steps and launches == RESUME_EPOCHS * steps,
          f"train_ingest launched {first} then {launches} times in "
          f"{EPOCHS * steps} then {RESUME_EPOCHS * steps} steps")
    trace = seen["trace"]
    check(trace is not None and seen["trace_launches"] == 1 and any(
        "train_ingest" in k for k in trace["kernels"]),
        f"no train_ingest kernel in the trace of one replay: {trace}")
    check(captures_first == 1 and seen["captures"] == 2,
          f"captures: {captures_first} in the first run, "
          f"{seen['captures']} in all (the resume must capture anew)")
    check(resumed == {"step": EPOCHS * steps, "ema": saved_ema},
          f"the resume restored {resumed}, not step {EPOCHS * steps} with "
          f"EMA {saved_ema}")
    series = read_series(work)
    losses = dict(series["train_loss"])
    base = dict(training["losses"])
    common = sorted(set(losses) & set(base))
    check(bool(common) and all(
        abs(losses[s] - base[s]) <= 1e-4 * abs(base[s]) for s in common),
        f"losses {[(s, losses[s], base.get(s)) for s in common]} against "
        f"the --scan-steps 1 run's")
    check(all(v == 0 for _, v in series["train_bad_steps"]),
          f"bad steps: {series['train_bad_steps']}")
    # the workdir serves the EMA: load_state's digest is the EMA copy's
    info = {}
    model = load_state(get_config(MODEL), workdir=work, info=info,
                       log=lambda _m: None)
    payload = Checkpointer(info["dir"]).load(info["step"])
    ema_model = get_config(MODEL).model()
    ema_model.load_state_dict(checkpoint_weights(payload))
    raw_model = get_config(MODEL).model()
    raw_model.load_state_dict(payload["state"]["model"])
    want, raw = params_digest(ema_model), params_digest(raw_model)
    check(info["ema"] == EMA_WEIGHTS and info["digest"] == want != raw,
          f"load_state served {info['ema']} digest {info['digest']} "
          f"(EMA {want}, trained weights {raw})")
    del model, ema_model, raw_model
    served = serve_trained_workdir(MODEL, work)
    step_ms = [v for _, v in series["train_step_ms"]]
    out = {"train_ingest_launches": launches, "steps": RESUME_EPOCHS * steps,
           "replay_trace_kernels": [k for k in trace["kernels"]
                                    if "ingest" in k],
           "replay_host_launches": trace["host_launches"],
           "replay_device_kernels": trace["device_kernels"],
           "losses": series["train_loss"], "eager_losses": training["losses"],
           "step_ms_by_epoch": step_ms,
           "eager_step_ms_by_epoch": training["step_ms_by_epoch"],
           "peak_memory_bytes": peak,
           "eager_peak_memory_bytes": training["peak_memory_bytes"],
           "captures": seen["captures"], "ema_digest": saved_ema,
           "served_digest": info["digest"], "trained_digest": raw,
           "served": served}
    torch.cuda.empty_cache()
    log(f"trainer recipes (b) resnet50: {json.dumps(out)}")
    return out


def recipe_yolo_accum(tmp: str, yolo: dict) -> dict:
    """(c): yolov3_coco at full width (416², batch 128, bf16, Adam)
    through cli.train with ``--grad-accum RECIPE_ACCUM`` for one epoch on
    RECIPE_YOLO_TRAIN + RECIPE_YOLO_VAL seeded records: ``best_iou_max``
    launches 3 times a microbatch and 3 times an eval batch, finite
    losses, no bad step; peak memory beside the accumulation-1 run's."""
    import torch

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.ops.best_iou import best_iou_max

    data, work = os.path.join(tmp, "yolo_data"), os.path.join(tmp, "yolo")
    write_detection_shards(data, RECIPE_YOLO_TRAIN, RECIPE_YOLO_VAL,
                           YOLO_SIZE)
    steps = RECIPE_YOLO_TRAIN // YOLO_BATCH
    evals = -(-RECIPE_YOLO_VAL // YOLO_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    best_iou_max.launches = 0
    check(cli.main(["-m", "yolov3_coco", "--data-root", data, "--workdir",
                    work, "--num-workers", str(YOLO_WORKERS), "--device",
                    "cuda", "--epochs", "1", "--grad-accum",
                    str(RECIPE_ACCUM)]) == 0,
          "cli.train -m yolov3_coco --grad-accum failed")
    peak = torch.cuda.max_memory_allocated()
    launches = best_iou_max.launches
    # one evaluation an epoch and cli.train's final one
    want = 3 * RECIPE_ACCUM * steps + 3 * 2 * evals
    check(launches == want,
          f"best_iou_max launched {launches} times, not 3 x {RECIPE_ACCUM} "
          f"x {steps} train steps + 3 x {2 * evals} eval batches")
    series = read_series(work)
    losses = [v for _, v in series["train_loss"]]
    check(bool(losses) and all(math.isfinite(v) for v in losses),
          f"losses {losses}")
    check(all(v == 0 for _, v in series["train_bad_steps"]),
          f"bad steps: {series['train_bad_steps']}")
    out = {"best_iou_max_launches": launches, "train_steps": steps,
           "eval_batches": 2 * evals, "losses": series["train_loss"],
           "step_ms": [v for _, v in series["train_step_ms"]],
           "peak_memory_bytes": peak,
           "accum1_peak_memory_bytes": yolo["peak_memory_bytes"]}
    torch.cuda.empty_cache()
    log(f"trainer recipes (c) yolov3_coco: {json.dumps(out)}")
    return out


def nesterov_run(device: str, sd: dict, batches: list, nesterov: bool):
    """RECIPE_NESTEROV_STEPS float32 steps of lenet5 with SGD (lr 0.05,
    momentum 0.9, ``nesterov``, bfloat16 momentum) on ``device`` from
    ``sd``: (losses, state_dict before, after, the momentum's dtype)."""
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.optim import OptimizerConfig
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.preprocess import make_mnist_preprocess
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    cfg = get_config("lenet5")
    cfg.optimizer = OptimizerConfig(name="sgd", learning_rate=0.05,
                                    momentum=0.9, nesterov=nesterov,
                                    momentum_dtype="bfloat16")
    model = cfg.model()
    model.load_state_dict(sd)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as work:
        trainer = Trainer(cfg, model, ClassificationTask(10), workdir=work,
                          preprocess_fn=make_mnist_preprocess(),
                          device=device)
        state = trainer.state_for(model)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        losses = []
        for batch in batches:
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
            check(int(m["bad_steps"]) == 0, f"a {device} step was skipped")
        after = {k: v.detach().cpu().clone()
                 for k, v in state.model.state_dict().items()}
    return losses, before, after, state.opt.momentum[0].dtype


def recipe_nesterov() -> dict:
    """(d): lenet5 with SGD nesterov and a bfloat16 momentum, the card
    against the CPU in float32 over RECIPE_NESTEROV_STEPS steps: every
    loss within 1e-4 relative and the updates within the step check's
    bounds (``compare_steps``); the stored momentum bfloat16; the same
    run without nesterov on the card must fail those bounds."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config

    model = get_config("lenet5").model()
    model.reset_parameters(torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(6)
    batches = [{"image": rng.integers(0, 256, (64, 32, 32, 1), np.uint8),
                "label": rng.integers(0, 10, 64).astype(np.int32)}
               for _ in range(RECIPE_NESTEROV_STEPS)]
    cpu = nesterov_run("cpu", sd, batches, True)
    card = nesterov_run("cuda", sd, batches, True)
    plain = nesterov_run("cuda", sd, batches, False)
    check(card[3] == cpu[3] == torch.bfloat16,
          f"the momentum is stored in {card[3]} / {cpu[3]}")
    faults = [f"loss {i}: {g} vs {w}" for i, (g, w) in
              enumerate(zip(card[0], cpu[0])) if abs(g - w) > 1e-4 * abs(w)]
    faults += compare_steps((card[0][-1], card[1], card[2]),
                            (cpu[0][-1], cpu[1], cpu[2]))
    check(not faults, f"nesterov bf16 momentum, card vs CPU: {faults}")
    control = compare_steps((plain[0][-1], plain[1], plain[2]),
                            (cpu[0][-1], cpu[1], cpu[2]))
    check(bool(control), "the control without nesterov passed the bounds")
    errs = update_errors((None, card[1], card[2]), (None, cpu[1], cpu[2]))
    out = {"losses_card": card[0], "losses_cpu": cpu[0],
           "update_l2": errs["params"],
           "worst_tensor_l2": max(errs["l2"].values()),
           "control_faults": control[:3], "momentum_dtype": str(card[3])}
    log(f"trainer recipes (d) nesterov: {json.dumps(out)}")
    return out


def phase_trainer_recipes(training: dict, yolo: dict) -> dict:
    """The trainer's recipe options on the card: (a) ``--scan-steps``
    against single steps for lenet5 and dcgan, with its two controls;
    (b) resnet50 with ``--scan-steps`` and ``--ema-decay`` through
    cli.train, resume and cli.serve; (c) yolov3_coco with
    ``--grad-accum``; (d) nesterov with a bfloat16 momentum."""
    import torch

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        t0 = time.monotonic()
        out["scan"] = {name: scan_equivalence(name, tmp)
                       for name in ("lenet5", "dcgan")}
        out["scan"]["tasks"] = tasks_capture(tmp)
        out["scan_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["resnet50"] = recipe_resnet50(tmp, training)
        out["resnet50_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["yolo_accum"] = recipe_yolo_accum(tmp, yolo)
        out["yolo_accum_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["nesterov"] = recipe_nesterov()
    out["nesterov_s"] = time.monotonic() - t0
    torch.cuda.empty_cache()
    return out


#: phase_cli_tools: the train shards (of write_records' 4) that make the
#: two-step runs (512 images at batch 256), the exported server's requests
CLI_SHARDS, CLI_REQUESTS = 2, 8
#: where phase_cli_tools runs (its CPU rehearsal sets "cpu")
CLI_DEVICE = "cuda"


def subset_records(src: str, dst: str, shards: int) -> None:
    """``dst`` holding the first ``shards`` train shards of ``src`` and
    its val shards, as symbolic links: the same records, fewer steps."""
    from deep_vision_tpu_torch.data.records import list_shards

    os.makedirs(dst, exist_ok=True)
    for path in list_shards(src, "train")[:shards] + \
            list_shards(src, "val"):
        os.symlink(path, os.path.join(dst, os.path.basename(path)))


def write_torchvision_checkpoint(path: str, model) -> dict:
    """``model``'s weights as a torchvision-layout ``.pth``: the
    ``{"state_dict"}`` wrapper, ``module.`` prefixes (DataParallel) and
    ``num_batches_tracked`` counters (set to 7, which no importer
    reads).  Returns the state_dict written, without prefixes."""
    import torch

    sd = {k: (torch.full_like(v, 7) if k.endswith("num_batches_tracked")
              else v.detach().clone())
          for k, v in model.state_dict().items()}
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 90}, path)
    return sd


def tree_bytes(root: str) -> dict:
    """Relative path → bytes of every file under ``root``."""
    out = {}
    for r, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(r, f), "rb") as fh:
                out[os.path.relpath(os.path.join(r, f), root)] = fh.read()
    return out


def cli_run(argv: list, work: str) -> dict:
    """``cli.train.main(argv)`` on the card; the run's seconds, metric
    series and event files."""
    import glob

    from deep_vision_tpu_torch.cli import train as cli

    t0 = time.monotonic()
    check(cli.main(argv + ["--workdir", work, "--device", CLI_DEVICE]) == 0,
          f"cli.train {' '.join(argv)} failed")
    series = read_series(work)
    losses = [v for _, v in series.get("train_loss", [])]
    check(bool(losses) and all(math.isfinite(v) for v in losses),
          f"cli.train {' '.join(argv)}: losses {losses}")
    return {"seconds": time.monotonic() - t0, "series": series,
            "events": glob.glob(os.path.join(work, "tensorboard",
                                             "events.out.tfevents.*"))}


def run_info(run: dict) -> dict:
    s = run["series"]
    return {"seconds": run["seconds"],
            "losses": [v for _, v in s["train_loss"]],
            "step_ms": [v for _, v in s.get("train_step_ms", [])],
            "input_stall_frac": [v for _, v in
                                 s.get("input_stall_frac", [])],
            "h2d_bytes_per_step": [v for _, v in
                                   s.get("input_h2d_bytes_per_step", [])],
            "val_top1": [v for _, v in s.get("val_top1", [])],
            "event_files": len(run["events"])}


def pretrained_run(tmp: str, small: str) -> dict:
    """(a): ``cli.train -m resnet50 --pretrained P`` for one epoch of
    CLI_SHARDS shards: the state before the first step equals the
    checkpoint bit for bit, the head is kept, ``train_ingest`` launches
    once a step, the losses are finite."""
    import torch

    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.models import pretrained
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest

    ckpt = os.path.join(tmp, "resnet50.pth")
    want = write_torchvision_checkpoint(ckpt, seeded_classifier(41))
    seen: dict = {}
    orig_import, orig_step = pretrained.import_pretrained, Trainer.train_step

    def timed_import(*args):
        t0 = time.monotonic()
        merged, kept = orig_import(*args)
        seen.update(load_s=time.monotonic() - t0, head_kept=kept)
        return merged, kept

    def first_step(self, state, batch):
        if "differing" not in seen:
            got = state.model.state_dict()
            seen["differing"] = [
                k for k, v in want.items()
                if not k.endswith("num_batches_tracked")
                and not torch.equal(got[k].cpu(), v)]
            seen["counters"] = sorted({int(v) for k, v in got.items()
                                       if k.endswith("num_batches_tracked")})
        return orig_step(self, state, batch)

    pretrained.import_pretrained, Trainer.train_step = timed_import, \
        first_step
    train_ingest.launches = 0
    try:
        run = cli_run(["-m", MODEL, "--data-format", "records",
                       "--data-root", small, "--num-workers",
                       str(WORKERS), "--batch-size", str(BATCH),
                       "--pretrained", ckpt, "--epochs", "1"],
                      os.path.join(tmp, "pretrained"))
    finally:
        pretrained.import_pretrained, Trainer.train_step = orig_import, \
            orig_step
    steps = CLI_SHARDS * (N_TRAIN // 4) // BATCH
    launches = train_ingest.launches
    check(seen.get("differing") == [] and seen.get("counters") == [0],
          f"the state before the first step is not the checkpoint: "
          f"{seen.get('differing', 'no step')[:5]}, BN counters "
          f"{seen.get('counters')}")
    check(seen["head_kept"], "the pretrained head was not kept")
    check(launches == steps, f"train_ingest launched {launches} times in "
                             f"{steps} --pretrained steps")
    out = {"checkpoint": ckpt, "workdir": os.path.join(tmp, "pretrained"),
           "load_s": seen["load_s"], "head_kept": seen["head_kept"],
           "train_ingest_launches": launches, "steps": steps,
           **run_info(run)}
    log(f"cli tools (a) --pretrained: {json.dumps(out)}")
    return out


def host_runs(tmp: str, small: str, uint8: dict) -> dict:
    """(b): ``--host-normalize`` (with ``--upload`` to a local mirror)
    and ``--tf-preprocessing``, one epoch of CLI_SHARDS shards each:
    ``train_ingest`` never launches, the float32 wire moves 4× the uint8
    run's image bytes a step, the TF eval runs, event files exist, the
    mirror holds the checkpoint byte for byte."""
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest

    out = {}
    mirror = os.path.join(tmp, "mirror")
    from deep_vision_tpu_torch.core.config import get_config

    size = get_config(MODEL).image_size
    label_bytes = BATCH * 4
    image_bytes = uint8["h2d_bytes_per_step"][-1] - label_bytes
    check(image_bytes == BATCH * size * size * 3,
          f"the uint8 run moved {image_bytes} image bytes a step")
    for flag in ("--host-normalize", "--tf-preprocessing"):
        work = os.path.join(tmp, flag.strip("-"))
        extra = ["--upload", mirror] if flag == "--host-normalize" else []
        before = train_ingest.launches
        run = cli_run(["-m", MODEL, "--data-format", "records",
                       "--data-root", small, "--num-workers",
                       str(WORKERS), "--batch-size", str(BATCH), "--epochs",
                       "1", flag, *extra], work)
        info = run_info(run)
        check(train_ingest.launches == before,
              f"{flag}: train_ingest launched "
              f"{train_ingest.launches - before} times")
        h2d = info["h2d_bytes_per_step"][-1]
        check(h2d - label_bytes == 4 * image_bytes,
              f"{flag}: {h2d} H2D bytes a step, not 4 x {image_bytes} "
              f"image bytes + {label_bytes} label bytes")
        check(bool(info["val_top1"]) and bool(run["events"]),
              f"{flag}: eval {info['val_top1']}, event files "
              f"{run['events']}")
        info["train_ingest_launches"] = train_ingest.launches - before
        if extra:
            local = tree_bytes(os.path.join(work, "checkpoints"))
            mirrored = tree_bytes(os.path.join(mirror, "checkpoints"))
            check(bool(local) and mirrored == local,
                  f"the mirror holds {sorted(mirrored)}, the workdir "
                  f"{sorted(local)}")
            info["mirrored_files"] = sorted(mirrored)
        out[flag.strip("-")] = info
    log(f"cli tools (b) host pipelines: {json.dumps(out)}")
    return out


def infer_evals(tmp: str, data: str, pretrained: dict, yolo_dirs: dict
                ) -> dict:
    """(c): ``cli.infer eval -m resnet50 --pretrained P`` on the val
    records gives the top-1/top-5 of ``Trainer.evaluate`` on the same
    weights loaded directly; ``cli.infer eval -m yolov3_coco`` on the
    YOLOv3 phase's workdir launches ``best_iou_max`` 3 times an eval
    batch."""
    import torch

    from deep_vision_tpu_torch.cli import infer
    from deep_vision_tpu_torch.cli.train import (
        build_classification_val_loader,
    )
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.best_iou import best_iou_max
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    seen = {}
    orig = Trainer.evaluate

    def record(self, state, loader):
        seen["metrics"] = orig(self, state, loader)
        return seen["metrics"]

    Trainer.evaluate = record
    try:
        t0 = time.monotonic()
        check(infer.main(["eval", "-m", MODEL, "--workdir",
                          os.path.join(tmp, "eval"), "--pretrained",
                          pretrained["checkpoint"], "--data-root", data,
                          "--batch-size", str(BATCH), "--num-workers",
                          str(WORKERS), "--device", CLI_DEVICE]) == 0,
              "cli.infer eval --pretrained failed")
        eval_s = time.monotonic() - t0
        got = seen.pop("metrics")
        cfg = get_config(MODEL)
        model = cfg.model()
        sd = torch.load(pretrained["checkpoint"], weights_only=True)
        model.load_state_dict({k.removeprefix("module."): v for k, v in
                               sd["state_dict"].items()})
        trainer = Trainer(cfg, model, ClassificationTask(cfg.num_classes),
                          workdir=os.path.join(tmp, "eval_direct"),
                          device=CLI_DEVICE)
        loader, _ = build_classification_val_loader(
            cfg, data, "val", BATCH, num_workers=WORKERS)
        try:
            want = trainer.evaluate(trainer.state_for(model), loader)
        finally:
            loader.close()
        check(all(got[k] == want[k] for k in ("top1", "top5")),
              f"cli.infer eval --pretrained {got} against Trainer.evaluate "
              f"{want}")
        yolo_batch = YOLO_BATCH
        evals = -(-YOLO_VAL // yolo_batch)
        best_iou_max.launches = 0
        t0 = time.monotonic()
        check(infer.main(["eval", "-m", yolo_dirs["model"], "--workdir",
                          yolo_dirs["work"], "--data-root",
                          yolo_dirs["data"], "--batch-size",
                          str(yolo_batch), "--device", CLI_DEVICE]) == 0,
              "cli.infer eval -m yolov3_coco failed")
        yolo_s = time.monotonic() - t0
        launches = best_iou_max.launches
        yolo = seen.pop("metrics")
    finally:
        Trainer.evaluate = orig
    check(launches == 3 * evals,
          f"cli.infer eval launched best_iou_max {launches} times in "
          f"{evals} eval batches")
    check(all(math.isfinite(v) for v in yolo.values()),
          f"cli.infer eval -m yolov3_coco: {yolo}")
    out = {"pretrained": got, "direct": want, "eval_s": eval_s,
           "yolo": yolo, "yolo_s": yolo_s, "best_iou_max_launches":
           launches, "eval_batches": evals}
    log(f"cli tools (c) cli.infer eval: {json.dumps(out)}")
    return out


def served_top5(argv: list, xs: np.ndarray) -> tuple:
    """(engine buckets, the top-5 (class, logit) of each of ``xs``
    through ``cli.serve argv`` over HTTP, ``serve_ingest`` launches)."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    serve_ingest.launches = 0
    engine, server = boot_cli(argv)
    try:
        answers = []
        for i, x in enumerate(xs):
            status, raw, _, _ = post_h(server.port, json.dumps(
                {"pixels": x.tolist(), "top_k": 5}).encode(),
                "/v1/classify")
            body = json.loads(raw)
            check(status == 200, f"request {i}: {status} {body}")
            answers.append([(t["class"], t["logit"]) for t in body["top"]])
        return engine.buckets, answers, serve_ingest.launches
    finally:
        server.shutdown()
        engine.stop()


def export_serving(tmp: str, work: str) -> dict:
    """(d): ``cli.infer export`` of the --pretrained run's workdir, then
    ``cli.serve --stablehlo`` with that workdir: the exported forward
    at batch 1 equals the eager one bit for bit on this thread, and over
    HTTP CLI_REQUESTS float32 requests answer bit for bit as the eager
    model does through the same engine (``cli.serve --workdir
    --wire-dtype float32``), ``serve_ingest`` launching never;
    ``--infer-dtype bfloat16`` is refused.  The engine's thread and
    stream round the eager model's answers their own way too, so the
    HTTP answers against this thread's eager call are recorded, not
    held.  Information: the archive's size and export seconds, the
    exported and the eager forward's ms at batch 1."""
    import torch

    from deep_vision_tpu_torch.cli import infer
    from deep_vision_tpu_torch.cli import serve as serve_cli
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.restore import load_state
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    archive = os.path.join(tmp, "resnet50.pt2")
    t0 = time.monotonic()
    check(infer.main(["export", "-m", MODEL, "--workdir", work, "--out",
                      archive, "--device", CLI_DEVICE]) == 0,
          "cli.infer export failed")
    export_s = time.monotonic() - t0
    try:
        serve_cli.build_server(serve_cli.build_parser().parse_args(
            ["-m", MODEL, "--stablehlo", archive, "--workdir", work,
             "--infer-dtype", "bfloat16", "--port", "0", "--device",
             CLI_DEVICE]))
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "f32-wire/f32-compute only" in refused,
          f"--stablehlo --infer-dtype bfloat16 was not refused: {refused}")
    cfg = get_config(MODEL)
    eager = load_state(cfg, workdir=work, log=lambda _m: None) \
        .to(CLI_DEVICE)
    rng = np.random.default_rng(43)
    xs = rng.standard_normal((CLI_REQUESTS, cfg.image_size, cfg.image_size,
                              3)).astype(np.float32)
    sm = ModelRegistry().load_exported(MODEL, archive, workdir=work,
                                       device=CLI_DEVICE)
    run = sm.compile_bucket(1)
    with torch.no_grad():
        want = [eager(torch.from_numpy(x[None]).to(CLI_DEVICE))[0]
                .float().cpu().numpy() for x in xs]
        direct = [run(x[None])[0].float().cpu().numpy() for x in xs]
        x1 = torch.from_numpy(xs[:1]).to(CLI_DEVICE)
        exported_ms = call_ms(run, [x1], iters=30, warmup=3)
        eager_ms = call_ms(eager, [x1], iters=30, warmup=3)
    differing = [i for i in range(CLI_REQUESTS)
                 if not np.array_equal(direct[i], want[i])]
    check(not differing, f"the exported forward at batch 1 differs from "
                         f"the eager one on requests {differing}")
    del sm, run
    buckets, got, launches = served_top5(
        ["-m", MODEL, "--stablehlo", archive, "--workdir", work, "--port",
         "0", "--warmup", "--device", CLI_DEVICE], xs)
    check(buckets == [1], f"the exported server's buckets {buckets}")
    check(launches == 0, f"serve_ingest launched {launches} times on the "
                         f"exported float32 server")
    _, eager_got, _ = served_top5(
        ["-m", MODEL, "--workdir", work, "--wire-dtype", "float32",
         "--max-batch", "1", "--port", "0", "--warmup", "--device",
         CLI_DEVICE], xs)
    check(got == eager_got,
          f"exported answers against the eager model's through the same "
          f"engine: {[(g, e) for g, e in zip(got, eager_got) if g != e][:2]}")
    thread_diff = max(abs(logit - float(want[i][c]))
                      for i, row in enumerate(got) for c, logit in row)
    out = {"archive_bytes": os.path.getsize(archive), "export_s": export_s,
           "requests": CLI_REQUESTS, "serve_ingest_launches": launches,
           "exported_forward_ms": exported_ms, "eager_forward_ms": eager_ms,
           "served_vs_this_thread_max_abs": thread_diff,
           "bf16_refused": refused}
    log(f"cli tools (d) export + --stablehlo: {json.dumps(out)}")
    return out


def phase_cli_tools(card_line: str, yolo_dirs: dict) -> dict:
    """The single-card CLI's last options on the card, ResNet-50 at full
    width on the training phase's records (rewritten from their seed):
    (a) ``--pretrained``; (b) ``--host-normalize`` with ``--upload`` and
    ``--tf-preprocessing``; (c) ``cli.infer eval`` of the pretrained
    checkpoint and of the YOLOv3 phase's workdir; (d) ``cli.infer
    export`` served by ``cli.serve --stablehlo``."""
    import torch

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        data, small = os.path.join(tmp, "data"), os.path.join(tmp, "small")
        write_records(data, N_TRAIN, N_VAL)
        subset_records(data, small, CLI_SHARDS)
        out = {"card": card_line}
        out["pretrained"] = pretrained_run(tmp, small)
        out["host"] = host_runs(tmp, small, out["pretrained"])
        out["eval"] = infer_evals(tmp, data, out["pretrained"], yolo_dirs)
        out["export"] = export_serving(tmp, out["pretrained"].pop("workdir"))
    torch.cuda.empty_cache()
    return out


#: data parallelism (phase_data_parallel): two gloo ranks on the one
#: card, the step check's global batch (a rank's half each), YOLOv3's
#: rank batch where two ranks fit beside each other, and the seconds a
#: collective or a rank process may wait before the phase fails
DP_RANKS, DP_STEP_BATCH, DP_YOLO_BATCH, DP_YOLO_STEPS = 2, 256, 64, 2
DP_COLLECTIVE_S, DP_RANK_TIMEOUT_S = 120.0, 240.0


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic():
    """cuDNN's and PyTorch's deterministic algorithms inside: two runs of
    the same step agree bit for bit, so what parts two steps is the
    split of the batch, not the weight gradients' atomics."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def step_errors(got, want) -> dict:
    """:func:`update_errors` of step ``got`` against ``want`` in brief:
    the loss, the parameters' and the statistics' L2 ratios, the worst
    tensor's and the six worst tensors."""
    errs = update_errors(got, want)
    worst = sorted(errs["l2"].items(), key=lambda kv: -kv[1])
    return {"loss": got[0], "params": errs["params"],
            "stats": errs["stats"], "worst_tensor": worst[0][1],
            "worst_l2": worst[:6]}


def dp_bounds(floor: dict) -> dict:
    """The step check's bounds for the data-parallel step: loss 1e-4
    relative, running statistics 1e-4 in L2, parameter updates 1e-3 in
    L2 and 5e-2 a tensor, each of the last two raised to twice the
    one-process step's own floor where that is higher: at the global
    batch 256, weights moved by 1e-7 move the float32 update by about
    1e-3 (the BatchNorm scales' gradients cancel most)."""
    return {"loss": 1e-4, "stats": 1e-4,
            "params": max(1e-3, 2 * floor["params"]),
            "tensor": max(5e-2, 2 * floor["worst_tensor"])}


def dp_faults(step: dict, want_loss: float, bounds: dict) -> list[str]:
    """What of a rank's step (``step_errors``) breaks ``bounds``."""
    faults = []
    if abs(step["loss"] - want_loss) > bounds["loss"] * abs(want_loss):
        faults.append(f"loss {step['loss']} vs {want_loss}")
    for k, b in (("params", "params"), ("stats", "stats"),
                 ("worst_tensor", "tensor")):
        if step[k] > bounds[b]:
            faults.append(f"{k} {step[k]:.3e} > {bounds[b]:.3e}")
    return faults


def dp_step(device, sd: dict, images, factors, labels, workdir: str,
            local: bool = False) -> tuple:
    """One float32 guarded step of full-width ResNet-50 on ``device``,
    under deterministic algorithms, over ``images`` (this process's
    rows: a rank's shard, or all of them outside a group), on the
    default mesh (the group's ranks): (loss, state_dict before, after,
    both on the CPU).  ``local`` (control): BatchNorm over this rank's
    rows alone."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.models.common import set_batchnorm_mesh
    from deep_vision_tpu_torch.models.resnet import ResNet50
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    cfg = get_config(MODEL)
    cfg.batch_size = len(images)
    model = ResNet50(dtype=torch.float32)
    model.load_state_dict(sd)
    f = factors.to(device)

    def preprocess(batch, generator, train):
        return {**batch, "image": train_ingest(batch["image"], f)}

    trainer = Trainer(cfg, model, ClassificationTask(1000), workdir=workdir,
                      preprocess_fn=preprocess, device=device)
    state = trainer.state_for(model)
    if local:
        set_batchnorm_mesh(model, None)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    with deterministic():
        state, m = trainer.train_step(state, {"image": images,
                                              "label": labels})
    after = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    check(int(m["bad_steps"]) == 0, f"the {device} step was skipped")
    return float(m["loss"]), before, after


def dp_rank_fit(device, data: str, work: str) -> dict:
    """``Trainer.fit`` of ResNet-50 at the recipe's rank batch over this
    rank's shard of the training records (``ImageNetLoader`` takes the
    rank from the group), one epoch; then a fresh trainer resumes the
    checkpoint rank 0 wrote and trains the second epoch."""
    from deep_vision_tpu_torch.core import checkpoint
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.data.imagenet import ImageNetLoader
    from deep_vision_tpu_torch.ops.preprocess import make_imagenet_preprocess
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    writes = []
    write_files = checkpoint.Checkpointer._write_files

    def counted(self, step, payload):
        writes.append(step)
        return write_files(self, step, payload)

    checkpoint.Checkpointer._write_files = counted
    out = {}
    for epochs in (1, 2):
        cfg = get_config(MODEL)
        cfg.total_epochs = epochs
        common = dict(image_size=CROP, resize=STORED, num_workers=0)
        train = ImageNetLoader.from_records(data, "train", cfg.batch_size,
                                            train=True, seed=cfg.seed,
                                            **common)
        val = ImageNetLoader.from_records(data, "val", cfg.eval_batch_size,
                                          train=False, **common)
        trainer = Trainer(cfg, cfg.model(),
                          ClassificationTask(cfg.num_classes,
                                             cfg.label_smoothing),
                          workdir=work,
                          preprocess_fn=make_imagenet_preprocess(),
                          device=device)
        state = trainer.init_state()
        if epochs == 2:
            state = trainer.maybe_resume(state)
            out["restored"] = state_digest(
                state.model.state_dict(), state.opt.state_dict()["momentum"])
        train_ingest.launches = 0
        state = trainer.fit(train, val, state=state)
        hist = trainer.logger.history
        out[f"epoch{epochs}"] = {
            "train_ingest_launches": train_ingest.launches,
            "steps": len(train), "step": state.step,
            "shard": len(train.host_indices),
            "val_top1": hist["val_top1"]["values"][-1],
            "val_loss": hist["val_loss"]["values"][-1],
            "losses": hist["train_loss"]["values"],
            "step_ms": hist["train_step_ms"]["values"][-1],
            "digest": state_digest(state.model.state_dict(),
                                   state.opt.state_dict()["momentum"])}
        train.close()
        val.close()
    out["writes"] = len(writes)
    return out


def dp_rank_yolo(device, work: str) -> dict:
    """``DP_YOLO_STEPS`` guarded steps of ``yolov3_coco`` at 416² and the
    rank batch ``DP_YOLO_BATCH`` on seeded scenes (its loader, as the
    reference's, reads the whole split on every rank)."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.data.detection import (
        DetectionLoader,
        synthetic_detection_dataset,
    )
    from deep_vision_tpu_torch.ops.best_iou import best_iou_max
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess
    from deep_vision_tpu_torch.tasks.detection import YoloTask

    cfg = get_config("yolov3_coco")
    cfg.batch_size = DP_YOLO_BATCH
    samples = synthetic_detection_dataset(DP_YOLO_STEPS * DP_YOLO_BATCH,
                                          YOLO_SIZE, YOLO_CLASSES, seed=41)
    loader = DetectionLoader(samples, DP_YOLO_BATCH, YOLO_CLASSES, YOLO_SIZE,
                             train=True, seed=cfg.seed,
                             device_normalize=True, num_workers=0)
    trainer = Trainer(cfg, cfg.model(), YoloTask(YOLO_CLASSES),
                      workdir=work, preprocess_fn=make_scale_preprocess(),
                      device=device)
    state = trainer.init_state()
    torch.cuda.synchronize()
    best_iou_max.launches = 0
    losses, t0 = [], time.monotonic()
    for batch in loader:
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        check(int(m["bad_steps"]) == 0, "a YOLOv3 step was skipped")
    out = {"best_iou_max_launches": best_iou_max.launches,
           "steps": len(losses), "losses": losses,
           "s": time.monotonic() - t0,
           "digest": state_digest(state.model.state_dict(),
                                  state.opt.state_dict())}
    loader.close()
    return out


def dp_all_reduce_ms(device, iters: int = 5) -> float:
    """Host-clock ms of one all-reduce of a CUDA float32 buffer the size
    of ResNet-50's gradients (25,557,032 values, 102 MB) through the
    group, the trainer's one flat gradient reduction (after a warmup;
    each call ends in a synchronize)."""
    import torch

    from deep_vision_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    buf = torch.ones(25_557_032, device=device)
    mesh.all_reduce_(buf)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(iters):
        mesh.all_reduce_(buf)
    torch.cuda.synchronize()
    check(float(buf[0]) == float(DP_RANKS) ** (iters + 1),
          "the all-reduce summed wrongly")
    return (time.monotonic() - t0) * 1e3 / iters


def dp_rank_main(spec_path: str, rank: int) -> int:
    """A rank of ``phase_data_parallel`` (``chip_smoke.py --dp-rank SPEC
    RANK``): joins the gloo group on ``cuda:0``, runs the step check
    (and its rank-local-statistics control), the fit and resume, and the
    YOLOv3 steps, and writes its results as JSON."""
    sys.path.insert(0, REPO)
    import torch

    from deep_vision_tpu_torch.core.device import configure_precision
    from deep_vision_tpu_torch.parallel import distributed

    with open(spec_path) as f:
        spec = json.load(f)
    configure_precision()
    distributed.initialize(f"127.0.0.1:{spec['port']}", DP_RANKS, rank,
                           backend="gloo", device="cuda:0",
                           timeout_s=DP_COLLECTIVE_S)
    device = torch.device("cuda", 0)
    out = {"rank": rank, "backend": distributed.backend()}
    try:
        images = np.load(spec["images"])
        factors = torch.load(spec["factors"])
        sd = torch.load(spec["sd"])
        ref = torch.load(spec["ref"])
        rows = slice(rank * DP_STEP_BATCH // DP_RANKS,
                     (rank + 1) * DP_STEP_BATCH // DP_RANKS)
        labels = (np.arange(DP_STEP_BATCH, dtype=np.int32) * 97) % 1000
        work = os.path.join(spec["work"], f"step{rank}")
        steps = {}
        for local in (False, True):
            t0 = time.monotonic()
            got = dp_step(device, sd, images[rows], factors[rows],
                          labels[rows], work, local=local)
            steps[local] = {"loss": got[0], "s": time.monotonic() - t0,
                            "digest": state_digest(got[2], {}),
                            **step_errors(got, ref)}
            torch.cuda.empty_cache()
        out["step"], out["control"] = steps[False], steps[True]
        t0 = time.monotonic()
        out["fit"] = dp_rank_fit(device, spec["data"],
                                 os.path.join(spec["work"], "fit"))
        out["fit"]["s"] = time.monotonic() - t0
        torch.cuda.empty_cache()
        out["yolo"] = dp_rank_yolo(device, os.path.join(spec["work"],
                                                        f"yolo{rank}"))
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["all_reduce_ms"] = dp_all_reduce_ms(device)
    finally:
        distributed.shutdown()
    with open(spec[f"out{rank}"], "w") as f:
        json.dump(out, f)
    return 0


class Procs:
    """Processes the phase started: each polled to its end, a failing
    one failing the phase at once, all killed at the deadline and
    reaped whatever happens (``with`` block)."""

    def __init__(self, timeout_s: float):
        self.deadline = time.monotonic() + timeout_s
        self.procs: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p, _ in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p, _ in self.procs.values():
            p.wait()

    def start(self, name: str, cmd: list, log_path: str) -> None:
        with open(log_path, "w") as out:
            self.procs[name] = (subprocess.Popen(
                cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                stdout=out, stderr=subprocess.STDOUT), log_path)

    def wait(self, names) -> list[str]:
        """Wait for ``names``; their output.  Any started process that
        fails first fails the phase with its log's tail."""
        while True:
            for name, (p, path) in self.procs.items():
                if p.poll() not in (None, 0):
                    with open(path) as f:
                        tail = f.read()[-4000:]
                    log(f"data parallel: {name} exited {p.returncode}:\n"
                        f"{tail}")
                    check(False, f"data parallel: {name} exited "
                                 f"{p.returncode}")
            if all(self.procs[n][0].poll() == 0 for n in names):
                break
            check(time.monotonic() < self.deadline,
                  f"data parallel: {names} still running at the deadline")
            time.sleep(0.2)
        outs = []
        for n in names:
            with open(self.procs[n][1]) as f:
                outs.append(f.read())
        return outs


def cli_command(data: str, work: str, extra: list) -> list:
    """``cli.train -m resnet50 --scan-steps 2`` on the training records
    through ``chip_smoke.py --cli-train`` (which prints the kernels'
    launches) under ``python -m torch.distributed.run --standalone
    --nproc-per-node 1``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", os.path.abspath(__file__),
            "--cli-train", "-m", MODEL, "--data-format", "records",
            "--data-root", data, "--workdir", work, "--num-workers", "0",
            "--device", "cuda", "--scan-steps", "2", *extra]


def cli_result(stdout: str, work: str) -> dict:
    launches = [json.loads(s)["launches"] for s in stdout.splitlines()
                if s.startswith('{"launches"')]
    device = [s for s in stdout.splitlines() if s.startswith("device:")]
    check(bool(launches) and bool(device),
          f"cli.train printed no launches or device line:\n{stdout[-2000:]}")
    return {"launches": launches[-1], "device_line": device[-1],
            "series": read_series(work)}


def cli_train_main(argv: list) -> int:
    """``chip_smoke.py --cli-train ARGS``: ``cli.train.main(ARGS)`` with
    every counted kernel's launches set to 0 before and printed after."""
    sys.path.insert(0, REPO)
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.ops import COUNTED

    for fn in COUNTED:
        fn.launches = 0
    rc = cli.main(argv)
    print(json.dumps({"launches": {fn.__name__: fn.launches
                                   for fn in COUNTED}}), flush=True)
    return rc


def phase_data_parallel(training: dict) -> dict:
    """Data-parallel training (``parallel/``): (a) two gloo ranks of
    full-width ResNet-50 on the one card against the one-process step,
    a fit and resume at the recipe's rank batch, YOLOv3 steps; (b) one
    NCCL rank through ``torch.distributed.run`` and ``cli.train --mesh
    data=1 --scan-steps 2`` for an epoch and its resume, against the
    training phase's run with no mesh on the same records.  (b) runs
    while (a)'s ranks run."""
    import torch

    from deep_vision_tpu_torch.models.resnet import ResNet50
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest_factors

    log("data parallel: two ranks share the card under gloo, since NCCL "
        "refuses two ranks on one device (gloo runs all_reduce and "
        "broadcast on CUDA tensors through the host)")
    out = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp, Procs(DP_RANK_TIMEOUT_S) as procs:
        data = os.path.join(tmp, "data")
        write_records(data, N_TRAIN, N_VAL, STORED)
        # (a) the step check's start: seeded weights, the last BN scale of
        # every block at STEP_CHECK_LAST_SCALE, one global batch
        model = ResNet50().reset_parameters(torch.Generator().manual_seed(5))
        for stage in model.stages():
            for block in stage:
                torch.nn.init.constant_(
                    getattr(block, f"bn{block.convs}").weight,
                    STEP_CHECK_LAST_SCALE)
        sd = model.state_dict()
        images = np.random.default_rng(4).integers(
            0, 256, (DP_STEP_BATCH, 224, 224, 3), dtype=np.uint8)
        factors = train_ingest_factors(torch.from_numpy(images),
                                       torch.Generator().manual_seed(6))
        labels = (np.arange(DP_STEP_BATCH, dtype=np.int32) * 97) % 1000
        t0 = time.monotonic()
        ref = dp_step(torch.device("cuda", 0), sd, images, factors, labels,
                      os.path.join(tmp, "ref"))
        out["one_process_step_s"] = time.monotonic() - t0
        # the floor: the one-process step from weights moved by 1e-7
        gen = torch.Generator().manual_seed(9)
        moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                 if v.is_floating_point() else v for k, v in sd.items()}
        out["floor"] = step_errors(dp_step(
            torch.device("cuda", 0), moved, images, factors, labels,
            os.path.join(tmp, "moved")), ref)
        bounds = dp_bounds(out["floor"])
        out["bounds"], out["loss"] = bounds, ref[0]
        log(f"data parallel: one process {out['one_process_step_s']:.1f} s, "
            f"floor {json.dumps(out['floor'])}, bounds {json.dumps(bounds)}")
        torch.cuda.empty_cache()
        spec = {"port": free_port(), "work": tmp, "data": data,
                "images": os.path.join(tmp, "images.npy"),
                "factors": os.path.join(tmp, "factors.pt"),
                "sd": os.path.join(tmp, "sd.pt"),
                "ref": os.path.join(tmp, "ref.pt"),
                **{f"out{r}": os.path.join(tmp, f"out{r}.json")
                   for r in range(DP_RANKS)}}
        np.save(spec["images"], images)
        torch.save(factors, spec["factors"])
        torch.save(sd, spec["sd"])
        torch.save(ref, spec["ref"])
        del ref, model, sd, moved
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t0 = time.monotonic()
        for r in range(DP_RANKS):
            procs.start(f"rank {r}", [sys.executable,
                                      os.path.abspath(__file__),
                                      "--dp-rank", spec_path, str(r)],
                        os.path.join(tmp, f"rank{r}.log"))
        # (b) beside them: one NCCL rank for an epoch, then its resume
        nccl_work = os.path.join(tmp, "nccl")
        procs.start("torchrun", cli_command(data, nccl_work, [
            "--mesh", "data=1", "--epochs", "1"]),
            os.path.join(tmp, "nccl1.log"))
        nccl = cli_result(procs.wait(["torchrun"])[0], nccl_work)
        procs.start("torchrun resume", cli_command(data, nccl_work, [
            "--mesh", "data=1", "--epochs", "2", "--resume"]),
            os.path.join(tmp, "nccl2.log"))
        resumed = cli_result(procs.wait(["torchrun resume"])[0], nccl_work)
        out["cli_s"] = time.monotonic() - t0
        procs.wait([f"rank {r}" for r in range(DP_RANKS)])
        out["ranks_s"] = time.monotonic() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(spec[f"out{r}"]) as f:
                ranks.append(json.load(f))
        out["ranks"] = ranks
        log(f"data parallel: ranks {json.dumps(ranks)[:3000]}")
        for r in ranks:
            check(r["backend"] == "gloo", f"rank backend {r['backend']}")
            faults = dp_faults(r["step"], out["loss"], bounds)
            check(not faults, f"rank {r['rank']}'s step disagrees with the "
                              f"one-process step: {faults}")
            check(bool(dp_faults(r["control"], out["loss"], bounds)),
                  f"rank {r['rank']} with rank-local BatchNorm statistics "
                  f"passed the step bounds")
        check(ranks[0]["step"]["digest"] == ranks[1]["step"]["digest"],
              "the two ranks' weights differ after the step")
        fits = [r["fit"] for r in ranks]
        shard = N_TRAIN // DP_RANKS
        steps = shard // BATCH
        for f in fits:
            for e in ("epoch1", "epoch2"):
                check(f[e]["shard"] == shard and f[e]["steps"] == steps,
                      f"a rank read {f[e]['shard']} records in "
                      f"{f[e]['steps']} steps, not {shard} in {steps}")
                check(f[e]["train_ingest_launches"] == steps,
                      f"train_ingest launched {f[e]['train_ingest_launches']}"
                      f" times in a rank's {steps} steps")
        for e in ("epoch1", "epoch2"):
            for k in ("val_top1", "val_loss", "losses", "digest"):
                check(fits[0][e][k] == fits[1][e][k],
                      f"{e} {k} differs between the ranks: "
                      f"{fits[0][e][k]} vs {fits[1][e][k]}")
        check(fits[0]["writes"] >= 1 and fits[1]["writes"] == 0,
              f"checkpoint files written by rank 0: {fits[0]['writes']}, "
              f"by rank 1: {fits[1]['writes']}")
        check(fits[0]["restored"] == fits[1]["restored"]
              == fits[0]["epoch1"]["digest"],
              "the resume did not restore the saved state bit for bit")
        ckpts = sorted(os.listdir(os.path.join(tmp, "fit", "checkpoints")))
        check(ckpts == [str(steps), str(2 * steps)],
              f"checkpoints {ckpts}")
        for r in ranks:
            y = r["yolo"]
            check(y["best_iou_max_launches"] == 3 * y["steps"]
                  == 3 * DP_YOLO_STEPS,
                  f"rank {r['rank']}: best_iou_max launched "
                  f"{y['best_iou_max_launches']} times in {y['steps']} "
                  f"YOLOv3 steps")
            check(all(math.isfinite(v) for v in y["losses"]),
                  f"YOLOv3 losses {y['losses']}")
        check(ranks[0]["yolo"]["digest"] == ranks[1]["yolo"]["digest"],
              "the ranks' YOLOv3 weights differ")
        cli_steps = N_TRAIN // BATCH
        check("backend=nccl" in nccl["device_line"]
              and "backend=nccl" in resumed["device_line"],
              f"the torchrun rank's backend: {nccl['device_line']}")
        for run in (nccl, resumed):
            check(run["launches"]["train_ingest"] == cli_steps,
                  f"train_ingest launched {run['launches']['train_ingest']} "
                  f"times in {cli_steps} steps")
        # the training phase's run (no mesh, eager) logged the same steps
        # where its epochs end
        got = dict(resumed["series"]["train_loss"])
        want = dict(training["losses"])
        common = sorted(set(got) & set(want))
        check(len(common) >= 2 and all(
            abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) for k in common),
            f"NCCL losses {got} vs no mesh {want}")
        check(all(math.isfinite(v) for v in got.values()),
              f"the NCCL run's losses {got}")
        out["cli"] = {k: {"launches": run["launches"],
                          "device_line": run["device_line"],
                          "losses": run["series"]["train_loss"]}
                      for k, run in (("nccl", nccl), ("resumed", resumed))}
        out["cli"]["no_mesh_losses"] = [[k, want[k]] for k in common]
    log(f"data parallel: {json.dumps(out)[:4000]}")
    return out


def mesh_faults(replies, refs: dict, bound: float) -> tuple[list, float]:
    """Each /v1/classify answer against the unsharded model's direct
    logits of its image (``refs``: bucket → one row an image).  An
    answer holds at a bucket when every served logit lies within
    ``bound`` of the direct logit of its class, each served class is in
    the direct top 5 up to a tie within ``bound``, and top-1 is equal
    where the direct margin exceeds ``bound``.  Returns the faults and
    the largest logit difference of the buckets that held."""
    faults, worst = [], 0.0
    for i, (status, got, _) in enumerate(replies):
        if status != 200:
            faults.append(f"request {i}: HTTP {status} {got}")
            continue
        classes = [t["class"] for t in got["top"]]
        logits = np.array([t["logit"] for t in got["top"]], np.float64)
        best = math.inf
        for ref in refs.values():
            r = ref[i].astype(np.float64)
            order = np.sort(r)
            err = float(np.abs(logits - r[classes]).max())
            if err <= bound and r[classes].min() >= order[-5] - bound \
                    and (order[-1] - order[-2] <= bound
                         or classes[0] == int(r.argmax())):
                best = min(best, err)
        if len(classes) != 5 or best > bound:
            faults.append(f"request {i}: top-5 {classes} held by no "
                          f"bucket's direct logits within {bound:.3g}")
        else:
            worst = max(worst, best)
    return faults, worst


def split_shapes(view) -> dict:
    """layer name → (mode, the kernel shape each model shard holds) of
    every layer the view splits over ``model``."""
    out = {}
    mesh = view.mesh_shape()
    m = mesh.get("model", 1)
    for key, s in view._layout.specs.items():
        if s.mode in ("column", "row"):
            w = view._layout.shapes[key]
            dim = 0 if s.mode == "column" else 1
            shard = list(w)
            shard[dim] //= m
            out[key[:-len(".weight")]] = (s.mode, tuple(shard))
    return out


def layer_calls(view, x) -> list:
    """(input shape, weight shape, device) of every convolution and
    dense product one call of ``view``'s bucket callable makes."""
    import torch
    import torch.nn.functional as F

    seen = []
    originals = {"conv2d": F.conv2d, "linear": F.linear}

    def recorder(name):
        def run(inp, weight, *args, **kwargs):
            seen.append((tuple(inp.shape), tuple(weight.shape),
                         str(weight.device)))
            return originals[name](inp, weight, *args, **kwargs)
        return run

    fn = view.compile_bucket(int(x.shape[0]))
    try:
        for name in originals:
            setattr(F, name, recorder(name))
        fn(x)
        torch.cuda.synchronize()
    finally:
        for name, f in originals.items():
            setattr(F, name, f)
    return seen


def mesh_server(workdir: str, flags: list, bodies: list, refs: dict,
                bound: float, n_data: int) -> tuple:
    """``cli.serve --device MESH_DEVICE`` with ``flags`` over the
    workdir's ResNet-50 int8: the requests answered (``mesh_faults``),
    ``serve_ingest`` launched once a data shard a batch, the mesh and
    the bytes in /v1/stats, /v1/healthz and the two /metrics gauges.
    Returns (engine, server, the run's numbers); the caller stops
    them."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    engine, server = boot_cli(
        ["-m", MODEL, "--workdir", workdir, "--wire-dtype", "uint8",
         "--infer-dtype", "int8", "--port", "0", "--device", MESH_DEVICE,
         "--max-batch", str(max(BUCKETS)), *flags])
    port = server.port
    batches0 = engine.stats()["batches"]
    serve_ingest.launches = 0
    replies = drive(port, bodies, MESH_N_SEQ)
    launches = serve_ingest.launches
    st = engine.stats()
    ran = st["batches"] - batches0
    faults, worst = mesh_faults(replies, refs, bound)
    check(not faults, f"mesh {flags}: {faults[:5]}")
    check(launches == ran * n_data,
          f"mesh {flags}: serve_ingest launched {launches} times for "
          f"{ran} batches over {n_data} data shards")
    status, blob = get_url(port, "/v1/stats")
    stats = json.loads(blob)[MODEL]
    status, blob = get_url(port, "/v1/healthz")
    health = json.loads(blob)["engines"][MODEL]
    mesh = engine.model.mesh_shape()
    check(stats["mesh_shape"] == mesh and health["mesh_shape"] == mesh,
          f"mesh {flags}: stats {stats['mesh_shape']}, healthz "
          f"{health['mesh_shape']}, model {mesh}")
    status, blob = get_url(port, "/metrics")
    samples = parse_metrics(blob.decode())
    gauges = {axis: samples.get(
        f'dvt_serve_mesh_shape{{axis="{axis}",model="{MODEL}"}}')
        for axis in mesh}
    shard_g = samples.get(f'dvt_serve_param_shard_bytes{{model="{MODEL}"}}')
    check(gauges == {k: float(v) for k, v in mesh.items()}
          and shard_g == stats["param_shard_bytes"],
          f"mesh {flags}: /metrics mesh {gauges} and shard bytes "
          f"{shard_g} against /v1/stats {mesh}, "
          f"{stats['param_shard_bytes']}")
    return engine, server, {
        "flags": flags, "mesh": mesh, "requests": len(replies),
        "batches": ran, "launches": launches,
        "max_logit_err": worst, "buckets": st["buckets"],
        "placement": engine.model.placement_desc(),
        "param_shard_bytes": stats["param_shard_bytes"],
        "param_global_bytes": stats["param_global_bytes"]}


def phase_mesh_serving(card_line: str) -> dict:
    """ResNet-50 int8 at full width on the uint8 wire through
    ``cli.serve``'s ``build_server`` over a data×model grid of one card:
    ``--mesh 2,2 --partition-rules classifier`` refused with the
    reference's words (int8), the classifier table's dense rule anchored
    on ``params/``, the fallback sharder (column- and row-parallel
    convolutions and a row-parallel classifier), and ``--shard-batches``
    over two.  Each answer within twice the card's own bucket-1-vs-32
    logit spread of the unsharded bucket callable, ``serve_ingest``
    launched batches × D times, the mesh and bytes in the stats and
    gauges; on the fallback view: every split layer's shards seen at
    their shapes and devices, the shards reversed failing most rows,
    one chip's bytes below the whole model's with ``memory_allocated``
    rising by D copies of it (shards, not M copies), spill and re-admit
    bit for bit."""
    import torch

    from deep_vision_tpu_torch.cli import serve as cli
    from deep_vision_tpu_torch.parallel.mesh import make_mesh
    from deep_vision_tpu_torch.serve.mesh_view import ShardedLayer
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    body = {"top_k": 5}
    n_data, n_model = MESH_AXES
    mesh_flag = f"{n_data},{n_model}"
    out: dict = {"card": card_line}
    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        workdir = os.path.join(tmp, MODEL)
        write_checkpoint(workdir, 1, seeded_classifier(6))
        # the reference's classifier table on int8: refused, its words
        try:
            cli.build_server(cli.build_parser().parse_args(
                ["-m", MODEL, "--workdir", workdir, "--wire-dtype",
                 "uint8", "--infer-dtype", "int8", "--port", "0",
                 "--device", MESH_DEVICE, "--mesh", mesh_flag,
                 "--partition-rules", "classifier"]))
            refusal = None
        except ValueError as e:
            refusal = str(e)
        check(refusal is not None and MESH_REFUSAL in refusal,
              f"--partition-rules classifier on int8: {refusal}")
        out["classifier_int8_refusal"] = refusal

        sm = ModelRegistry().load_checkpoint(
            MODEL, workdir=workdir, wire_dtype="uint8", infer_dtype="int8",
            device=MESH_DEVICE)
        imgs = np.random.RandomState(41).randint(
            0, 256, (MESH_N_SEQ + MESH_N_CONC, *sm.input_shape), np.uint8)
        bodies = [json.dumps({"pixels": im.tolist(), **body}).encode()
                  for im in imgs]
        refs = {b: bucket_logits(sm, imgs, b) for b in BUCKETS}
        spread = float(np.abs(refs[min(BUCKETS)]
                              - refs[max(BUCKETS)]).max())
        bound = 2.0 * spread
        out["bucket_spread"] = spread
        out["bound"] = bound
        x32 = torch.from_numpy(imgs).to(MESH_DEVICE)

        runs = {}
        engine, server, runs["params_table"] = mesh_server(
            workdir, ["--mesh", mesh_flag, "--partition-rules",
                      MESH_PARAMS_TABLE], bodies, refs, bound, n_data)
        stop_server(engine, server)

        engine, server, runs["fallback"] = mesh_server(
            workdir, ["--mesh", mesh_flag], bodies, refs, bound, n_data)
        try:
            view = engine.model
            check(view.param_bytes() < view.param_global_bytes(),
                  f"per-chip bytes {view.param_bytes()} not below the "
                  f"model's {view.param_global_bytes()}")
            # the shards ran where they lie, at their shapes
            calls = layer_calls(view, x32)
            split = split_shapes(view)
            check(bool(split) and {m for m, _ in split.values()}
                  == {"column", "row"}, f"split layers {split}")
            for name, (mode, shape) in split.items():
                hits = [c for c in calls if c[1] == shape
                        and c[0][0] == len(imgs) // n_data]
                check(len(hits) >= n_data * n_model,
                      f"{name} ({mode}) ran {len(hits)} shards of {shape}")
            devices = sorted({c[2] for c in calls})
            # forward ms a bucket, the view beside the single engine
            ms = {"mesh": bucket_forward_ms(view, (2, 32), iters=5),
                  "single": bucket_forward_ms(sm, (2, 32), iters=5)}
            # the control: every split layer's shards joined reversed
            fn = view.compile_bucket(32)
            layers = [m for m in view._model.modules()
                      if isinstance(m, ShardedLayer)]
            for m in layers:
                m.shards = torch.nn.ModuleList(list(m.shards)[::-1])
            try:
                wrong = fn(x32)
                torch.cuda.synchronize()
            finally:
                for m in layers:
                    m.shards = torch.nn.ModuleList(list(m.shards)[::-1])
            wrong = wrong.cpu().numpy()
            rows = [(200, json.loads(json.dumps(sm.workload.respond(
                sm, body, wrong[i]))), 0.0) for i in range(len(imgs))]
            control = len(mesh_faults(rows, refs, bound)[0])
            check(2 * control > len(imgs), f"reversed shards passed the "
                  f"answer check on {len(imgs) - control} rows")
            # spill and re-admit through the same callable
            first = fn(x32).cpu()
            before = memory_idle(False)
            spilled = view.spill_weights()
            after = memory_idle(False)
            again = fn(x32).cpu()
            check(torch.equal(first, again), "a re-admitted mesh view "
                                             "answered differently")
            # memory: D copies of the model's bytes, not D·M
            base = memory_idle(True)
            probe = sm.for_mesh(make_mesh(
                {"data": n_data, "model": n_model},
                devices=[MESH_DEVICE] * (n_data * n_model)))
            rise = memory_idle(True) - base
            want = n_data * sm.param_global_bytes()
            check(abs(rise - want) <= PLANE_MEM_SLACK,
                  f"a {mesh_flag} view took {rise} B, want {want} B "
                  f"(D copies of the model's bytes)")
            del probe
            runs["fallback"].update(
                split_layers=len(split), call_devices=devices,
                control_faults=control, forward_ms=ms,
                spill={"host_bytes": spilled, "freed": before - after,
                       "bit_identical": True},
                view_bytes={"rise": rise, "want": want})
        finally:
            stop_server(engine, server)

        engine, server, runs["shard_batches"] = mesh_server(
            workdir, ["--shard-batches", "--serve-devices", "2"], bodies,
            refs, bound, 2)
        stop_server(engine, server)
        out["runs"] = runs
        out["launches"] = sum(r["launches"] for r in runs.values())
    log(f"mesh serving: {json.dumps(out)}")
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_phases(module) -> dict:
    """Wrap every ``phase_*`` function of ``module`` so that the wall
    seconds of its calls add up under its name; returns that dict, which
    fills as the phases run."""
    seconds: dict[str, float] = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) \
                    + time.monotonic() - t0
        return run

    for name in [n for n in vars(module) if n.startswith("phase_")]:
        setattr(module, name, timed(name[len("phase_"):],
                                    getattr(module, name)))
    return seconds


def phase_times_of(path: str) -> int:
    """Run the ``chip_smoke.py`` of another checkout at ``path`` (an
    earlier commit unpacked with ``git archive``) with its phases timed
    as this script times its own, and print its seconds a phase."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "other_chip_smoke", os.path.join(path, "chip_smoke.py"))
    other = importlib.util.module_from_spec(spec)
    # registered before it runs: its main() may time its own phases
    # through sys.modules[__name__]
    sys.modules[spec.name] = other
    spec.loader.exec_module(other)
    seconds = time_phases(other)
    rc = 1
    try:
        rc = other.main()
    finally:  # a failing phase still leaves the phases before it timed
        print(json.dumps({"phase_seconds_of": path, "rc": rc,
                          "phase_seconds": seconds}), flush=True)
    return rc


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs "
            "an NVIDIA GPU")
        return 2
    if not os.path.isdir(os.path.join(REPO, "deep_vision_tpu_torch")):
        log(f"FAIL: no deep_vision_tpu_torch package beside {__file__}; "
            f"run it from a checkout of the repository")
        return 2
    sys.path.insert(0, REPO)
    from deep_vision_tpu_torch.core.device import configure_precision

    configure_precision()  # float32 comparisons without TF32
    seconds = time_phases(sys.modules[__name__])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_s = phase_build()
    rows = phase_kernels()
    train_rows = phase_train_kernels()
    iou_rows = phase_iou_kernels()
    serving = phase_serving()
    training = phase_training()
    step_check = phase_step_check()
    native_input = phase_native_input(training)
    # the YOLOv3 run's records and workdir stay for phase_cli_tools
    keep = tempfile.mkdtemp(dir=os.path.join(REPO, "_scratch"))
    yolo = phase_yolo_training(keep)
    yolo_check = phase_yolo_step_check()
    detect = phase_detect_serving()
    heat_train, heat_check = {}, {}
    # the hourglass run's records stay for phase_pipeline_training
    pose_keep = tempfile.mkdtemp(dir=os.path.join(REPO, "_scratch"))
    for name in HEAT_MODELS:
        heat_train[name] = phase_heatmap_training(
            name, pose_keep if name == POSE_MODEL else None)
        heat_check[name] = phase_heatmap_step_check(name)
        torch.cuda.empty_cache()
    pose = phase_pose_serving()
    pipeline = phase_pipeline_training(os.path.join(pose_keep, "data"))
    shutil.rmtree(pose_keep)
    torch.cuda.empty_cache()
    zoo_steps = phase_zoo_steps()
    zoo_train = phase_zoo_training()
    lenet = phase_lenet_training()
    zoo_check = {}
    for name in ZOO_CHECK_MODELS:
        zoo_check[name] = phase_zoo_step_check(name)
    classify = phase_classify_serving()
    gan_train = phase_gan_training()
    gan_check = {}
    for name in GAN_MODELS:
        gan_check[name] = phase_gan_step_check(name)
        torch.cuda.empty_cache()
    recipes = phase_trainer_recipes(training, yolo)
    generate = phase_generate_serving()
    card_line = card()
    cli_tools = phase_cli_tools(card_line, {
        "model": "yolov3_coco", "work": os.path.join(keep, "work"),
        "data": os.path.join(keep, "data")})
    shutil.rmtree(keep)
    data_parallel = phase_data_parallel(training)
    faults = phase_faults(card_line)
    plane = phase_plane()
    fleet = phase_fleet()
    deploy = phase_deploy()
    cascade = phase_cascade(card_line)
    brownout = phase_brownout(card_line)
    gateway = phase_gateway(card_line)
    batch = phase_batch(card_line)
    mesh = phase_mesh_serving(card_line)
    main_row = next(r for r in rows if r["shape"] == [32, 224, 224, 3]
                    and r["out"] == "int8")
    by_path = {"classify_resnet50": serving["launches"],
               **{f"detect_{m}": detect[m]["launches"]
                  for m in DETECT_MODELS},
               f"pose_{POSE_MODEL}": pose["launches"],
               f"pose_{POSE_MODEL}_pipeline_workdir": pipeline["served"][
                   "launches"],
               **{f"classify_{m}": classify[m]["launches"]
                  for m, _, _ in CLASSIFY_MODELS},
               "classify_lenet5_workdir": lenet["served"]["launches"],
               "classify_resnet50_ema_workdir": recipes["resnet50"][
                   "served"]["launches"],
               **{f"generate_{k}": row["launches"]
                  for k, row in generate.items()},
               "faults_resnet50": faults["poison"]["launches"],
               "plane_eviction": plane["eviction"]["launches"],
               "plane_reload": plane["reload"]["launches"],
               **{f"plane_nan_{k}": row["launches"]
                  for k, row in plane["nan_rollback"].items()},
               "fleet_resnet50": fleet["serve"]["launches"],
               "deploy_resnet50": deploy["launches"],
               "cascade_classify": cascade["classify"]["launches"],
               "cascade_detect": cascade["detect"]["launches"],
               "brownout_resnet50": brownout["launches"],
               "gateway_resnet50": gateway["launches"],
               "batch_resnet50": batch["launches"],
               **{f"mesh_{k}_resnet50": run["launches"]
                  for k, run in mesh["runs"].items()},
               "stablehlo_resnet50": cli_tools["export"][
                   "serve_ingest_launches"]}
    zoo_serve_rows = [{k: r[k] for k in ("kind", "shape", "out", "ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err")}
                      for r in rows
                      if (r["kind"], tuple(r["shape"])) in ZOO_SERVE_CASES]
    detect_rows = [{k: r[k] for k in ("kind", "shape", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "max_abs_err")}
                   for r in rows if r["kind"] == "unit"
                   and r["shape"][0] == 32 and r["out"] == "int8"]
    kernels = [{"name": "serve_ingest", "route": "cuda",
                "source": "deep_vision_tpu_torch/csrc/serve_ingest.cu",
                "replaces": "deep_vision_tpu/ops/pallas_ops.py:77",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "detect_shapes": detect_rows,
                "zoo_shapes": zoo_serve_rows,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"],
                "shape": main_row["shape"], "build_s": build_s}]
    train_row = train_rows[0]
    train_by_path = {
        "train_resnet50": training["train_ingest_launches"],
        "recipes_resnet50_scan_ema": recipes["resnet50"][
            "train_ingest_launches"],
        "native_resnet50": native_input["train_ingest_launches"],
        **{f"dp_rank{r['rank']}_resnet50": r["fit"]["epoch1"][
            "train_ingest_launches"] + r["fit"]["epoch2"][
            "train_ingest_launches"] for r in data_parallel["ranks"]},
        **{f"dp_{k}_cli_resnet50": data_parallel["cli"][k]["launches"][
            "train_ingest"] for k in ("nccl", "resumed")},
        "train_inception3": zoo_train["launches"],
        "pretrained_resnet50": cli_tools["pretrained"][
            "train_ingest_launches"],
        **{f"{k}_resnet50": row["train_ingest_launches"]
           for k, row in cli_tools["host"].items()},
        **{f"steps_{m}": zoo_steps[m]["train_ingest_launches"]
           for m in ZOO_STEP_MODELS}}
    zoo_train_rows = [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "factors_ms",
                                         "max_abs_err")}
                      for r in train_rows if "edge" not in r
                      and tuple(r["shape"]) in ZOO_TRAIN_SHAPES]
    kernels.append({
        "name": "train_ingest", "route": "cuda",
        "source": "deep_vision_tpu_torch/csrc/train_ingest.cu",
        "replaces": "deep_vision_tpu/ops/pallas_ops.py:202",
        "launches": sum(train_by_path.values()),
        "launches_by_path": train_by_path, "zoo_shapes": zoo_train_rows,
        "edge_cases": [r["edge"] for r in train_rows if "edge" in r],
        "factors_ms": train_row["factors_ms"],
        "max_abs_err": max(r["max_abs_err"] for r in train_rows),
        "ms": train_row["ms"], "plain_ms": train_row["plain_ms"],
        "bound_ms": train_row["bound_ms"], "bound_by": train_row["bound_by"],
        "library_ms": train_row["library_ms"], "shape": train_row["shape"],
        "build_s": build_s})
    iou_row = iou_rows[0]
    iou_by_path = {"train_yolov3_coco": yolo["best_iou_max_launches"],
                   "recipes_yolov3_coco_accum": recipes["yolo_accum"][
                       "best_iou_max_launches"],
                   "recipes_yolov3_toy_scan": recipes["scan"]["tasks"][
                       "yolov3_toy"]["best_iou_max_launches"],
                   "recipes_yolov3_toy_scan_accum_ema": recipes["scan"][
                       "tasks"][" ".join(("yolov3_toy",) + RECIPE_TOY_ACCUM)][
                       "best_iou_max_launches"],
                   "infer_eval_yolov3_coco": cli_tools["eval"][
                       "best_iou_max_launches"],
                   **{f"dp_rank{r['rank']}_yolov3_coco": r["yolo"][
                       "best_iou_max_launches"]
                      for r in data_parallel["ranks"]}}
    micro_row = next(r for r in iou_rows
                     if tuple(r["shape"]) == IOU_MICRO_SHAPE)
    kernels.append({
        "name": "best_iou_max", "route": "cuda",
        "source": "deep_vision_tpu_torch/csrc/best_iou_max.cu",
        "replaces": "deep_vision_tpu/ops/pallas_ops.py:377",
        "launches": sum(iou_by_path.values()),
        "launches_by_path": iou_by_path,
        "microbatch_shape": {k: micro_row[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "differing")},
        "max_abs_err": max(r["max_abs_err"] for r in iou_rows),
        "ms": iou_row["ms"], "plain_ms": iou_row["plain_ms"],
        "bound_ms": iou_row["bound_ms"], "bound_by": iou_row["bound_by"],
        "library_ms": iou_row["library_ms"], "shape": iou_row["shape"],
        "build_s": build_s})
    print(json.dumps({"kernel_checks": rows}), flush=True)
    print(json.dumps({"train_kernel_checks": train_rows}), flush=True)
    print(json.dumps({"iou_kernel_checks": iou_rows}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"step_check": step_check}), flush=True)
    print(json.dumps({"native_input": native_input}), flush=True)
    print(json.dumps({"yolo_training": yolo}), flush=True)
    print(json.dumps({"yolo_step_check": yolo_check}), flush=True)
    print(json.dumps({"detect_serving": detect}), flush=True)
    print(json.dumps({"heatmap_training": heat_train}), flush=True)
    print(json.dumps({"heatmap_step_check": heat_check}), flush=True)
    print(json.dumps({"pose_serving": pose}), flush=True)
    print(json.dumps({"pipeline_training": pipeline}), flush=True)
    print(json.dumps({"zoo_steps": zoo_steps}), flush=True)
    print(json.dumps({"zoo_training": {"inception3": zoo_train,
                                       "lenet5": lenet}}), flush=True)
    print(json.dumps({"zoo_step_check": zoo_check}), flush=True)
    print(json.dumps({"classify_serving": classify}), flush=True)
    print(json.dumps({"gan_training": gan_train}), flush=True)
    print(json.dumps({"gan_step_check": gan_check}), flush=True)
    print(json.dumps({"trainer_recipes": recipes}), flush=True)
    print(json.dumps({"cli_tools": cli_tools}), flush=True)
    print(json.dumps({"data_parallel": data_parallel}), flush=True)
    print(json.dumps({"generate_serving": generate}), flush=True)
    print(json.dumps({"faults": faults}), flush=True)
    print(json.dumps({"plane": plane}), flush=True)
    print(json.dumps({"fleet": fleet}), flush=True)
    print(json.dumps({"deploy": deploy}), flush=True)
    print(json.dumps({"cascade": cascade}), flush=True)
    print(json.dumps({"brownout": dict(
        brownout, with_cascade=cascade["classify"]["brownout"])}),
        flush=True)
    print(json.dumps({"gateway": gateway}), flush=True)
    print(json.dumps({"batch": batch}), flush=True)
    print(json.dumps({"mesh_serving": mesh}), flush=True)
    print(json.dumps({"phase_seconds": seconds}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase-times-of":
        sys.exit(phase_times_of(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank_main(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) > 2 and sys.argv[1] == "--cli-train":
        sys.exit(cli_train_main(sys.argv[2:]))
    sys.exit(main())
