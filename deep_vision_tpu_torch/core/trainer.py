"""The Trainer: epoch loop of train → validate → schedule → checkpoint.

Port of ``deep_vision_tpu/core/trainer.py`` for one model and one
optimizer on one device.  A train step is

    step generator seeded from (seed, step) → preprocess_fn (on the card:
    the train_ingest kernel for ImageNet, the /255 scale for detection)
    → forward in training mode, the model's dropouts drawing from a
    second generator seeded from (seed, step) (the reference's per-step
    ``dropout`` rng; eval draws none) → task loss (YOLO's through the
    best_iou_max kernel on the card) → backward → guarded update of the
    optimizer ``config.optimizer.name`` picks (core/optim.py,
    core/state.py)

PyTorch runs eagerly: there is no jit and no donation.  Metrics
come back as device scalars and are fetched one step late at log
intervals, so the host loop does not wait on the device every step; eval
sums metrics on the device and fetches them once.  A task with
``eval_outputs`` (detection) also returns decoded outputs from the same
eval forward; they are copied to the host batch by batch into the task's
``make_host_evaluator()`` (mAP), whose metrics join the eval dict, and
the task's ``monitor`` ("mAP", "top1") picks the best checkpoint.

The recipe options (reference ``core/trainer.py``):

* ``grad_accum_steps = A``: the preprocess runs once on the whole batch,
  which then splits the reference's interleaved way (microbatch ``a`` is
  rows ``a, a+A, a+2A, …``); each microbatch draws its dropout from its
  own generator (stream ``2 + a``), the BatchNorm statistics thread
  through the microbatches in turn (A updates a step, all undone by a
  skipped step), and one update applies ``Σg / A`` with the loss and
  metrics averaged over the microbatches;
* ``ema_decay = d``: after the guarded commit the params EMA moves by
  ``min(d, (1+t)/(10+t))`` (``core/state.py``); eval (and the serving
  paths, ``core/restore.py``) scores the EMA copy with the raw BatchNorm
  statistics;
* ``scan_steps = K``: steps run in groups of K through
  ``core/step_graph.py`` (on the card one CUDA graph of the whole
  guarded step, replayed a step at a time), the host reads a group's
  metrics once, the guard sees every step, logging is once a group and
  a ragged tail of fewer than K batches runs as single steps.
  ``--profile`` is not traced in this mode.

Every step's randomness comes from generators the trainer keeps for the
run and re-seeds from ``(seed, step, stream)`` before each step, so a
replayed graph draws what an eager step draws.

Data parallelism (``mesh``, ``parallel/mesh.py``; the reference's
``Mesh`` with its ``data`` axis): one process a device, each a rank of
the ``torch.distributed`` group, each feeding its own shard of the
global batch (``cfg.batch_size`` a rank).  The init is broadcast from
rank 0; the BatchNorm layers normalize by the global batch's
statistics (``models/common.py``); after ``Σg / A`` one all-reduce of a
flat buffer of the gradients, the loss and the metrics makes them the
global batch's means, so the guard decides on the global loss and
every rank commits or skips the same step, with bit-identical weights.
Each rank folds its index into its step seeds (rank 0 keeps the
single-process ones); eval sums are all-reduced, and the host
evaluator's outputs are gathered to rank 0, whose metrics are
broadcast.  A SIGTERM on any rank stops every rank at the same step
boundary.  Rank 0 writes the checkpoints, ``metrics.jsonl`` and the
mirror while the others wait at barriers.  Without a group, or in a
group of one rank, a step is the single-process step bit for bit.

Pipeline parallelism (``parallel/pipelined.py``; ``mesh`` with a
``pipe`` axis, whose places lie inside each rank): the model is a
``PipelinedModel``, which places its stem and stages itself
(:meth:`Trainer.state_for`); only its stem's BatchNorm reduces across
the ranks.  Its parameters may lie on several devices: the gradient
all-reduce takes one flat buffer a device, and the guard's flag, the
learning rate and the EMA's decay reach each device as copies
(``core/optim.py``).  ``grad_accum_steps`` splits the batch the
interleaved way first, and the pipeline splits each part into
contiguous microbatches, the reference's order.  ``scan_steps``
captures a pipe grid whose places are one card; a grid of distinct
cards is refused (:func:`check_scan_backend`).

The metric logger writes ``metrics.jsonl`` and TensorBoard event files
under the workdir.  With ``upload`` (``cli.train --upload``) every
checkpoint directory is mirrored there after each save, and a fresh
workdir is first restored from the mirror (``core/upload.py``).
"""

from __future__ import annotations

import os
import time
from typing import Iterable

import numpy as np
import torch

from deep_vision_tpu_torch.core import checkpoint as ckpt_lib
from deep_vision_tpu_torch.core.config import TrainConfig
from deep_vision_tpu_torch.core.device import resolve_device
from deep_vision_tpu_torch.core.metrics import (
    MetricLogger,
    StepTimer,
    ThroughputMeter,
)
from deep_vision_tpu_torch.core.optim import (
    build_optimizer,
    build_scheduler,
    per_device,
)
from deep_vision_tpu_torch.core.state import DivergenceGuard, TrainState
from deep_vision_tpu_torch.core.step_graph import StepRunner, run_groups
from deep_vision_tpu_torch.models.common import (
    set_batchnorm_mesh,
    set_dropout_generator,
)
from deep_vision_tpu_torch.ops.ingest import device_scalar
from deep_vision_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
)


def install_sigterm_flag(on_sigterm):
    """Install a SIGTERM → callback handler; returns a restore function.
    A no-op off the main thread; restores SIG_DFL when the previous
    handler was installed outside Python."""
    import signal

    try:
        prev = signal.signal(signal.SIGTERM, lambda *_: on_sigterm())
    except ValueError:  # not the main thread: no handler, no-op restore
        return lambda: None
    restore_to = prev if prev is not None else signal.SIG_DFL
    return lambda: signal.signal(signal.SIGTERM, restore_to)


def step_seed(seed: int, step: int, stream: int | None = None,
              rank: int = 0) -> int:
    """The per-step rng seed: a hash of ``(seed, step)``, the counterpart
    of the reference's ``fold_in(rng, step)`` chain; ``stream`` (1 for
    dropout) derives an independent seed from the same pair.  A
    data-parallel rank above 0 folds its index in as the hash's spawn
    key, so the ranks draw independent jitter and dropout for their
    different images; rank 0 keeps the single-process seeds."""
    entropy = [int(seed), int(step)] + ([] if stream is None
                                        else [int(stream)])
    spawn = (int(rank),) if rank else ()
    return int(np.random.SeedSequence(entropy, spawn_key=spawn)
               .generate_state(1, np.uint64)[0] >> 1)


#: ``step_seed`` stream of the dropout generator; microbatch ``a`` of an
#: accumulated step draws from stream ``ACCUM_STREAM + a``
DROPOUT_STREAM = 1
ACCUM_STREAM = 2


class StepGenerators:
    """The per-step generators of one trainer, kept for the run on one
    device: ``get(stream)`` makes one on first use, ``seed(rng, step)``
    re-seeds every one from ``step_seed(rng, step, stream, rank)`` (the
    preprocess and draw stream is ``None``)."""

    def __init__(self, device: torch.device, rank: int = 0):
        self.device = device
        self.rank = int(rank)
        self._gens: dict = {}

    def get(self, stream: int | None = None) -> torch.Generator:
        if stream not in self._gens:
            self._gens[stream] = torch.Generator(device=self.device)
        return self._gens[stream]

    def seed(self, rng: int, step: int) -> None:
        for stream, gen in self._gens.items():
            gen.manual_seed(step_seed(rng, step, stream, self.rank))

    def all(self) -> list[torch.Generator]:
        return list(self._gens.values())


def check_recipe(config: TrainConfig) -> None:
    """The reference's checks of the recipe options."""
    ema = float(config.ema_decay)
    if not 0.0 <= ema < 1.0:
        raise ValueError(
            f"ema_decay={ema} must be in [0, 1): 1.0 would freeze the "
            f"EMA at its init forever, >1 diverges")
    for field in ("grad_accum_steps", "scan_steps"):
        if int(getattr(config, field)) < 1:
            raise ValueError(f"{field} must be at least 1, got "
                             f"{getattr(config, field)}")


def interleaved_split(batch: dict, parts: int) -> list[dict]:
    """The reference's microbatches: part ``a`` holds rows ``a, a+parts,
    a+2·parts, …`` of every tensor.  Raises its ``ValueError`` when the
    batch does not divide."""
    b = next(iter(batch.values())).shape[0]
    if b % parts:
        raise ValueError(f"global batch {b} not divisible by "
                         f"grad_accum_steps={parts}")
    return [{k: v[a::parts].contiguous() for k, v in batch.items()}
            for a in range(parts)]


def check_scan_backend(mesh, device: torch.device, scan_steps: int) -> None:
    """A captured step on the card holds its collectives, which NCCL can
    be captured with and gloo cannot, and runs on one card's stream, so
    a pipe grid of distinct cards cannot be captured: refuse
    ``scan_steps`` there."""
    cards = {d for d in getattr(mesh, "pipe_devices", ())
             if d.type == "cuda"}
    if scan_steps > 1 and len(cards) > 1:
        raise ValueError(
            f"scan_steps={scan_steps} captures the step as one CUDA graph "
            f"on one card's stream, and this rank's pipe grid spans "
            f"{len(cards)} cards ({sorted(map(str, cards))}), whose "
            f"hand-offs the capture cannot hold; lay the pipe places on "
            f"one card (--device cuda:K) or drop --scan-steps")
    if scan_steps > 1 and mesh.grouped and device.type == "cuda" \
            and mesh.backend != "nccl":
        raise ValueError(
            f"scan_steps={scan_steps} captures the step's collectives in "
            f"a CUDA graph, which the '{mesh.backend}' backend cannot be "
            f"captured with; run the ranks under nccl (one card a rank) "
            f"or drop --scan-steps")


def reduce_step(mesh, loss: torch.Tensor, aux: dict,
                grads: list[torch.Tensor]):
    """``(loss, aux, grads)`` as the global batch's means: one all-reduce
    of a flat buffer of all of them, divided by the ranks (the
    reference's gradient psum over ``data``)."""
    if not mesh.grouped:
        return loss, aux, grads
    keys = list(aux)
    out = mesh.mean_([*grads, loss, *(aux[k] for k in keys)])
    n = len(grads)
    return out[n], dict(zip(keys, out[n + 1:])), out[:n]


def gather_extras(mesh, extras: list) -> list:
    """The eval outputs of every rank's batches, on rank 0 (elsewhere
    none): batch ``b`` is the ranks' rows of their batch ``b`` in rank
    order (the reference's tiled all-gather over ``data``)."""
    if not mesh.grouped:
        return extras
    per_rank = mesh.gather_objects(extras)
    if per_rank is None:
        return []
    out = []
    for b in range(max(len(r) for r in per_rank)):
        parts = [r[b] for r in per_rank if b < len(r)]
        out.append({k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]})
    return out


def to_device(batch: dict, device: torch.device) -> dict:
    """Host numpy arrays → tensors on ``device`` (tensors already there
    pass through)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = t.to(device)
    return out


def log_input_stats(logger: MetricLogger, step: int, stats: dict,
                    epoch: int) -> None:
    """Log and print an epoch's input block (``DevicePrefetcher``
    stats), for both trainers."""
    if not stats or not stats.get("batches"):
        return
    logger.log_input_block(step, stats)
    prod = stats.get("producer_ms", {})
    n = max(1, stats["batches"])
    print(f"[input] epoch {epoch} stall {stats['input_stall_frac']:.1%} "
          f"h2d {stats['h2d_bytes_per_step'] / 1e6:.2f} MB/step "
          f"prep {prod.get('prep_wait', 0.0) / n:.1f} "
          f"assemble {prod.get('assemble', 0.0) / n:.1f} "
          f"h2d {prod.get('h2d', 0.0) / n:.1f} ms/batch "
          f"(pinned alloc {stats['pool']['allocated']} "
          f"reuse {stats['pool']['reused']})", flush=True)


class Trainer:
    """Single-model, single-optimizer trainer (classification and YOLO
    detection)."""

    def __init__(self, config: TrainConfig, model: torch.nn.Module, task,
                 workdir: str | None = None, preprocess_fn=None,
                 device=None, upload: str | None = None, mesh=None):
        check_recipe(config)
        self.config = config
        self.device = resolve_device(device)
        # the data axis over the process group's ranks (one rank and no
        # collective without a group)
        self.mesh = mesh if mesh is not None else make_mesh()
        check_scan_backend(self.mesh, self.device, config.scan_steps)
        self.accum = int(config.grad_accum_steps)
        self.ema_decay = float(config.ema_decay)
        self.generators = StepGenerators(self.device, self.mesh.rank)
        # the scan_steps runner of one state (a resume or a new state
        # makes a new one, which captures anew)
        self._runner: StepRunner | None = None
        self.model = model
        self.task = task
        if hasattr(task, "mesh"):  # a loss normalized over the global batch
            task.mesh = self.mesh
        # device-side input preprocessing, signature (batch, generator,
        # train): on the card the uint8 → jitter → normalize kernel
        self.preprocess_fn = preprocess_fn
        self.workdir = workdir or os.path.join("runs", config.name)
        self.logger = MetricLogger(self.workdir,
                                   writer=self.mesh.is_writer)
        self.scheduler = build_scheduler(
            config.scheduler.name, config.optimizer.learning_rate,
            **config.scheduler.kwargs)
        # checkpoints mirrored to ``upload`` after every save
        # (core/upload.py)
        self.uploader = None
        if upload:
            from deep_vision_tpu_torch.core.upload import ArtifactUploader

            self.uploader = ArtifactUploader(upload)
            # preemption recovery: a fresh host (empty workdir) pulls the
            # mirror's checkpoints back before anything looks for them;
            # otherwise its first sync would wipe the mirror's copies
            # (rank 0 pulls, the other ranks wait for it)
            ckpt_dir = os.path.join(self.workdir, "checkpoints")
            if self.mesh.is_writer and (not os.path.isdir(ckpt_dir)
                                        or not os.listdir(ckpt_dir)):
                self.uploader.restore(ckpt_dir, "checkpoints")
                self.uploader.restore(
                    os.path.join(self.workdir, "checkpoints_best"),
                    "checkpoints_best")
            self.mesh.barrier()
        self.checkpointer = ckpt_lib.Checkpointer(
            os.path.join(self.workdir, "checkpoints"),
            max_to_keep=config.keep_checkpoints, mesh=self.mesh)
        self.best_checkpointer = ckpt_lib.Checkpointer(
            os.path.join(self.workdir, "checkpoints_best"), max_to_keep=1,
            mesh=self.mesh)
        self.start_epoch = 1
        self.guard = DivergenceGuard(config.max_bad_steps)
        # preemption: SIGTERM asks for a step-boundary checkpoint and a
        # clean return (fit installs the handler)
        self._preempted = False
        # torch.profiler window over steps [start, stop) of the first epoch
        self.profile_steps: tuple[int, int] | None = None
        self.prefetch_depth = max(1, int(config.prefetch_depth))
        self._prefetcher = None

    # ------------------------------------------------------------------ init

    def init_state(self) -> TrainState:
        """The model at the reference's init from ``config.seed``, on the
        device (channels_last on CUDA, where cuDNN's NHWC convolutions are
        fastest), with a fresh optimizer."""
        self.model.reset_parameters(
            torch.Generator().manual_seed(self.config.seed))
        return self.state_for(self.model)

    def state_for(self, model: torch.nn.Module) -> TrainState:
        """A fresh TrainState around ``model``'s current weights (rank
        0's on every rank of the mesh).  A model that places itself (the
        pipelined model, on its pipe places) does; any other moves to
        the trainer's device."""
        if hasattr(model, "place"):
            model.place()
        else:
            model.to(self.device)
            if self.device.type == "cuda":
                model.to(memory_format=torch.channels_last)
        set_batchnorm_mesh(model, self.mesh)
        replicate(model, self.mesh)
        self.model = model
        return TrainState(model, build_optimizer(self.config.optimizer,
                                                 model),
                          rng=self.config.seed, ema=self.ema_decay > 0)

    def maybe_resume(self, state: TrainState) -> TrainState:
        """Resume from the latest checkpoint if one exists."""
        if self.checkpointer.latest_step() is None:
            return state
        state, extras = self.checkpointer.restore(state)
        self._runner = None  # the restored state is captured anew
        self.start_epoch = int(extras.get("epoch", 0)) + 1
        if "scheduler" in extras:
            self.scheduler.load_state_dict(extras["scheduler"])
        if "history" in extras:
            self.logger.load_state_dict(extras["history"])
        # old skips must not count against the resumed run's budget
        self.guard.set_baseline(int(state.bad_steps))
        print(f"[resume] restored step={state.step} "
              f"start_epoch={self.start_epoch}", flush=True)
        return state

    # ----------------------------------------------------------------- steps

    def _step_streams(self) -> list:
        """The generator streams a step draws from."""
        if self.accum == 1:
            return [None, DROPOUT_STREAM]
        return [None] + [ACCUM_STREAM + a for a in range(self.accum)]

    def seed_step(self, state: TrainState) -> None:
        """Seed every generator of the step ``state.step`` is about to
        take (host work only: a replayed graph reads the seeds)."""
        for stream in self._step_streams():
            self.generators.get(stream)
        self.generators.seed(state.rng, state.step)

    def train_step(self, state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        """One guarded optimizer step on this rank's shard of the global
        batch; metrics are 0-d device tensors (the global batch's)."""
        batch = shard_batch(batch, self.mesh, self.device)
        self.seed_step(state)
        metrics = self.device_step(state, batch)
        state.advance()
        return state, metrics

    def device_step(self, state: TrainState, batch: dict) -> dict:
        """The device work of one step on a device batch, with the
        generators seeded: preprocess → forward and backward (per
        microbatch) → the ranks' mean → guarded update → EMA.  Reads
        nothing from the host that changes between steps, so it may be
        captured."""
        model = state.model
        model.train()
        if self.preprocess_fn is not None:
            batch = self.preprocess_fn(batch, self.generators.get(None),
                                       True)
        stats_before = state.snapshot_stats()
        if self.accum == 1:
            loss, aux, grads = self._grads(
                state, batch, self.generators.get(DROPOUT_STREAM))
        else:
            loss, aux, grads = self._accumulated(state, batch)
        loss, aux, grads = reduce_step(self.mesh, loss, aux, grads)
        state.apply_gradients_if_finite(loss, grads, stats_before)
        if self.ema_decay:
            state.update_ema(self.ema_decay)
        return {"loss": loss, "bad_steps": state.bad_steps.clone(), **aux}

    def _grads(self, state: TrainState, batch: dict,
               gen: torch.Generator):
        """(loss, aux, gradients) of one forward and backward, the
        model's dropouts drawing from ``gen``."""
        model = state.model
        params = state.opt.params
        for p in params:
            p.grad = None
        set_dropout_generator(model, gen)
        try:
            loss, aux = self.task.loss(model(batch["image"]), batch)
        finally:
            set_dropout_generator(model, None)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        for p in params:
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def _accumulated(self, state: TrainState, batch: dict):
        """(mean loss, mean aux, ``Σg / A``) over the interleaved
        microbatches of ``batch``."""
        losses, auxes, gsum = [], [], None
        for a, micro in enumerate(interleaved_split(batch, self.accum)):
            loss, aux, grads = self._grads(
                state, micro, self.generators.get(ACCUM_STREAM + a))
            losses.append(loss)
            auxes.append(aux)
            if gsum is None:
                gsum = grads
            else:
                torch._foreach_add_(gsum, grads)
        grads = torch._foreach_div(
            gsum, per_device(device_scalar(float(self.accum), self.device),
                             state.opt.devices))
        aux = {k: torch.stack([x[k] for x in auxes]).mean()
               for k in auxes[0]}
        return torch.stack(losses).mean(), aux, grads

    @torch.no_grad()
    def _eval_forward(self, state: TrainState, batch: dict):
        """One eval forward: (metric sums, decoded outputs or None), both
        device tensors.  The outputs carry the batch's ``weight``.  With
        the EMA on, the forward runs the EMA parameters and leaves the
        training parameters alone."""
        state.model.eval()
        batch = shard_batch(batch, self.mesh, self.device)
        if self.preprocess_fn is not None:
            batch = self.preprocess_fn(batch, None, False)
        if state.ema:  # the EMA copy, with the raw BatchNorm statistics
            out = torch.func.functional_call(state.model, state.ema_named(),
                                             (batch["image"],))
        else:
            out = state.model(batch["image"])
        sums = self.task.eval_metrics(out, batch)
        extra = None
        if hasattr(self.task, "eval_outputs"):
            extra = self.task.eval_outputs(out, batch)
            if "weight" in batch:
                extra["weight"] = batch["weight"]
        return sums, extra

    def eval_step(self, state: TrainState, batch: dict) -> dict:
        """Metric sums (device tensors) for one batch."""
        return self._eval_forward(state, batch)[0]

    # ----------------------------------------------------------------- loops

    def evaluate(self, state: TrainState, val_data: Iterable) -> dict:
        """Mean eval metrics over ``val_data`` (every rank's shard), with
        the host evaluator's metrics (mAP) where the task has one: rank 0
        computes them over every rank's outputs and broadcasts them."""
        make_ev = getattr(self.task, "make_host_evaluator", None)
        evaluator = make_ev() if make_ev is not None else None
        totals: dict[str, torch.Tensor] = {}
        extras: list = []
        for batch in val_data:
            sums, extra = self._eval_forward(state, batch)
            for k, v in sums.items():
                totals[k] = totals[k] + v if k in totals else v
            if evaluator is not None and extra is not None:
                extras.append({k: v.cpu().numpy() for k, v in extra.items()})
        keys = sorted(totals)
        if self.mesh.grouped and keys:
            summed = self.mesh.all_reduce_(torch.stack(
                [totals[k].to(torch.float32) for k in keys]))
            totals = dict(zip(keys, summed))
        host = {k: float(v) for k, v in totals.items()}
        count = max(host.pop("count", 1.0), 1.0)
        out = {k: v / count for k, v in host.items()}
        if evaluator is not None:
            for extra in gather_extras(self.mesh, extras):
                evaluator.add_batch(extra)
            ev = evaluator.compute() if self.mesh.is_writer else None
            out.update(self.mesh.broadcast_object(ev))
        return out

    def _get_prefetcher(self):
        if self._prefetcher is None:
            from deep_vision_tpu_torch.data.pipeline import DevicePrefetcher

            self._prefetcher = DevicePrefetcher(self.device,
                                                depth=self.prefetch_depth)
        return self._prefetcher

    def _log_input_stats(self, step: int, stats: dict, epoch: int):
        log_input_stats(self.logger, step, stats, epoch)

    def _log_metrics(self, step: int, metrics: dict) -> dict:
        m = {k: float(v) for k, v in metrics.items()}
        self.guard.check(m)
        self.logger.log_dict(step, {f"train_{k}": v for k, v in m.items()})
        return m

    def train_epoch(self, state: TrainState, train_data: Iterable,
                    epoch: int) -> TrainState:
        cfg = self.config
        if cfg.scan_steps > 1:
            return self._train_epoch_scan(state, train_data, epoch)
        meter = ThroughputMeter()
        timer = StepTimer(self.device)
        pending = None  # metrics fetched one step late
        profiling = self.profile_steps if epoch == self.start_epoch else None
        prof = None
        stream = self._get_prefetcher().iterate(train_data)
        timer.mark()
        bs = 0
        for i, batch in enumerate(stream):
            if profiling is not None and i == profiling[0]:
                prof = self._start_profile()
            state, metrics = self.train_step(state, batch)
            timer.mark()
            bs = len(batch["image"])
            meter.update(bs)
            if pending is not None and i % cfg.log_every_steps == 0:
                m = self._log_metrics(state.step - 1, pending)
                print(f"Epoch {epoch} Batch {i} loss {m['loss']:.4f} "
                      f"lr {self.scheduler.lr:.2e} "
                      f"{meter.images_per_sec:.1f} img/s", flush=True)
            pending = metrics
            if prof is not None and i + 1 == profiling[1]:
                prof = self._stop_profile(prof)
            if self._stopping():
                print("[preempt] SIGTERM — stopping at step boundary",
                      flush=True)
                break
        if prof is not None:  # the epoch ended inside the window
            prof = self._stop_profile(prof)
        if pending is not None:
            self._log_metrics(state.step, pending)
        step_ms = timer.mean_ms()
        if step_ms is not None:
            self.logger.log("train_step_ms", state.step, step_ms)
            self.logger.log("images_per_sec", state.step,
                            bs * 1e3 / step_ms)
        self._log_input_stats(state.step, stream.stats(), epoch)
        return state

    def step_runner(self, state: TrainState) -> StepRunner:
        """The ``scan_steps`` runner of ``state`` (made on first use, and
        anew for another state or after a resume)."""
        if self._runner is None or self._runner.owner is not state:
            self.seed_step(state)  # every stream's generator exists
            self._runner = StepRunner(
                lambda batch: self.device_step(state, batch),
                self.generators.all(), self.device, self.config.scan_steps,
                owner=state)
        return self._runner

    def _train_epoch_scan(self, state: TrainState, train_data: Iterable,
                          epoch: int) -> TrainState:
        """The epoch in groups of ``scan_steps`` steps through
        :func:`run_groups` (on the card each step after the warmup is a
        replay of the captured step); the metrics of a group are read
        once, and the guard sees every step; a ragged tail runs as
        single steps."""
        K = self.config.scan_steps
        if self.profile_steps is not None and epoch == self.start_epoch:
            print(f"[profile] --profile is not traced with --scan-steps "
                  f"{K}; profile a single-step run instead", flush=True)
        runner = self.step_runner(state)
        meter = ThroughputMeter()
        timer = StepTimer(self.device, warmup=runner.untimed_steps)
        bs = 0

        def on_step(batch):
            nonlocal bs
            timer.mark()
            bs = len(batch["image"])
            meter.update(bs)

        def on_group(steps):
            for m in steps:
                self.guard.check(m)
            self.logger.log_dict(state.step, {f"train_{k}": v
                                              for k, v in steps[-1].items()})
            print(f"Epoch {epoch} Step {state.step} "
                  f"loss {steps[-1]['loss']:.4f} "
                  f"lr {self.scheduler.lr:.2e} "
                  f"{meter.images_per_sec:.1f} img/s", flush=True)

        stream = self._get_prefetcher().iterate(train_data)
        timer.mark()
        tail = run_groups(
            (shard_batch(b, self.mesh, self.device) for b in stream),
            runner, lambda: self.seed_step(state), state.advance, on_step,
            on_group, self._stopping)
        if self._preempted:
            print("[preempt] SIGTERM — stopping at group boundary",
                  flush=True)
        for batch in tail:  # the ragged tail: single steps
            if self._stopping():
                break
            state, metrics = self.train_step(state, batch)
            self._log_metrics(state.step, metrics)
        step_ms = timer.mean_ms()
        if step_ms is not None:
            self.logger.log("train_step_ms", state.step, step_ms)
            self.logger.log("images_per_sec", state.step,
                            bs * 1e3 / step_ms)
        self._log_input_stats(state.step, stream.stats(), epoch)
        return state

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof):
        prof.__exit__(None, None, None)
        out = os.path.join(self.workdir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        print(f"[profile] trace written to {out}/trace.json", flush=True)
        return None

    def fit(self, train_data, val_data=None, state: TrainState | None = None,
            resume: bool = False, monitor: str | None = None) -> TrainState:
        """Epoch loop: train → validate → scheduler.step(metric) →
        checkpoint (and the best-val checkpoint)."""
        if state is None:
            state = self.init_state()
        if resume:
            state = self.maybe_resume(state)
        monitor = monitor or getattr(self.task, "monitor", None)
        restore_handler = self._install_preempt_handler()
        try:
            return self._fit_epochs(train_data, val_data, state, monitor)
        finally:
            restore_handler()
            # an abandoned epoch must not leave its producer thread or
            # device batches behind
            if self._prefetcher is not None:
                self._prefetcher.close()

    def _install_preempt_handler(self):
        self._preempted = False  # a stale flag must not abort a fresh fit
        return install_sigterm_flag(
            lambda: setattr(self, "_preempted", True))

    def _stopping(self) -> bool:
        """Whether SIGTERM reached this rank or any other (a step
        boundary's agreement, so every rank stops at the same step)."""
        if self.mesh.reduces:
            self._preempted = self.mesh.any(self._preempted)
        return self._preempted

    def _fit_epochs(self, train_data, val_data, state, monitor):
        cfg = self.config
        best = None
        for epoch in range(self.start_epoch, cfg.total_epochs + 1):
            lr = self.scheduler.epoch_begin(epoch)
            state.opt.set_learning_rate(lr)
            if hasattr(train_data, "set_epoch"):
                train_data.set_epoch(epoch)
            t0 = time.monotonic()
            state = self.train_epoch(state, train_data, epoch)
            if self._stopping():
                # mid-epoch save as epoch-1: resume re-runs this epoch
                # from its start but keeps every applied update
                self.save(state, epoch - 1)
                print(f"[preempt] checkpoint saved at step {state.step}; "
                      f"rerun with --resume to continue", flush=True)
                return state
            metric_val = None
            if val_data is not None:
                val_metrics = self.evaluate(state, val_data)
                self.logger.log_dict(
                    state.step,
                    {f"val_{k}": v for k, v in val_metrics.items()})
                if monitor is not None:
                    metric_val = val_metrics.get(monitor)
                print(f"Epoch {epoch} val "
                      + " ".join(f"{k}={v:.4f}"
                                 for k, v in val_metrics.items())
                      + f" ({time.monotonic() - t0:.1f}s)", flush=True)
            if self._stopping():
                self.save(state, epoch)
                print(f"[preempt] checkpoint saved at step {state.step}; "
                      f"rerun with --resume to continue", flush=True)
                return state
            self.scheduler.step(epoch, metric_val)
            if epoch % cfg.checkpoint_every_epochs == 0:
                self.save(state, epoch)
            if metric_val is not None and (best is None or metric_val > best):
                best = metric_val
                self.best_checkpointer.save(
                    state.step, state,
                    extras={"epoch": epoch, "metric": float(metric_val),
                            "monitor": monitor or ""})
                self._upload(self.best_checkpointer, "checkpoints_best")
        return state

    def save(self, state: TrainState, epoch: int):
        self.checkpointer.save(
            state.step, state,
            extras={"epoch": epoch,
                    "scheduler": self.scheduler.state_dict(),
                    "history": self.logger.state_dict()})
        self._upload(self.checkpointer, "checkpoints")

    def _upload(self, checkpointer, name: str) -> None:
        """Mirror ``checkpointer``'s directory (rank 0; the others wait)."""
        if self.uploader is None:
            return
        if self.mesh.is_writer:
            self.uploader.sync(checkpointer.directory, name)
        self.mesh.barrier()
