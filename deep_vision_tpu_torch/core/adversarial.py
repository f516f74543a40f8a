"""AdversarialTrainer: several networks, one optimizer each, one guard.

Port of ``deep_vision_tpu/core/adversarial.py`` for the GAN tasks
(``tasks/gan.py``) on one device.  A step is

    the batch on the device → ``preprocess_fn`` (the uint8 wire's
    [-1, 1] scaling) → the task's draws from the step generator (DCGAN:
    z and dropout masks) → ``task.train_step`` (every network's
    gradients) → every optimizer's proposal → one joint guard → commit

The guard is the reference's ``_guarded_step``: if any loss or any
proposed parameter of any network is non-finite, every network keeps
its parameters, optimizer state and BatchNorm statistics, and each
counts a bad step; there is no host sync.  Between steps the task's
``host_update`` takes the step's host outputs and its ``host_prepare``
rewrites the next batch (CycleGAN's image pools).  A ``prefetch_safe``
task (DCGAN) reads its batches through the staged ``DevicePrefetcher``
with its input-stall block; the others iterate directly.  Every epoch
sets the scheduler's learning rate on every optimizer; every
``checkpoint_every_epochs`` all networks go into one checkpoint with
``{"epoch", "scheduler"}``, and SIGTERM saves one at the step boundary.
The image pools are host state and are not checkpointed: a resumed run
(a new task) starts with empty pools, as the reference's does.

``scan_steps = K > 1`` runs a ``scan_safe`` task (DCGAN: no host state
between steps) in groups of K through ``core/step_graph.py`` (on the
card one CUDA graph of the joint G/D step with its guard, replayed a
step at a time), reading a group's metrics once and showing the guard
every step; a ragged tail runs as single steps.  A task that is not
scan-safe (CycleGAN's image pools) runs per step, as the reference does.
``fit(..., sample_hook=f)`` calls ``f(epoch, states)`` after each
epoch's checkpoint.

Under a data-parallel ``mesh`` (``parallel/mesh.py``) every network is
initialized on rank 0 and broadcast, its BatchNorm layers normalize by
the global batch, and each network's gradients with the step's losses
become the global batch's means through one all-reduce of a flat
buffer before the proposals, so the joint guard sees the same values
and decides the same on every rank (``core/trainer.py``, the same
rules: rank-folded step seeds, rank 0 writes, SIGTERM agreed at the
step boundary).  Gradient accumulation is refused, as the reference
refuses it; so is ``ema_decay``, which the reference accepts and
ignores.
"""

from __future__ import annotations

import os
import time

import torch

from deep_vision_tpu_torch.core import checkpoint as ckpt_lib
from deep_vision_tpu_torch.core.config import TrainConfig
from deep_vision_tpu_torch.core.device import resolve_device
from deep_vision_tpu_torch.core.metrics import (
    MetricLogger,
    StepTimer,
    ThroughputMeter,
)
from deep_vision_tpu_torch.core.optim import build_optimizer, build_scheduler
from deep_vision_tpu_torch.core.state import (
    DivergenceGuard,
    TrainState,
    all_finite,
)
from deep_vision_tpu_torch.core.step_graph import StepRunner, run_groups
from deep_vision_tpu_torch.core.trainer import (
    StepGenerators,
    check_recipe,
    check_scan_backend,
    install_sigterm_flag,
    log_input_stats,
)
from deep_vision_tpu_torch.models.common import set_batchnorm_mesh
from deep_vision_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
)

#: the reference's per-step rng chain starts from ``seed + 17``
RNG_OFFSET = 17


class AdversarialTrainer:
    def __init__(self, config: TrainConfig, task, workdir: str | None = None,
                 preprocess_fn=None, device=None, upload: str | None = None,
                 mesh=None):
        check_recipe(config)
        if config.grad_accum_steps > 1:
            raise NotImplementedError(
                "grad_accum_steps applies to the single-optimizer Trainer "
                "only; adversarial steps update G and D from the same "
                "forward, so accumulate by lowering batch_size instead")
        if config.ema_decay:
            raise NotImplementedError(
                f"ema_decay={config.ema_decay}: the adversarial trainer "
                f"keeps no params EMA (the reference's accepts the option "
                f"and ignores it)")
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        if getattr(task, "scan_safe", False):
            check_scan_backend(self.mesh, self.device, config.scan_steps)
        self.generators = StepGenerators(self.device, self.mesh.rank)
        self._runner: StepRunner | None = None
        self.task = task
        # signature (batch, generator, train), as the Trainer's
        self.preprocess_fn = preprocess_fn
        self.workdir = workdir or os.path.join("runs", config.name)
        self.logger = MetricLogger(self.workdir,
                                   writer=self.mesh.is_writer)
        self.scheduler = build_scheduler(
            config.scheduler.name, config.optimizer.learning_rate,
            **config.scheduler.kwargs)
        self.checkpointer = ckpt_lib.Checkpointer(
            os.path.join(self.workdir, "checkpoints"),
            max_to_keep=config.keep_checkpoints, mesh=self.mesh)
        # checkpoints mirrored to ``upload`` after every save
        # (core/upload.py)
        self.uploader = None
        if upload:
            from deep_vision_tpu_torch.core.upload import ArtifactUploader

            self.uploader = ArtifactUploader(upload)
        self.start_epoch = 1
        self.guard = DivergenceGuard(config.max_bad_steps)
        self._preempted = False
        self.prefetch_depth = max(1, int(config.prefetch_depth))
        self._prefetcher = None

    # ------------------------------------------------------------------ init

    def init_states(self) -> dict:
        """Every network at flax's default init from ``config.seed`` on
        the device (channels_last on CUDA), each with a fresh optimizer
        of the task's ``opt``."""
        models = self.task.init_models(
            torch.Generator().manual_seed(self.config.seed))
        return self.states_for(models)

    def states_for(self, models: dict) -> dict:
        """Fresh TrainStates around ``models``' current weights."""
        states = {}
        for name, model in models.items():
            model.to(self.device)
            if self.device.type == "cuda":
                model.to(memory_format=torch.channels_last)
            set_batchnorm_mesh(model, self.mesh)
            replicate(model, self.mesh)
            states[name] = TrainState(
                model, build_optimizer(self.task.opt, model),
                rng=self.config.seed + RNG_OFFSET)
        return states

    def maybe_resume(self, states: dict) -> dict:
        if self.checkpointer.latest_step() is None:
            return states
        states, extras = self.checkpointer.restore_tree(states)
        self._runner = None  # the restored states are captured anew
        self.start_epoch = int(extras.get("epoch", 0)) + 1
        if "scheduler" in extras:
            self.scheduler.load_state_dict(extras["scheduler"])
        first = next(iter(states.values()))
        self.guard.set_baseline(int(first.bad_steps))
        print(f"[resume] adversarial start_epoch={self.start_epoch} "
              f"step={first.step}", flush=True)
        return states

    # ----------------------------------------------------------------- steps

    def seed_step(self, states: dict) -> None:
        """Seed the draw generator from the first network's seed and step
        (host work only: a replayed graph reads the seed)."""
        first = next(iter(states.values()))
        self.generators.get(None)
        self.generators.seed(first.rng, first.step)

    def train_step(self, states: dict, batch: dict, draws: dict | None = None
                   ) -> tuple[dict, dict]:
        """One guarded step of every network; returns the task's host
        outputs and the metrics (0-d device tensors, ``bad_steps``
        included).  ``draws`` replaces the task's own draw (tests and
        card-vs-CPU checks feed the same draws to both sides)."""
        batch = shard_batch(batch, self.mesh, self.device)
        self.seed_step(states)
        outputs, metrics = self.device_step(states, batch, draws)
        for st in states.values():
            st.advance()
        return outputs, metrics

    def device_step(self, states: dict, batch: dict,
                    draws: dict | None = None) -> tuple[dict, dict]:
        """The device work of one step on a device batch, the draw
        generator seeded: preprocess → draws → the task's gradients →
        every proposal → one joint guard → commit.  Reads nothing from
        the host that changes between steps, so it may be captured."""
        if self.preprocess_fn is not None:
            batch = self.preprocess_fn(batch, None, True)
        if draws is None and hasattr(self.task, "draw"):
            bs = len(next(iter(batch.values())))
            draws = self.task.draw(bs, self.generators.get(None),
                                   self.device)
        before = {}
        for name, st in states.items():
            st.model.train()
            before[name] = st.snapshot_stats()
        grads, outputs, metrics = self.task.train_step(states, batch, draws)
        grads, metrics = self._reduce(grads, metrics)
        proposals = {name: st.opt.propose(grads[name])
                     for name, st in states.items()}
        ok = all_finite(list(metrics.values())) & all_finite(
            [p for name, st in states.items()
             for p in st.opt.proposed_params(proposals[name])])
        for name, st in states.items():
            st.commit(proposals[name], ok, before[name])
        first = next(iter(states.values()))
        return outputs, dict(metrics, bad_steps=first.bad_steps.clone())

    def _reduce(self, grads: dict, metrics: dict) -> tuple[dict, dict]:
        """Every network's gradients and the step's losses as the global
        batch's means: one all-reduce of a flat buffer of all of them."""
        if not self.mesh.grouped:
            return grads, metrics
        names, keys = list(grads), list(metrics)
        flat = [g for n in names for g in grads[n]] + \
            [metrics[k] for k in keys]
        out = self.mesh.mean_(flat)
        reduced, i = {}, 0
        for n in names:
            reduced[n] = out[i:i + len(grads[n])]
            i += len(grads[n])
        return reduced, dict(zip(keys, out[i:]))

    def _stopping(self) -> bool:
        """Whether SIGTERM reached this rank or any other."""
        if self.mesh.reduces:
            self._preempted = self.mesh.any(self._preempted)
        return self._preempted

    def step_runner(self, states: dict) -> StepRunner:
        """The ``scan_steps`` runner of ``states`` (made on first use, and
        anew for other states or after a resume)."""
        if self._runner is None or self._runner.owner is not states:
            self.generators.get(None)
            self._runner = StepRunner(
                lambda batch: self.device_step(states, batch)[1],
                self.generators.all(), self.device, self.config.scan_steps,
                owner=states)
        return self._runner

    # ----------------------------------------------------------------- loops

    def fit(self, train_data, epochs: int | None = None,
            states: dict | None = None, resume: bool = False,
            sample_hook=None) -> dict:
        """The epoch loop; ``sample_hook(epoch, states)``, when given, runs
        after each epoch's checkpoint."""
        epochs = epochs or self.config.total_epochs
        if states is None:
            states = self.init_states()
        if resume:
            states = self.maybe_resume(states)
        self._preempted = False  # a stale flag must not abort a fresh fit
        restore = install_sigterm_flag(
            lambda: setattr(self, "_preempted", True))
        try:
            return self._fit_epochs(train_data, epochs, states, sample_hook)
        finally:
            restore()
            if self._prefetcher is not None:
                self._prefetcher.close()

    def _fit_epochs(self, train_data, epochs: int, states: dict,
                    sample_hook=None) -> dict:
        cfg = self.config
        scan = cfg.scan_steps > 1 and getattr(self.task, "scan_safe", False)
        for epoch in range(self.start_epoch, epochs + 1):
            lr = self.scheduler.epoch_begin(epoch)
            for st in states.values():
                st.opt.set_learning_rate(lr)
            if hasattr(train_data, "set_epoch"):
                train_data.set_epoch(epoch)
            t0 = time.monotonic()
            run = self._epoch_scan if scan else self._epoch
            run(train_data, states, epoch)
            if self._stopping():
                self._save(states, epoch - 1)
                print(f"[preempt] checkpoint saved at step "
                      f"{next(iter(states.values())).step}; rerun with "
                      f"--resume to continue", flush=True)
                return states
            self.scheduler.step(epoch, None)
            print(f"Epoch {epoch} done in {time.monotonic() - t0:.1f}s",
                  flush=True)
            if epoch % cfg.checkpoint_every_epochs == 0:
                self._save(states, epoch)
            if sample_hook is not None:
                sample_hook(epoch, states)
        return states

    def _save(self, states: dict, epoch: int) -> None:
        self.checkpointer.save_tree(
            next(iter(states.values())).step, states,
            extras={"epoch": epoch,
                    "scheduler": self.scheduler.state_dict()})
        if self.uploader is not None:
            if self.mesh.is_writer:
                self.uploader.sync(self.checkpointer.directory,
                                   "checkpoints")
            self.mesh.barrier()

    def _get_prefetcher(self):
        if self._prefetcher is None:
            from deep_vision_tpu_torch.data.pipeline import DevicePrefetcher

            self._prefetcher = DevicePrefetcher(self.device,
                                                depth=self.prefetch_depth)
        return self._prefetcher

    def _log_metrics(self, epoch: int, step: int, metrics: dict,
                     meter: ThroughputMeter) -> None:
        m = {k: float(v) for k, v in metrics.items()}
        self.guard.check(m)
        self.logger.log_dict(step, m)
        print(f"Epoch {epoch} Step {step} "
              + " ".join(f"{k}={v:.4f}" for k, v in m.items())
              + f" {meter.images_per_sec:.1f} img/s", flush=True)

    def _epoch(self, train_data, states: dict, epoch: int) -> bool:
        """One epoch of guarded steps; True when SIGTERM stopped it.
        Metrics are fetched one step late at log intervals, so the host
        does not wait on the device every step (the pool's host update
        does, for CycleGAN)."""
        cfg = self.config
        task = self.task
        meter = ThroughputMeter()
        timer = StepTimer(self.device)
        staged = getattr(task, "prefetch_safe", False)
        stream = self._get_prefetcher().iterate(
            map(task.host_prepare, train_data)) if staged else None
        pending = None
        bs = 0
        first = next(iter(states.values()))
        timer.mark()
        try:
            for batch in (stream if staged else train_data):
                if not staged:
                    batch = task.host_prepare(batch)
                outputs, metrics = self.train_step(states, batch)
                task.host_update(outputs)
                timer.mark()
                bs = len(next(iter(batch.values())))
                meter.update(bs)
                if pending is not None and \
                        pending[0] % cfg.log_every_steps == 0:
                    self._log_metrics(epoch, *pending, meter)
                pending = (first.step, metrics)
                if self._stopping():
                    break
            if pending is not None:
                self._log_metrics(epoch, *pending, meter)
            return self._preempted
        finally:
            step_ms = timer.mean_ms()
            if step_ms is not None:
                self.logger.log("train_step_ms", first.step, step_ms)
                self.logger.log("images_per_sec", first.step,
                                bs * 1e3 / step_ms)
            if stream is not None:
                log_input_stats(self.logger, first.step, stream.stats(),
                                epoch)

    def _epoch_scan(self, train_data, states: dict, epoch: int) -> bool:
        """One epoch of a scan-safe task in groups of ``scan_steps``
        through :func:`run_groups` (the reference's ``_epoch_scan``);
        True when SIGTERM stopped it.  The metrics of a group are read
        once, every step's by the guard; a ragged tail runs as single
        steps."""
        task = self.task
        runner = self.step_runner(states)
        meter = ThroughputMeter()
        timer = StepTimer(self.device, warmup=runner.untimed_steps)
        first = next(iter(states.values()))
        bs = 0

        def on_step(batch):
            nonlocal bs
            timer.mark()
            bs = len(next(iter(batch.values())))
            meter.update(bs)

        def advance():
            for st in states.values():
                st.advance()

        def on_group(steps):
            for m in steps:
                self.guard.check(m)
            self.logger.log_dict(first.step, steps[-1])
            print(f"Epoch {epoch} Step {first.step} "
                  + " ".join(f"{k}={v:.4f}" for k, v in steps[-1].items())
                  + f" {meter.images_per_sec:.1f} img/s", flush=True)

        stream = self._get_prefetcher().iterate(
            map(task.host_prepare, train_data))
        timer.mark()
        try:
            tail = run_groups(
                (shard_batch(b, self.mesh, self.device) for b in stream),
                runner, lambda: self.seed_step(states), advance, on_step,
                on_group, self._stopping)
            for batch in tail:  # the ragged tail: single steps
                if self._stopping():
                    break
                outputs, metrics = self.train_step(states, batch)
                task.host_update(outputs)
                self._log_metrics(epoch, first.step, metrics, meter)
            return self._preempted
        finally:
            step_ms = timer.mean_ms()
            if step_ms is not None:
                self.logger.log("train_step_ms", first.step, step_ms)
                self.logger.log("images_per_sec", first.step,
                                bs * 1e3 / step_ms)
            log_input_stats(self.logger, first.step, stream.stats(), epoch)
