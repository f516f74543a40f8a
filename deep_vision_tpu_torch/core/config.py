"""Experiment configuration registry.

Port of ``deep_vision_tpu/core/config.py``: one dataclass per experiment,
registered by name, with the serving fields and the training recipe
(batch, optimizer, LR schedule, checkpoint cadence, divergence guard).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from deep_vision_tpu_torch.core.optim import OptimizerConfig


@dataclasses.dataclass
class SchedulerConfig:
    name: str = "constant"  # see core.optim.SCHEDULERS
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainConfig:
    name: str
    model: Callable[[], Any]  # zero-arg constructor of the nn.Module
    task: str = "classification"
    batch_size: int = 128  # the batch of one optimizer step
    eval_batch_size: int | None = None
    total_epochs: int = 90
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    label_smoothing: float = 0.0
    half_precision: bool = True  # bf16 activations/compute
    image_size: int = 224
    channels: int = 3
    num_classes: int = 1000
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 3
    log_every_steps: int = 10
    # divergence guard: non-finite steps are skipped and counted; the run
    # halts once more than this many were skipped
    max_bad_steps: int = 100
    # staged H2D prefetch: device batches queued ahead of the step
    prefetch_depth: int = 2
    # steps a group (on the card: replays of one captured CUDA graph,
    # metrics read once a group), microbatches per optimizer update, and
    # the params EMA's decay (0 = off; eval and serving use the EMA)
    scan_steps: int = 1
    grad_accum_steps: int = 1
    ema_decay: float = 0.0
    seed: int = 42
    extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.eval_batch_size is None:
            self.eval_batch_size = self.batch_size


_REGISTRY: dict[str, Callable[[], TrainConfig]] = {}


def register_config(name: str):
    def deco(fn: Callable[[], TrainConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> TrainConfig:
    # import for side effects: each zoo module registers its configs
    import deep_vision_tpu_torch.zoo  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown config '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    import deep_vision_tpu_torch.zoo  # noqa: F401

    return sorted(_REGISTRY)
