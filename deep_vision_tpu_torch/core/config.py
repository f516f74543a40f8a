"""Experiment configuration registry (the serving-side fields).

Port of ``deep_vision_tpu/core/config.py``: one dataclass per experiment,
registered by name.  This slice carries the fields serving reads; the
optimizer and schedule fields arrive with training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class TrainConfig:
    name: str
    model: Callable[[], Any]  # zero-arg constructor of the nn.Module
    task: str = "classification"
    image_size: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 42
    extra: dict = dataclasses.field(default_factory=dict)


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
