"""SGD with decoupled-mask weight decay, and host LR schedulers.

Port of ``deep_vision_tpu/core/optim.py``: ``OptimizerConfig``, the SGD
chain of ``build_optimizer`` (optax ``add_decayed_weights`` then
``sgd(momentum)``), and the host-side schedulers, which are pure Python.
Per parameter ``p`` with gradient ``g``:

    d   = g + wd·p            (only where the decay mask is set)
    buf = momentum·buf + d    (buf starts at zeros)
    p   = p − lr·buf

The update runs as ``torch._foreach_*`` ops with the learning rate in a
device tensor (the role of optax's ``inject_hyperparams``), so a
scheduler changes it between epochs and the divergence guard
(``core/state.py``) selects the result on a device flag, with no host
sync.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "sgd"  # sgd; adam and rmsprop are not ported
    learning_rate: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0  # on the decay mask (no BN, no bias)
    # the reference's options below are not ported: SGD refuses them
    grad_clip_norm: float | None = None
    momentum_dtype: str | None = None


def weight_decay_mask(model: nn.Module) -> dict[str, bool]:
    """``{parameter name: decayed}``: convolution and dense kernels decay;
    BatchNorm scales and every bias do not — the reference's
    ``_weight_decay_mask`` (flax leaves named ``scale`` or ``bias``)."""
    mask = {}
    for mod_name, mod in model.named_modules():
        is_bn = isinstance(mod, nn.modules.batchnorm._BatchNorm)
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[name] = not is_bn and p_name != "bias"
    return mask


class SGD:
    """Momentum SGD over ``model``'s parameters (in ``named_parameters``
    order), momentum buffers included."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        if cfg.name != "sgd":
            raise NotImplementedError(
                f"optimizer '{cfg.name}' is not ported; only sgd")
        if cfg.nesterov or cfg.grad_clip_norm or cfg.momentum_dtype:
            raise NotImplementedError(
                "nesterov, grad_clip_norm and momentum_dtype are not ported")
        self.cfg = cfg
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        mask = weight_decay_mask(model)
        self.decayed = [i for i, n in enumerate(self.names) if mask[n]]
        self.momentum = [torch.zeros_like(p) for p in self.params]
        self.lr = torch.tensor(cfg.learning_rate, dtype=torch.float32,
                               device=self.params[0].device)

    def set_learning_rate(self, lr: float) -> None:
        self.lr.fill_(lr)

    def get_learning_rate(self) -> float:
        return float(self.lr)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], ok: torch.Tensor) -> None:
        """Apply one update where the 0-d bool device tensor ``ok`` holds;
        where it does not, parameters and momentum keep their values."""
        d = list(grads)
        wd = self.cfg.weight_decay
        if wd and self.decayed:
            decayed = torch._foreach_add([grads[i] for i in self.decayed],
                                         [self.params[i]
                                          for i in self.decayed], alpha=wd)
            for i, g in zip(self.decayed, decayed):
                d[i] = g
        bufs = torch._foreach_mul(self.momentum, self.cfg.momentum)
        torch._foreach_add_(bufs, d)
        steps = torch._foreach_mul(bufs, self.lr)
        new = torch._foreach_sub(self.params, steps)
        for p, n in zip(self.params, new):
            torch.where(ok, n, p, out=p)
        for b, n in zip(self.momentum, bufs):
            torch.where(ok, n, b, out=b)

    def state_dict(self) -> dict:
        return {"momentum": dict(zip(self.names, self.momentum)),
                "learning_rate": self.get_learning_rate()}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        for name, buf in zip(self.names, self.momentum):
            buf.copy_(d["momentum"][name])
        self.set_learning_rate(d["learning_rate"])


# ---------------------------------------------------------------------------
# Host-side schedulers (stateful, epoch granularity)
# ---------------------------------------------------------------------------


class Scheduler:
    """``epoch_begin(epoch)`` fixes the LR used during ``epoch``
    (1-indexed); ``step(epoch, metric)`` runs after validation for
    metric-driven schedules.  Read ``.lr``."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def epoch_begin(self, epoch: int) -> float:
        return self.lr

    def step(self, epoch: int, metric: float | None = None) -> float:
        return self.lr

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, d: dict):
        self.__dict__.update(d)


class ConstantSchedule(Scheduler):
    pass


class ReduceLROnPlateau(Scheduler):
    """torch's, as the reference configures it (mode='max' on val top-1,
    factor 0.1, patience 10)."""

    def __init__(self, base_lr, mode="max", factor=0.1, patience=10,
                 threshold=1e-4, min_lr=0.0):
        super().__init__(base_lr)
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min or max, got {mode!r}")
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.min_lr = threshold, min_lr
        self.best: float | None = None
        self.bad_epochs = 0

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1 + self.threshold)
        return metric < self.best * (1 - self.threshold)

    def step(self, epoch, metric=None):
        if metric is None:
            return self.lr
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class EpochTableSchedule(Scheduler):
    """Piecewise-constant by epoch boundaries ({0: 1e-3, 40: 1e-4, ...})."""

    def __init__(self, table: dict[int, float]):
        self.table = {int(k): v for k, v in sorted(table.items())}
        super().__init__(next(iter(self.table.values())))

    def epoch_begin(self, epoch):
        for boundary, lr in sorted(self.table.items()):
            if epoch >= boundary:
                self.lr = lr
        return self.lr

    def load_state_dict(self, d: dict):
        d = dict(d)
        d["table"] = {int(k): v for k, v in d["table"].items()}
        self.__dict__.update(d)


class LinearDecay(Scheduler):
    """Constant for ``decay_start`` epochs, then linear to 0 at ``total``."""

    def __init__(self, base_lr, total_epochs: int, decay_start: int):
        super().__init__(base_lr)
        self.total_epochs, self.decay_start = total_epochs, decay_start

    def epoch_begin(self, epoch):
        if epoch <= self.decay_start:
            self.lr = self.base_lr
        else:
            frac = (epoch - 1 - self.decay_start) / max(
                1, self.total_epochs - self.decay_start)
            self.lr = self.base_lr * max(0.0, 1.0 - frac)
        return self.lr


class WarmupCosine(Scheduler):
    """Linear warmup + cosine decay, per epoch."""

    def __init__(self, base_lr, total_epochs: int, warmup_epochs: int = 5,
                 final_lr: float = 0.0):
        super().__init__(base_lr)
        self.total_epochs, self.warmup_epochs = total_epochs, warmup_epochs
        self.final_lr = final_lr

    def epoch_begin(self, epoch):
        if epoch <= self.warmup_epochs:
            self.lr = self.base_lr * epoch / self.warmup_epochs
        else:
            t = (epoch - 1 - self.warmup_epochs) / max(
                1, self.total_epochs - self.warmup_epochs)
            self.lr = self.final_lr + 0.5 * (self.base_lr - self.final_lr) * (
                1 + math.cos(math.pi * min(t, 1.0)))
        return self.lr


class StepDecay(Scheduler):
    """torch ``StepLR``: lr = base·gamma^((epoch−1)//step_size)."""

    def __init__(self, base_lr, step_size: int, gamma: float):
        super().__init__(base_lr)
        self.step_size, self.gamma = step_size, gamma

    def epoch_begin(self, epoch):
        self.lr = self.base_lr * self.gamma ** ((epoch - 1) // self.step_size)
        return self.lr


class SqrtPolyDecay(Scheduler):
    """base·(1−e/horizon)^0.5 until ``horizon``, then fixed small
    multipliers (the reference's Inception V1 policy)."""

    def __init__(self, base_lr, horizon: int = 60):
        super().__init__(base_lr)
        self.horizon = horizon

    def epoch_begin(self, epoch):
        e = epoch - 1
        if e < self.horizon:
            mult = (1 - e / self.horizon) ** 0.5
        elif e < self.horizon + 15:
            mult = 0.01
        else:
            mult = 0.001
        self.lr = self.base_lr * mult
        return self.lr


SCHEDULERS = {
    "constant": ConstantSchedule,
    "plateau": ReduceLROnPlateau,
    "epoch_table": EpochTableSchedule,
    "linear_decay": LinearDecay,
    "warmup_cosine": WarmupCosine,
    "step": StepDecay,
    "sqrt_poly": SqrtPolyDecay,
}


def build_scheduler(name: str, base_lr: float, **kwargs) -> Scheduler:
    cls = SCHEDULERS[name]
    if cls is EpochTableSchedule:
        return cls(kwargs["table"])
    return cls(base_lr, **kwargs)
