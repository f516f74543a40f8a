"""SGD, Adam and RMSprop with global-norm clipping and a decay mask, and
host LR schedulers.

Port of ``deep_vision_tpu/core/optim.py``: ``OptimizerConfig``, the
chains of ``build_optimizer`` and the host-side schedulers, which are
pure Python.  Per parameter ``p`` with gradient ``g``, as optax composes
them:

    clip (grad_clip_norm c):  n = ‖all g‖₂;  g = g if n < c else g / n · c
    sgd:   d = g + wd·p (decay mask);  buf = momentum·buf + d;
           u = d + momentum·buf if nesterov else buf;  p = p − lr·u;
           with ``momentum_dtype="bfloat16"`` the stored ``buf`` is
           rounded to bfloat16 and ``momentum·buf`` is a bfloat16
           product (optax ``trace(accumulator_dtype=bfloat16)``)
    adam:  t += 1;  mu = (1−b1)·g + b1·mu;  nu = (1−b2)·g² + b2·nu;
           u = (mu / (1−b1ᵗ)) / (sqrt(nu / (1−b2ᵗ)) + eps)
           (+ wd·p on the decay mask: AdamW);  p = p − lr·u
    rmsprop (optax ``rmsprop(lr, decay=rms_decay, eps=eps,
           momentum=momentum)``: ``scale_by_rms``, the learning rate,
           then ``trace``):  nu = (1−rms_decay)·g² + rms_decay·nu;
           u = g · rsqrt(nu + eps)  (eps INSIDE the root, unlike torch's
           ``g / (sqrt(nu) + eps)``);  buf = lr·u + momentum·buf;
           p = p − buf.  The trace holds updates already scaled by the
           learning rate of their step; no weight decay.

The updates run as ``torch._foreach_*`` ops with the learning rate in a
device tensor (the role of optax's ``inject_hyperparams``), so a
scheduler changes it between epochs, and the divergence guard
(``core/state.py``) selects the result on a device flag with no host
sync: a skipped step leaves parameters, moments and Adam's count ``t``
as they were, as the reference keeps its old ``opt_state``.  A step is
``propose`` (the new values, nothing written) then ``commit`` (written
where the flag holds), so a guard may decide on the proposed
parameters themselves, as the adversarial trainer's joint guard does.
Parameters may lie on several devices (a pipelined model's places,
``parallel/pipelined.py``): a 0-d device tensor (the learning rate,
Adam's bias corrections, the guard's flag) enters a foreach op as a
copy on each parameter's device (:func:`per_device`), and each
parameter is written on its own.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "sgd"  # sgd | adam | rmsprop
    learning_rate: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0  # on the decay mask (no BN, no bias)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    rms_decay: float = 0.9  # RMSprop's decay of nu (torch's ``alpha``)
    grad_clip_norm: float | None = None
    # SGD momentum's storage dtype: None (the parameters', float32) or
    # "bfloat16"
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


def spread_devices(tensors: list[torch.Tensor]) -> list | None:
    """Each tensor's device when they lie on several, else None: what
    :func:`per_device` takes, found once where the tensors are placed."""
    devices = [t.device for t in tensors]
    return devices if len(set(devices)) > 1 else None


def per_device(scalar: torch.Tensor, devices: list | None):
    """``scalar`` (0-d, on a device) as the operand of a foreach op over
    tensors on ``devices`` (:func:`spread_devices`): itself when they
    share its device (``None``), else a copy on each tensor's device (a
    0-d tensor of one card does not mix with another card's tensors)."""
    return scalar if devices is None else [scalar.to(d) for d in devices]


def stack_on(tensors: list[torch.Tensor], device=None) -> torch.Tensor:
    """0-d tensors of any devices stacked on ``device`` (default: the
    first tensor's)."""
    device = tensors[0].device if device is None else device
    return torch.stack([t.to(device) for t in tensors])


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        devices: list | None = None
                        ) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients as they are when
    their global L2 norm is below ``max_norm``, else ``g / norm ·
    max_norm``.  Decided on the device: when the norm is below, the
    division and product are by 1 and exact.  ``devices``: the
    gradients' devices where they lie on several
    (:func:`spread_devices`)."""
    norm = torch.linalg.vector_norm(stack_on(torch._foreach_norm(grads)))
    below = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    out = torch._foreach_div(grads, per_device(torch.where(below, one, norm),
                                               devices))
    torch._foreach_mul_(out, per_device(torch.where(below, one,
                                                    one * max_norm), devices))
    return out


class _Optimizer:
    """Parameters (``named_parameters`` order), the decay mask, the
    device learning rate and the clip shared by SGD and Adam."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        self.cfg = cfg
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        #: the parameters' devices where they lie on several, else None
        self.devices = spread_devices(self.params)
        mask = weight_decay_mask(model)
        self.decayed = [i for i, n in enumerate(self.names) if mask[n]]
        self.lr = torch.tensor(cfg.learning_rate, dtype=torch.float32,
                               device=self.params[0].device)

    def set_learning_rate(self, lr: float) -> None:
        self.lr.fill_(lr)

    def get_learning_rate(self) -> float:
        return float(self.lr)

    def _clipped(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.cfg.grad_clip_norm:
            return clip_by_global_norm(grads, self.cfg.grad_clip_norm,
                                       self.devices)
        return grads

    def _with_decay(self, updates: list[torch.Tensor]) -> list[torch.Tensor]:
        """``u + wd·p`` on the decay mask."""
        updates = list(updates)
        wd = self.cfg.weight_decay
        if wd and self.decayed:
            decayed = torch._foreach_add(
                [updates[i] for i in self.decayed],
                [self.params[i] for i in self.decayed], alpha=wd)
            for i, u in zip(self.decayed, decayed):
                updates[i] = u
        return updates

    def _stepped(self, updates: list[torch.Tensor]) -> list[torch.Tensor]:
        """``p − lr·u``."""
        return torch._foreach_sub(
            self.params,
            torch._foreach_mul(updates, per_device(self.lr, self.devices)))

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], ok: torch.Tensor) -> None:
        """Apply one update where the 0-d bool device tensor ``ok`` holds;
        where it does not, parameters and optimizer state keep their
        values."""
        self.commit(self.propose(grads), ok)

    @staticmethod
    @torch.no_grad()
    def commit(proposal: list, ok: torch.Tensor) -> None:
        """Write a :meth:`propose` result where ``ok`` holds."""
        for old, new in proposal:
            for o, n in zip(old, new):
                torch.where(ok.to(o.device), n, o, out=o)

    def proposed_params(self, proposal: list) -> list[torch.Tensor]:
        """The new parameters of a :meth:`propose` result."""
        return proposal[0][1]


class SGD(_Optimizer):
    """Momentum SGD (optax ``add_decayed_weights`` then ``sgd``), with
    Nesterov's update and a bfloat16 momentum as optax's ``trace``
    computes them."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        super().__init__(cfg, model)
        dtype = torch.bfloat16 if cfg.momentum_dtype == "bfloat16" else None
        self.momentum = [torch.zeros_like(p, dtype=dtype)
                         for p in self.params]
        # optax multiplies a bfloat16 trace by the decay rounded to
        # bfloat16 (a weakly typed float takes the array's dtype), so the
        # product rounds once to bfloat16 before the float32 add
        self.decay = (float(torch.tensor(cfg.momentum, dtype=dtype))
                      if dtype is not None else cfg.momentum)

    @torch.no_grad()
    def propose(self, grads: list[torch.Tensor]) -> list:
        """``[(old, new)]`` lists: parameters first, then momentum."""
        d = self._with_decay(self._clipped(grads))
        trace = torch._foreach_add(
            d, torch._foreach_mul(self.momentum, self.decay))
        update = trace
        if self.cfg.nesterov:  # from the float32 trace, before its cast
            update = torch._foreach_add(
                d, torch._foreach_mul(trace, self.cfg.momentum))
        if self.momentum[0].dtype != trace[0].dtype:
            trace = [t.to(self.momentum[0].dtype) for t in trace]
        return [(self.params, self._stepped(update)), (self.momentum, trace)]

    def state_dict(self) -> dict:
        return {"momentum": dict(zip(self.names, self.momentum)),
                "learning_rate": self.get_learning_rate()}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        for name, buf in zip(self.names, self.momentum):
            buf.copy_(d["momentum"][name])
        self.set_learning_rate(d["learning_rate"])


class Adam(_Optimizer):
    """Adam (optax ``adam``: ``scale_by_adam`` then the learning rate),
    AdamW (``adamw`` with the decay mask) when ``weight_decay`` is set."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        super().__init__(cfg, model)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=self.lr.device)

    @torch.no_grad()
    def propose(self, grads: list[torch.Tensor]) -> list:
        """``[(old, new)]`` lists: parameters, ``mu``, ``nu``, count."""
        cfg = self.cfg
        g = self._clipped(grads)
        mu = torch._foreach_mul(g, 1.0 - cfg.b1)
        torch._foreach_add_(mu, torch._foreach_mul(self.mu, cfg.b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1.0 - cfg.b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, cfg.b2))
        count = self.count + 1
        t = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=t.device)
        bc1 = one - torch.pow(one * cfg.b1, t)
        bc2 = one - torch.pow(one * cfg.b2, t)
        denom = torch._foreach_div(nu, per_device(bc2, self.devices))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        u = torch._foreach_div(mu, per_device(bc1, self.devices))
        torch._foreach_div_(u, denom)
        return [(self.params, self._stepped(self._with_decay(u))),
                (self.mu, mu), (self.nu, nu), ([self.count], [count])]

    def state_dict(self) -> dict:
        return {"mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)),
                "count": self.count,
                "learning_rate": self.get_learning_rate()}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        for key in ("mu", "nu"):
            for name, buf in zip(self.names, getattr(self, key)):
                buf.copy_(d[key][name])
        self.count.copy_(torch.as_tensor(d["count"]))
        self.set_learning_rate(d["learning_rate"])


class RMSprop(_Optimizer):
    """RMSprop with the reference's semantics (optax ``rmsprop`` with
    ``momentum``): eps inside the square root, the momentum trace over
    learning-rate-scaled updates, and no weight decay (the reference's
    rmsprop branch applies none, whatever ``weight_decay`` says)."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        super().__init__(cfg, model)
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def propose(self, grads: list[torch.Tensor]) -> list:
        """``[(old, new)]`` lists: parameters, ``nu``, the trace."""
        cfg = self.cfg
        g = self._clipped(grads)
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1.0 - cfg.rms_decay)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, cfg.rms_decay))
        scale = torch._foreach_add(nu, cfg.eps)
        torch._foreach_rsqrt_(scale)
        u = torch._foreach_mul(scale, g)
        torch._foreach_mul_(u, per_device(self.lr, self.devices))
        trace = torch._foreach_mul(self.trace, cfg.momentum)
        trace = torch._foreach_add(u, trace)
        return [(self.params, torch._foreach_sub(self.params, trace)),
                (self.nu, nu), (self.trace, trace)]

    def state_dict(self) -> dict:
        return {"nu": dict(zip(self.names, self.nu)),
                "trace": dict(zip(self.names, self.trace)),
                "learning_rate": self.get_learning_rate()}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        for key in ("nu", "trace"):
            for name, buf in zip(self.names, getattr(self, key)):
                buf.copy_(d[key][name])
        self.set_learning_rate(d["learning_rate"])


OPTIMIZERS = {"sgd": SGD, "adam": Adam, "rmsprop": RMSprop}


def build_optimizer(cfg: OptimizerConfig, model: nn.Module) -> _Optimizer:
    """The optimizer ``cfg.name`` names, over ``model``'s parameters."""
    if cfg.momentum_dtype not in (None, "bfloat16"):
        raise ValueError(f"momentum_dtype must be None or 'bfloat16', "
                         f"got {cfg.momentum_dtype!r}")
    if cfg.momentum_dtype is not None and cfg.name != "sgd":
        raise ValueError(
            f"momentum_dtype applies to the sgd momentum accumulator "
            f"only; optimizer is {cfg.name!r}")
    if cfg.name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer '{cfg.name}' is not ported; have "
            f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[cfg.name](cfg, model)


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
