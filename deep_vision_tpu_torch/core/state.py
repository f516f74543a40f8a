"""Training state and the divergence guard.

Port of ``deep_vision_tpu/core/state.py``.  ``TrainState`` is the model
(parameters and BatchNorm running statistics), the optimizer's state
(SGD momentum, or Adam's moments and count), the step counter (on the
host, and as a 0-d device tensor that device code such as the EMA's
decay reads), the count of skipped non-finite steps, the rng seed and
the params EMA (``ema``, empty when it is off).  Unlike the reference's
immutable pytree it is updated in place; the guard of
``apply_gradients_if_finite``/``keep_if`` becomes ``torch.where`` on a
device flag, so a non-finite step costs no host sync (the flag is
copied to each tensor's own device where they lie on several, as a
pipelined model's do).  Nothing here reads the host step, so a step's
device work may be captured once in a CUDA graph and replayed (``core/step_graph.py``); the trainer advances
the host counter with :meth:`TrainState.advance`.
"""

from __future__ import annotations

import torch
from torch import nn

from deep_vision_tpu_torch.core.optim import per_device, stack_on


class DivergenceGuard:
    """Host-side policy over the cumulative ``bad_steps`` counter: warn on
    newly skipped non-finite steps, halt once THIS RUN skipped more than
    ``limit``.  ``baseline`` is the counter restored from a checkpoint,
    so old skips never count against the current run."""

    def __init__(self, limit: int):
        self.limit = limit
        self.baseline = 0
        self._seen = 0

    def set_baseline(self, bad_steps: int):
        self.baseline = self._seen = int(bad_steps)

    def check(self, metrics: dict):
        bad = int(metrics.get("bad_steps", 0))
        if bad > self._seen:
            print(f"[warn] skipped {bad - self._seen} non-finite step(s) — "
                  f"{bad - self.baseline} total this run", flush=True)
            self._seen = bad
        if bad - self.baseline > self.limit:
            raise RuntimeError(
                f"training diverged: {bad - self.baseline} non-finite steps "
                f"skipped (> max_bad_steps={self.limit}); lower the "
                f"learning rate or inspect the input data")


def all_finite(tensors: list[torch.Tensor]) -> torch.Tensor:
    """0-d bool device tensor: every element of every tensor is finite.
    ``0·x`` is 0 for a finite ``x`` and NaN otherwise, so the norms of the
    zeroed tensors are all 0 exactly when every element is finite (a norm
    of the tensors themselves could overflow on large finite values)."""
    norms = torch._foreach_norm(torch._foreach_mul(tensors, 0.0))
    return torch.isfinite(stack_on(norms)).all()


def _to_cpu(tree):
    """CPU copies of the tensors of a nested dict."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def ema_decay_at(decay: float, step: torch.Tensor) -> torch.Tensor:
    """The EMA's effective decay after step ``step`` (the advanced step
    count, a 0-d device tensor): ``min(decay, (1 + t)/(10 + t))`` in
    float32, the reference's warmup (tf.train.ExponentialMovingAverage's
    ``num_updates``)."""
    t = step.to(torch.float32)
    return torch.clamp_max((1.0 + t) / (10.0 + t), decay)


class TrainState:
    """Model + optimizer + counters: the checkpointable unit.  ``ema``
    (parallel to ``opt.params``) holds the params EMA when ``ema`` is
    True at construction, else it is empty."""

    def __init__(self, model: nn.Module, optimizer, rng: int,
                 ema: bool = False):
        self.model = model
        self.opt = optimizer
        self.rng = int(rng)
        self.step = 0
        device = optimizer.lr.device
        self.device_step = torch.zeros((), dtype=torch.int32, device=device)
        self.bad_steps = torch.zeros((), dtype=torch.int32, device=device)
        self.running_stats = [b for n, b in model.named_buffers()
                              if n.endswith(("running_mean", "running_var"))]
        self.ema: list[torch.Tensor] = []
        if ema:
            self.seed_ema()

    @torch.no_grad()
    def seed_ema(self) -> None:
        """Start the EMA from the current parameters."""
        self.ema = [p.detach().clone() for p in self.opt.params]

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        """``ema = d·ema + (1 − d)·params`` with ``d`` from
        :func:`ema_decay_at` at the device step, as products and a sum
        (the reference's rounding, not ``lerp``'s).  Run after the
        guarded commit: on a skipped step the parameters kept their
        values and the EMA re-averages toward them."""
        d = ema_decay_at(decay, self.device_step)
        scaled = torch._foreach_mul([p.detach() for p in self.opt.params],
                                    per_device(1.0 - d, self.opt.devices))
        torch._foreach_mul_(self.ema, per_device(d, self.opt.devices))
        torch._foreach_add_(self.ema, scaled)

    def ema_named(self) -> dict[str, torch.Tensor]:
        """``{parameter name: EMA tensor}`` (empty when the EMA is off)."""
        return dict(zip(self.opt.names, self.ema))

    def advance(self) -> None:
        """Count one step on the host (the device counter advanced in
        :meth:`commit`)."""
        self.step += 1

    def snapshot_stats(self) -> list[torch.Tensor]:
        """Copies of the BatchNorm running statistics (one foreach op),
        taken before a train forward so :meth:`keep_if` can restore them."""
        if not self.running_stats:
            return []
        return torch._foreach_mul(self.running_stats, 1.0)

    @torch.no_grad()
    def apply_gradients_if_finite(self, loss: torch.Tensor,
                                  grads: list[torch.Tensor],
                                  stats_before: list[torch.Tensor]) -> None:
        """Apply the optimizer update unless the loss or any gradient is
        non-finite; then parameters, optimizer state and the running
        statistics keep their values and ``bad_steps`` counts one.  The
        device step counter advances either way, and the trainer's
        :meth:`advance` the host's, so the per-step rng never repeats."""
        ok = torch.isfinite(loss) & all_finite(grads).to(loss.device)
        self.commit(self.opt.propose(grads), ok, stats_before)

    @torch.no_grad()
    def commit(self, proposal: list, ok: torch.Tensor,
               stats_before: list[torch.Tensor]) -> None:
        """Write the optimizer's ``proposal`` where ``ok`` holds; where it
        does not, restore the running statistics to ``stats_before`` and
        count a bad step (the reference's ``keep_if``).  The device step
        counter advances either way (the host's in :meth:`advance`); the
        EMA is not touched."""
        self.opt.commit(proposal, ok)
        for s, old in zip(self.running_stats, stats_before):
            torch.where(ok.to(s.device), s, old, out=s)
        self.bad_steps += (~ok).to(torch.int32)
        self.device_step += 1

    def save_dict(self) -> dict:
        """CPU copies of everything a resumed run needs."""
        return {
            "step": self.step,
            "rng": self.rng,
            "bad_steps": int(self.bad_steps),
            "model": {k: v.detach().cpu()
                      for k, v in self.model.state_dict().items()},
            "optimizer": _to_cpu(self.opt.state_dict()),
            "ema": _to_cpu(self.ema_named()),
        }

    @torch.no_grad()
    def load_dict(self, d: dict) -> "TrainState":
        """Restore a :meth:`save_dict`.  A state with the EMA on takes
        the saved EMA, or, from a checkpoint without one, seeds it from
        the restored parameters (the reference's resume); a state with
        it off ignores a saved EMA."""
        self.model.load_state_dict(d["model"], strict=True)
        self.opt.load_state_dict(d["optimizer"])
        self.step = int(d["step"])
        self.device_step.fill_(self.step)
        self.rng = int(d["rng"])
        self.bad_steps.fill_(int(d["bad_steps"]))
        if self.ema:
            saved = d.get("ema") or {}
            if saved:
                for name, e in zip(self.opt.names, self.ema):
                    e.copy_(saved[name])
            else:
                self.seed_ema()
                print("[resume] checkpoint has no EMA — seeded from "
                      "restored params", flush=True)
        return self
