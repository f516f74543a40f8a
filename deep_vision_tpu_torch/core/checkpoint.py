"""Checkpoint/resume in the port's own format.

Port of ``deep_vision_tpu/core/checkpoint.py`` without Orbax: a
checkpoint is ``<directory>/<step>/checkpoint.pt``, one ``torch.save`` of
``TrainState.save_dict()`` (parameters and buffers, momentum, step,
bad_steps, rng) plus host extras (epoch, scheduler and logger state), so
a resumed run continues the LR schedule and metric history.
``save_tree``/``restore_tree`` do the same for ``{name: TrainState}``,
the adversarial trainer's networks, in one file.  A save goes
to a temporary directory first and is renamed into place, so a reader
never sees a partial checkpoint.  Orbax checkpoints of the JAX package
are not read.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

from deep_vision_tpu_torch.core.state import TrainState

FILENAME = "checkpoint.pt"


class Checkpointer:
    """Keeps the newest ``max_to_keep`` checkpoints under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """Complete checkpoint steps, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, FILENAME)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), FILENAME)

    def save(self, step: int, state: TrainState,
             extras: dict | None = None) -> str:
        """Write checkpoint ``step`` (replacing one of that step) and drop
        all but the newest ``max_to_keep``."""
        return self._write(step, {"state": state.save_dict(),
                                  "extras": extras or {}})

    def save_tree(self, step: int, states: dict,
                  extras: dict | None = None) -> str:
        """:meth:`save` for ``{name: TrainState}`` (the adversarial
        trainer's networks), as atomic as one state."""
        return self._write(step, {
            "states": {k: v.save_dict() for k, v in states.items()},
            "extras": extras or {}})

    def _write(self, step: int, payload: dict) -> str:
        tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory)
        try:
            torch.save(payload, os.path.join(tmp, FILENAME))
            final = os.path.join(self.directory, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return final

    def load(self, step: int | None = None) -> dict:
        """The raw payload ``{"state": ..., "extras": ...}`` of ``step``
        (default: the latest), tensors on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState, step: int | None = None
                ) -> tuple[TrainState, dict]:
        """Load checkpoint ``step`` (default: the latest) into ``state``."""
        payload = self.load(step)
        return state.load_dict(payload["state"]), dict(payload["extras"])

    def restore_tree(self, states: dict, step: int | None = None
                     ) -> tuple[dict, dict]:
        """Load a :meth:`save_tree` checkpoint into ``states`` (the same
        names, strictly)."""
        payload = self.load(step)
        saved = payload["states"]
        if set(saved) != set(states):
            raise KeyError(f"checkpoint holds {sorted(saved)}, not "
                           f"{sorted(states)}")
        return ({k: v.load_dict(saved[k]) for k, v in states.items()},
                dict(payload["extras"]))
