"""Multi-step dispatch (``config.scan_steps``): the guarded train step
captured once as a CUDA graph and replayed a step at a time.

The counterpart of the reference's ``_jit_train_multi`` and
``_train_epoch_scan`` (``deep_vision_tpu/core/trainer.py``) and of the
adversarial trainer's ``train_multi``: there one ``jax.jit`` of a
``lax.scan`` runs K steps in one dispatch; here each step is one replay
of a graph that holds the whole step (the preprocess with its kernel,
forward, backward, the optimizer's proposal, the guard's commit, the
EMA), and the host reads the metrics of a group of K steps once.

:class:`StepRunner` runs the steps of a group.  ``step_fn(batch)`` is the
device work of one step: it reads nothing from the host that changes
between steps, and it draws its randomness from ``generators``, which
the caller seeds for each step before :meth:`StepRunner.step` (a
registered generator's seed and offset are read at every replay, so a
replay draws what an eager step from the same seed draws).  On the card
the first ``WARMUP_STEPS`` steps run eagerly on the capture's side
stream (cuDNN's plans, cuBLAS's workspace for that stream, the kernels'
builds): they are real steps of the run.  The next step is captured
and replayed, and so is every later one; the batch is copied into input
slots whose addresses never change.  A step that cannot be captured
(a host synchronisation, an operation capture forbids) raises and names
the code that did it; it never falls back to eager dispatch.  On the
CPU there are no graphs: every step runs eagerly, in the same groups.

A kernel wrapper counts its launches when it launches, which under
capture happens once and launches nothing; the graph records what each
registered wrapper's counter (``deep_vision_tpu_torch.ops.COUNTED``)
gained while it was captured, takes it back, and adds it on every
replay.

:func:`run_groups` is the epoch loop of both trainers in this mode.
"""

from __future__ import annotations

import os
import traceback

import torch

#: eager steps on the capture stream before the first capture
WARMUP_STEPS = 3


def _signature(batch: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())


def _culprit(err: BaseException) -> str:
    """``file:line: source`` of the innermost frame of the port (outside
    this module) in ``err``'s traceback: the code that broke capture."""
    here = os.path.abspath(__file__)
    pkg = os.path.dirname(os.path.dirname(here))
    hit = None
    for frame in traceback.extract_tb(err.__traceback__):
        name = os.path.abspath(frame.filename)
        if name.startswith(pkg) and name != here:
            hit = frame
    if hit is None:
        return "no frame of the port in the traceback"
    return (f"{os.path.relpath(hit.filename, os.path.dirname(pkg))}:"
            f"{hit.lineno}: {hit.line}")


class StepCaptureError(RuntimeError):
    """The train step cannot run as a CUDA graph."""


class StepRunner:
    """Runs the steps of ``scan_steps`` groups; see the module docstring.

    ``step_fn(batch) -> {name: 0-d device tensor}`` with the same names
    every step.  :meth:`step` runs one step and writes its metrics into
    the next row of a ``(K, M)`` float32 device buffer, which
    :meth:`read_group` reads once a group.  ``owner`` is what
    ``step_fn`` trains (a train state, or a trainer's dict of them): a
    trainer makes a new runner, which captures anew, for another one."""

    def __init__(self, step_fn, generators, device: torch.device,
                 group: int, owner=None):
        self.step_fn = step_fn
        self.generators = list(generators)
        self.device = device
        self.group = int(group)
        self.owner = owner
        self.keys: list[str] | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.eager_steps = 0
        self.replays = 0
        self._buffer: torch.Tensor | None = None
        self._row = 0
        self._slots: dict = {}
        self._sig = None
        self._out: torch.Tensor | None = None
        self._captured: list[tuple] = []
        self._stream = None

    @property
    def captures(self) -> bool:
        return self.device.type == "cuda"

    @property
    def untimed_steps(self) -> int:
        """The steps a step timer started now leaves out: the first, and
        on the card before the first capture the eager warmup and the
        capture too, so that it times the replays."""
        return WARMUP_STEPS + 1 if self.captures and self.graph is None \
            else 1

    # ------------------------------------------------------------- groups

    def read_group(self) -> list[dict]:
        """The metrics of the steps since the last read on the host, one
        dict a step (the host waits for those steps)."""
        rows = self._buffer[:self._row].cpu().tolist()
        self._row = 0
        return [dict(zip(self.keys, row)) for row in rows]

    def _record(self, vec: torch.Tensor) -> None:
        if self._buffer is None:
            self._buffer = torch.zeros((self.group, vec.numel()),
                                       dtype=torch.float32,
                                       device=self.device)
        self._buffer[self._row].copy_(vec)
        self._row += 1

    def _vector(self, metrics: dict) -> torch.Tensor:
        if self.keys is None:
            self.keys = list(metrics)
        elif list(metrics) != self.keys:
            raise ValueError(f"the step's metrics changed from "
                             f"{self.keys} to {list(metrics)}")
        return torch.stack([metrics[k].detach().to(torch.float32)
                            .reshape(()) for k in self.keys])

    # -------------------------------------------------------------- steps

    def step(self, batch: dict) -> None:
        """One step of ``batch`` (device tensors), generators seeded."""
        if not self.captures:
            self._record(self._vector(self.step_fn(batch)))
            self.eager_steps += 1
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self.graph is None and self.eager_steps < WARMUP_STEPS:
            self._record(self._warm(batch))
            return
        if self.graph is None or _signature(batch) != self._sig:
            self._capture(batch)
        for k, v in batch.items():
            self._slots[k].copy_(v)
        self.graph.replay()
        for fn, n in self._captured:
            fn.launches += n
        self.replays += 1
        self._record(self._out)

    def _warm(self, batch: dict) -> torch.Tensor:
        """One eager step on the capture stream."""
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            vec = self._vector(self.step_fn(batch))
        current.wait_stream(self._stream)
        self.eager_steps += 1
        return vec

    def _capture(self, batch: dict) -> None:
        """Capture ``step_fn`` over fresh input slots shaped as
        ``batch``; nothing runs until the first replay."""
        from deep_vision_tpu_torch.ops import COUNTED

        self.graph = None
        self._slots = {k: torch.empty_like(v) for k, v in batch.items()}
        self._sig = _signature(batch)
        # a wrapper registered during capture started from 0
        before = {fn: fn.launches for fn in COUNTED}
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.synchronize(self.device)
        try:
            # an operation that waits on the device raises here with its
            # stack, where capture would only report an invalidated graph
            torch.cuda.set_sync_debug_mode("error")
            with torch.cuda.graph(graph, stream=self._stream):
                out = self._vector(self.step_fn(self._slots))
        except Exception as e:
            raise StepCaptureError(
                f"the train step cannot be captured in a CUDA graph "
                f"(scan_steps > 1 runs only as a graph): {_culprit(e)} "
                f"({type(e).__name__}: {e})") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            gained = [(fn, fn.launches - before.get(fn, 0))
                      for fn in COUNTED]
            for fn in COUNTED:
                fn.launches = before.get(fn, 0)
        self._captured = [(fn, n) for fn, n in gained if n]
        self.graph, self._out = graph, out


def run_groups(batches, runner: StepRunner, seed, advance, on_step,
               on_group, stopped) -> list:
    """The epoch of a trainer in groups of ``runner.group`` steps (the
    reference's ``_train_epoch_scan``).  Each step of a full group calls
    ``seed()`` (the generators of the step about to run), the runner's
    step on the device batch, ``advance()`` (the host's step count) and
    ``on_step(batch)``.  After each group, ``on_group(metrics)`` gets
    the group's metrics on the host, one dict a step, so the guard sees
    every step; the loop ends there when ``stopped()``.  Returns the
    batches of an incomplete last group: the ragged tail, which the
    caller runs as single steps (none after a stop)."""
    buf: list = []
    for batch in batches:
        buf.append(batch)
        if len(buf) < runner.group:
            continue
        for b in buf:
            seed()
            runner.step(b)
            advance()
            on_step(b)
        buf = []
        on_group(runner.read_group())
        if stopped():
            break
    return buf
