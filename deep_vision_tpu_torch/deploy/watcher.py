"""Checkpoint watcher + accuracy gate: new checkpoint → gated rollout.

Port of ``deep_vision_tpu/deploy/watcher.py`` (``AccuracyGate``,
``CheckpointWatcher``, ``DeployPipeline``).

``CheckpointWatcher`` runs one supervised daemon thread per watched
model, each polling ``checkpoint_fingerprint(workdir)``
(``core/restore.py``) on an Event-paced monotonic interval.  Acting on
a fingerprint requires it to be STABLE ACROSS TWO CONSECUTIVE POLLS
(debounce): the port's ``Checkpointer`` writes a step into a staging
directory and renames it into place, which the fingerprint already
skips, and the debounce additionally absorbs any step that is still
changing between polls — a half-written checkpoint can never deploy.  A fingerprint is acted on at most once (gate failure
included); publishing a NEW step re-arms the watcher.

The ``AccuracyGate`` stands between "new checkpoint" and "new version
serving traffic": the candidate is loaded (same restore path as a
reload) and evaluated on a held-out ``--gate-dir`` *.npy set — loaded
through ``serve/quant.py``'s ``load_calibration_dir``, so the same
held-out data can drive both int8 calibration and deploy gating.  With
``labels.txt`` present the gate compares real top-1 accuracy candidate
vs active (pass: within ``max_accuracy_drop``); without labels it
gates on top-1 agreement (pass: ≥ ``min_agreement``); NaN outputs
always fail; non-classification outputs get the NaN check only.  Only
a passing candidate reaches ``plane.reload()`` — the normal
shadow/canary/promote path guards the rest.  A failing candidate is a
``FAILED`` ledger record carrying the eval delta; the active version
never stops serving.  The gate's forwards are the models' own bucket
callables, so on the uint8 wire of an int8 model they run the
``serve_ingest`` CUDA kernel.

One recorded departure from the reference: its int8 quantizer turns a
NaN weight into finite codes, so its gate passes an int8 candidate
holding a NaN weight; the port's quantizer keeps the NaN, and its gate
fails that candidate on the NaN screen.

``DeployPipeline`` is the one handle cli.serve and the HTTP layer
hold: plane + history + watcher + per-model autoscalers, with
``revert()`` recording the ledger entry around the plane's CAS'd
rollback.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.serve.engine import _leaves
from deep_vision_tpu_torch.serve.models import ACTIVE, FAILED

_log = get_logger("dvt.deploy.watcher")


class AccuracyGate:
    """Held-out eval between checkpoint and rollout.

    ``gate_dir`` follows the calibration-set layout (``*.npy`` uint8
    HWC images or NHWC batches, sorted order); ``labels.txt`` beside
    them (one int per image, same sorted order) upgrades the gate from
    agreement to real accuracy.  No ``gate_dir`` falls back to the
    deterministic synthetic batches — NaN screening and agreement still
    work there, which is exactly what smoke tests need."""

    def __init__(self, *, gate_dir: str | None = None,
                 batch_size: int = 8, n_batches: int = 2,
                 min_agreement: float = 0.8,
                 max_accuracy_drop: float = 0.02):
        self.gate_dir = gate_dir
        self.batch_size = int(batch_size)
        self.n_batches = int(n_batches)
        self.min_agreement = float(min_agreement)
        self.max_accuracy_drop = float(max_accuracy_drop)

    def _batches(self, model) -> list:
        from deep_vision_tpu_torch.serve.quant import (
            load_calibration_dir,
            synthetic_calibration_batches,
        )

        shape = tuple(model.input_shape)
        if self.gate_dir:
            return load_calibration_dir(
                self.gate_dir, shape, n_batches=self.n_batches,
                batch_size=self.batch_size)
        return synthetic_calibration_batches(
            shape, n_batches=self.n_batches, batch_size=self.batch_size)

    def _labels(self) -> np.ndarray | None:
        if not self.gate_dir:
            return None
        p = os.path.join(self.gate_dir, "labels.txt")
        if not os.path.exists(p):
            return None
        return np.loadtxt(p, dtype=np.int64).reshape(-1)

    @staticmethod
    def _wire(model, batch: np.ndarray) -> np.ndarray:
        wire = np.dtype(str(model.wire_dtype))
        if wire == np.uint8:
            return batch
        # both sides see the identical float array — the comparison is
        # apples-to-apples even though /255 isn't the exact per-dataset
        # normalization the f32-wire client contract implies
        return batch.astype(np.float32) / 255.0

    def _predict(self, model, batches: list) -> tuple:
        """(per-image top-1 argmax or None, NaN seen?) for classifier-
        shaped output (a single (batch, classes) float leaf); anything
        else gets the NaN screen only."""
        preds: list | None = []
        nan = False
        for b in batches:
            out = model.compile_bucket(len(b))(self._wire(model, b))
            leaves = [a.cpu().numpy() for a in _leaves(out)]
            for a in leaves:
                if a.dtype.kind == "f" and np.isnan(a).any():
                    nan = True
            if preds is not None and len(leaves) == 1 \
                    and leaves[0].ndim == 2:
                preds.extend(int(np.argmax(r)) for r in leaves[0])
            else:
                preds = None
        return preds, nan

    def evaluate(self, candidate, active=None) -> dict:
        """``{"passed": bool, ...metrics...}`` — the history record's
        gate block.  ``active`` (the currently-serving ServingModel)
        enables the relative checks; without it only the NaN screen
        (and absolute accuracy, when labels exist) applies."""
        batches = self._batches(candidate)
        n_images = sum(len(b) for b in batches)
        out: dict = {"images": n_images,
                     "gate_dir": self.gate_dir or "synthetic"}
        cand, cand_nan = self._predict(candidate, batches)
        if cand_nan:
            out.update(passed=False, reason="candidate output has NaNs")
            return out
        if cand is None:
            # non-classification head: the NaN screen is the gate
            out.update(passed=True, reason="nan screen only "
                                           "(non-classification output)")
            return out
        labels = self._labels()
        if labels is not None:
            labels = labels[:n_images]
            cand_acc = float(np.mean(
                np.asarray(cand[:len(labels)]) == labels))
            out["candidate_acc"] = round(cand_acc, 4)
            active_acc = None
            if active is not None:
                act, act_nan = self._predict(active, batches)
                if act is not None and not act_nan:
                    active_acc = float(np.mean(
                        np.asarray(act[:len(labels)]) == labels))
                    out["active_acc"] = round(active_acc, 4)
                    out["delta"] = round(cand_acc - active_acc, 4)
            if active_acc is not None:
                passed = cand_acc >= active_acc - self.max_accuracy_drop
                out.update(passed=passed,
                           reason=None if passed else
                           f"accuracy {cand_acc:.4f} dropped more than "
                           f"{self.max_accuracy_drop} below active "
                           f"{active_acc:.4f}")
                return out
            out.update(passed=True, reason="no active baseline")
            return out
        if active is not None:
            act, act_nan = self._predict(active, batches)
            if act is not None and not act_nan:
                agree = float(np.mean(np.asarray(cand)
                                      == np.asarray(act)))
                out["agreement"] = round(agree, 4)
                passed = agree >= self.min_agreement
                out.update(passed=passed,
                           reason=None if passed else
                           f"top-1 agreement {agree:.4f} < "
                           f"{self.min_agreement}")
                return out
        out.update(passed=True, reason="no baseline to compare")
        return out

    def describe(self) -> dict:
        return {"gate_dir": self.gate_dir or "synthetic",
                "batch_size": self.batch_size,
                "n_batches": self.n_batches,
                "min_agreement": self.min_agreement,
                "max_accuracy_drop": self.max_accuracy_drop}


class CheckpointWatcher:
    """One supervised poll thread per watched model.

    ``poll_once(name)`` is the whole state machine and is public: tests
    and ``chip_smoke.py`` drive it synchronously; production runs
    it on Event-paced daemon threads that a supervisor restarts if they
    ever exit."""

    def __init__(self, plane, history, *, interval_s: float = 2.0,
                 gate: AccuracyGate | None = None, loader=None):
        self.plane = plane
        self.history = history
        self.interval_s = float(interval_s)
        self.gate = gate
        # test seam: loader(plane, name) → ready ServingModel;
        # default is the plane's own reload restore path
        self._loader = loader
        # name → {"candidate": fp-key sighted once,
        #         "acted": fp-key already deployed/gated}
        self._state: dict[str, dict] = {}  # guarded-by: _lock
        self._threads: dict[str, threading.Thread] = {}
        self._supervisor: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self.polls = 0  # guarded-by: _lock
        self.debounces = 0  # guarded-by: _lock
        self.deploys = 0  # guarded-by: _lock
        self.gate_failures = 0  # guarded-by: _lock

    def watch(self, name: str) -> "CheckpointWatcher":
        with self._lock:
            self._state.setdefault(name, {})
        return self

    # -- the state machine (one poll) --------------------------------------

    def poll_once(self, name: str) -> dict:
        """One debounced look at ``name``'s workdir.  Status values:
        ``no_workdir`` / ``no_checkpoint`` / ``current`` (serving this
        step) / ``debounce`` (first sighting — waiting for stability) /
        ``acted`` (this fingerprint is already decided) /
        ``gate_failed`` / ``promoted`` / ``rolled_back`` / ``failed``.
        """
        from deep_vision_tpu_torch.core.restore import \
            checkpoint_fingerprint

        with self._lock:
            self.polls += 1
        mv = self.plane.active_version(name)
        if mv.workdir is None:
            return {"status": "no_workdir", "model": name}
        fp = checkpoint_fingerprint(mv.workdir)
        if fp["step"] is None:
            return {"status": "no_checkpoint", "model": name}
        key = (fp["step"], fp["dir"], fp["mtime"])
        if fp["step"] == mv.model.restored_step:
            with self._lock:
                self._state.setdefault(name, {})["candidate"] = None
            return {"status": "current", "model": name,
                    "step": fp["step"]}
        with self._lock:
            st = self._state.setdefault(name, {})
            if st.get("acted") == key:
                return {"status": "acted", "model": name,
                        "step": fp["step"]}
            if st.get("candidate") != key:
                # first sighting (or still mutating): remember, wait for
                # the NEXT poll to see the identical (step, dir, mtime)
                st["candidate"] = key
                self.debounces += 1
                return {"status": "debounce", "model": name,
                        "step": fp["step"]}
            # stable across two polls: decide exactly once
            st["acted"] = key
        return self._deploy_candidate(name, mv, fp, key)

    def _deploy_candidate(self, name: str, mv, fp: dict,
                          key: tuple) -> dict:
        base = {"step": fp["step"], "mtime": fp["mtime"],
                "dir": fp["dir"]}
        try:
            sm = self._loader(self.plane, name) \
                if self._loader is not None \
                else self.plane.load_candidate(name)
        except Exception as e:  # noqa: BLE001 — an unrestorable candidate must not kill the watcher
            reason = f"{type(e).__name__}: {e}"
            self.history.record(name, "failed", reason=reason, **base)
            event(_log, "candidate_load_failed", model=name,
                  error=reason, **base)
            return {"status": "failed", "model": name, "reason": reason}
        base["digest"] = sm.params_digest
        self.history.record(name, "candidate", **base)
        if self.gate is not None:
            try:
                metrics = self.gate.evaluate(sm, mv.model)
            except Exception as e:  # noqa: BLE001 — gate infrastructure failure fails CLOSED
                metrics = {"passed": False,
                           "reason": f"gate error: "
                                     f"{type(e).__name__}: {e}"}
            if not metrics.get("passed"):
                with self._lock:
                    self.gate_failures += 1
                self.history.record(name, "gate_failed",
                                    outcome_state=FAILED, gate=metrics,
                                    **base)
                event(_log, "gate_failed", model=name,
                      reason=metrics.get("reason"), **base)
                return {"status": "gate_failed", "model": name,
                        "gate": metrics, **base}
            self.history.record(name, "gate_passed", gate=metrics,
                                **base)
        out = self.plane.reload(name, wait=True, _loader=lambda: sm)
        if out.get("status") != "done":
            # raced an operator reload: let the next new fingerprint
            # (or this one, re-armed) try again
            with self._lock:
                st = self._state.get(name, {})
                if st.get("acted") == key:
                    st.pop("acted", None)
            return {"status": out.get("status", "refused"),
                    "model": name}
        ver = out.get("version") or {}
        state = ver.get("state")
        if state == ACTIVE:
            with self._lock:
                self.deploys += 1
            outcome = "promoted"
        elif state == FAILED:
            outcome = "failed"
        else:  # rolled back through the canary/shadow gates
            outcome = "rolled_back"
        self.history.record(name, outcome, version=ver.get("version"),
                            reason=ver.get("state_reason"), **base)
        event(_log, "deploy_decided", model=name, outcome=outcome,
              version=ver.get("version"), **base)
        return {"status": outcome, "model": name,
                "version": ver.get("version"), **base}

    # -- threads -----------------------------------------------------------

    def start(self) -> "CheckpointWatcher":
        self._stop_evt.clear()
        with self._lock:
            names = list(self._state)
        for name in names:
            self._spawn(name)
        if self._supervisor is None or not self._supervisor.is_alive():
            self._supervisor = threading.Thread(
                target=self._supervise_loop, name="watcher-supervisor",
                daemon=True)
            self._supervisor.start()
        return self

    def _spawn(self, name: str):
        t = threading.Thread(target=self._watch_loop, args=(name,),
                             name=f"watcher-{name}", daemon=True)
        self._threads[name] = t
        t.start()

    def _watch_loop(self, name: str):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.poll_once(name)
            except Exception:  # noqa: BLE001 — a poll failure must not end the watch
                pass

    def _supervise_loop(self):
        # belt and braces: per-poll excepts should keep the loops alive
        # forever, but a thread that somehow exits is restarted here
        while not self._stop_evt.wait(self.interval_s):
            for name, t in list(self._threads.items()):
                if not t.is_alive() and not self._stop_evt.is_set():
                    event(_log, "watcher_restarted", model=name)
                    self._spawn(name)

    def stop(self, timeout: float = 5.0):
        self._stop_evt.set()
        sup = self._supervisor
        if sup is not None:
            sup.join(timeout)
            self._supervisor = None
        for t in self._threads.values():
            t.join(timeout)
        self._threads.clear()

    def stats(self) -> dict:
        with self._lock:
            per = {name: {"candidate": st.get("candidate"),
                          "acted": st.get("acted")}
                   for name, st in sorted(self._state.items())}
            out = {"interval_s": self.interval_s,
                   "polls": self.polls,
                   "debounces": self.debounces,
                   "deploys": self.deploys,
                   "gate_failures": self.gate_failures,
                   "models": per}
        if self.gate is not None:
            out["gate"] = self.gate.describe()
        return out


class DeployPipeline:
    """Plane + ledger + watcher + autoscalers behind one handle.

    This is what ``cli.serve --watch`` builds, what ``ServeServer``
    exposes at ``/v1/deploy/...``, and what tests drive."""

    def __init__(self, plane, *, history: "DeploymentHistory" = None,
                 watcher: CheckpointWatcher | None = None,
                 autoscalers: dict | None = None):
        from deep_vision_tpu_torch.deploy.history import DeploymentHistory

        self.plane = plane
        self.history = history if history is not None \
            else DeploymentHistory()
        self.watcher = watcher
        self.autoscalers = dict(autoscalers or {})

    def entries(self, name: str, n: int | None = None) -> list[dict]:
        # unknown model → KeyError with the plane's standard message
        # (the HTTP layer turns it into the 404 body)
        self.plane.active_version(name)
        return self.history.entries(name, n)

    def revert(self, name: str) -> dict:
        """One-command rollback, recorded in the ledger.  Status map
        (the HTTP layer's contract): ``reverted`` 200 /
        ``in_progress``+``refused`` 409 / ``failed`` 500."""
        out = self.plane.revert(name)
        status = out.get("status")
        if status == "reverted":
            self.history.record(name, "reverted",
                                version=out.get("version"),
                                restores=out.get("restores"),
                                from_version=out.get("from_version"))
        elif status == "failed":
            self.history.record(name, "revert_failed",
                                reason=out.get("reason"))
        return out

    def start(self) -> "DeployPipeline":
        if self.watcher is not None:
            self.watcher.start()
        for scaler in self.autoscalers.values():
            scaler.start()
        return self

    def stop(self, timeout: float = 5.0):
        if self.watcher is not None:
            self.watcher.stop(timeout)
        for scaler in self.autoscalers.values():
            scaler.stop(timeout)

    def stats(self) -> dict:
        out = {"history": self.history.stats()}
        if self.watcher is not None:
            out["watcher"] = self.watcher.stats()
        if self.autoscalers:
            out["autoscale"] = {name: s.stats() for name, s
                                in sorted(self.autoscalers.items())}
        return out
