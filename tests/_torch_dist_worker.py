"""Data-parallel ranks of the port on the CPU for the tests.

``run_ranks(world, calls)`` starts ``world`` processes of this file, each
a rank of a gloo group on ``127.0.0.1`` (``world`` 0: one process with
no group at all), runs every ``(scenario, kwargs)`` of ``calls`` in
order on every rank and returns ``results[rank][call]``.  Inputs and
results are pickled numpy trees.  A rank that fails, or a group that
outlives ``timeout_s``, fails the call with every rank's stderr tail,
and every process is reaped either way.  The scenarios import the port
only (not JAX, not the JAX package); the test process holds the JAX side.

Each scenario takes its rank's contiguous shard of every global batch,
the shard ``deep_vision_tpu.parallel.shard_batch`` gives device ``r`` of
a ``{"data": world}`` mesh.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: seconds a collective may wait for a peer inside a rank
COLLECTIVE_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, calls: list, timeout_s: float = 150.0) -> list:
    """Run ``calls`` on ``world`` gloo ranks (0: one process, no group);
    ``results[rank][i]`` is rank ``rank``'s result of ``calls[i]``."""
    n = max(world, 1)
    with tempfile.TemporaryDirectory() as work:
        spec = os.path.join(work, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"world": world, "port": free_port(),
                         "calls": calls}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, HERE, os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="2")
        procs, logs = [], []
        for rank in range(n):
            log = open(os.path.join(work, f"rank{rank}.err"), "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec,
                 str(rank), os.path.join(work, f"rank{rank}.pkl")],
                cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout_s} s"
                    break
                time.sleep(0.05)
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        tails = []
        for rank, log in enumerate(logs):
            log.seek(0)
            tails.append(f"--- rank {rank} ---\n"
                         + log.read()[-4000:].decode(errors="replace"))
            log.close()
        if failed is not None:
            raise RuntimeError(f"{failed}\n" + "\n".join(tails))
        out = []
        for rank in range(n):
            with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# -- the scenarios (run inside a rank) -------------------------------------

RESNET = dict(stages=(1, 1, 1, 1), classes=10)
YOLO_TOY = dict(num_classes=3, width=0.125, blocks=(1, 1, 1, 1, 1))


def shard(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous rows of a global batch."""
    w = max(world, 1)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        b = v.shape[0] // w
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def numpy_sd(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _trainer(kind: str, variables, workdir: str, lr: float, accum: int = 1,
             batch: int = 4, epochs: int = 1, arch: dict | None = None):
    """(trainer, state) of ``kind`` on the CPU, loaded from the flax
    ``variables``, on the default mesh (every rank of the group);
    ``arch`` overrides CenterNet's ``num_stack``/``order``/``filters``."""
    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.preprocess import make_scale_preprocess

    if kind == "resnet":
        from deep_vision_tpu_torch.core import config as port_config
        from deep_vision_tpu_torch.core import optim as port_optim
        from deep_vision_tpu_torch.models import resnet as port_resnet
        from deep_vision_tpu_torch.tasks.classification import (
            ClassificationTask,
        )

        cfg = port_config.TrainConfig(
            name="dp", model=None, batch_size=batch, image_size=32,
            num_classes=RESNET["classes"], grad_accum_steps=accum,
            total_epochs=epochs,
            optimizer=port_optim.OptimizerConfig(
                learning_rate=lr, momentum=0.9, weight_decay=1e-4),
            scheduler=port_config.SchedulerConfig(
                name="plateau",
                kwargs=dict(mode="max", factor=0.1, patience=10)))
        model = port_resnet.ResNet(RESNET["stages"],
                                   port_resnet.BottleneckBlock,
                                   RESNET["classes"])
        convert.load_into(model, variables)
        task, prep = ClassificationTask(RESNET["classes"]), None
    elif kind == "yolo":
        from deep_vision_tpu_torch.models.yolo import YoloV3
        from deep_vision_tpu_torch.tasks.detection import YoloTask

        cfg = get_config("yolov3_toy")
        model = YoloV3(**YOLO_TOY)
        convert.load_yolo(model, variables)
        task, prep = YoloTask(3), make_scale_preprocess()
    elif kind == "centernet":
        from deep_vision_tpu_torch.tasks.centernet import CenterNetTask

        from deep_vision_tpu_torch.models.centernet import CenterNet

        cfg = get_config("centernet_toy")
        model = CenterNet(num_classes=3, **arch) if arch else cfg.model()
        convert.load_centernet(model, variables)
        task, prep = CenterNetTask(3), make_scale_preprocess()
    else:
        raise ValueError(kind)
    cfg.grad_accum_steps = accum
    trainer = Trainer(cfg, model, task, workdir=workdir, preprocess_fn=prep,
                      device="cpu")
    state = trainer.state_for(model)
    state.opt.set_learning_rate(lr)
    return trainer, state


def steps(rank: int, world: int, kind: str, variables, batches: list,
          lr: float, accum: int = 1, local_stats: bool = False,
          local_count: bool = False, nan: bool = False,
          arch: dict | None = None) -> dict:
    """Train steps of ``kind`` on the rank's shards of ``batches``:
    every step's metrics and the state after each step.  ``local_stats``
    (control): BatchNorm over the rank's shard alone; ``local_count``
    (control): CenterNet's object count of the rank's shard alone;
    ``nan``: the last rank's shard of every batch is NaN."""
    from deep_vision_tpu_torch.models.common import set_batchnorm_mesh

    with tempfile.TemporaryDirectory() as work:
        trainer, state = _trainer(kind, variables, work, lr, accum,
                                  arch=arch)
        if local_stats:
            set_batchnorm_mesh(state.model, None)
        if local_count:
            trainer.task.mesh = None
        metrics, states = [], []
        for b in batches:
            b = shard(b, rank, world)
            if nan and rank == max(world, 1) - 1:
                b = dict(b, image=np.full(b["image"].shape, np.nan,
                                          np.float32))
            state, m = trainer.train_step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(numpy_sd(state.model))
        momentum = {n: t.numpy().copy() for n, t in
                    zip(state.opt.names, getattr(state.opt, "momentum", []))}
    return {"metrics": metrics, "states": states,
            "bad_steps": int(state.bad_steps), "step": state.step,
            "momentum": momentum}


def evaluate(rank: int, world: int, kind: str, variables,
             batches: list) -> dict:
    """``Trainer.evaluate`` over the rank's shards of ``batches``."""
    with tempfile.TemporaryDirectory() as work:
        trainer, state = _trainer(kind, variables, work, 0.0)
        return trainer.evaluate(state, [shard(b, rank, world)
                                        for b in batches])


def fit(rank: int, world: int, variables, batches: list, val: list,
        workdir: str, epochs: int, lr: float) -> dict:
    """``Trainer.fit`` of the ResNet for ``epochs`` over the rank's
    shards (``batches`` a global batch a step), resuming from
    ``workdir``: the state restored (None on a fresh start), the losses,
    the final state and the checkpoint files this rank wrote."""
    from deep_vision_tpu_torch.core import checkpoint

    writes = []
    write_files = checkpoint.Checkpointer._write_files

    def counted(self, step, payload):
        writes.append(step)
        return write_files(self, step, payload)

    checkpoint.Checkpointer._write_files = counted
    trainer, state = _trainer("resnet", variables, workdir, lr,
                              batch=len(batches[0]["label"]) // max(world, 1),
                              epochs=epochs)
    restored = None
    if trainer.checkpointer.latest_step() is not None:
        state = trainer.maybe_resume(state)
        restored = numpy_sd(state.model)
    train = [shard(b, rank, world) for b in batches]
    state = trainer.fit(train, [shard(b, rank, world) for b in val],
                        state=state)
    losses = trainer.logger.history.get("train_loss", {}).get("values", [])
    return {"restored": restored, "final": numpy_sd(state.model),
            "losses": list(losses), "step": state.step,
            "writes": len(writes),
            "val": trainer.logger.history.get("val_loss", {})
            .get("values", [])}


def dcgan_step(rank: int, world: int, variables, batch: dict, draws: dict,
               local_stats: bool = False) -> dict:
    """One DCGAN step of the adversarial trainer on the rank's rows of
    ``batch`` and of the draws (``z`` and the three discriminator
    forwards' dropout masks, NHWC)."""
    import torch

    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.core.adversarial import AdversarialTrainer
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.optim import OptimizerConfig
    from deep_vision_tpu_torch.models import gan
    from deep_vision_tpu_torch.models.common import set_batchnorm_mesh
    from deep_vision_tpu_torch.tasks.gan import DCGANTask

    task = DCGANTask(gan.DCGANGenerator, gan.DCGANDiscriminator,
                     opt=OptimizerConfig(name="sgd", learning_rate=1.0,
                                         momentum=0.0))
    w = max(world, 1)
    with tempfile.TemporaryDirectory() as work:
        trainer = AdversarialTrainer(get_config("dcgan"), task,
                                     workdir=work, device="cpu")
        models = task.init_models(torch.Generator().manual_seed(0))
        for n, m in models.items():
            convert.load_gan(m, variables[n])
        states = trainer.states_for(models)
        if local_stats:
            for st in states.values():
                set_batchnorm_mesh(st.model, None)
        mine = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                shard({"z": draws["z"]}, rank, world).items()}
        for name in ("drop_g", "drop_real", "drop_fake"):
            mine[name] = [torch.from_numpy(np.ascontiguousarray(
                shard({"m": m}, rank, w)["m"])) for m in draws[name]]
        _, metrics = trainer.train_step(states, shard(batch, rank, world),
                                        draws=mine)
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "after": {n: numpy_sd(st.model)
                          for n, st in states.items()}}


def preempt(rank: int, world: int, variables, batches: list,
            workdir: str, lr: float, signalled: int) -> dict:
    """``Trainer.fit`` of the ResNet over ``batches`` in which SIGTERM
    reaches rank ``signalled`` alone, after its first step: the step
    every rank stopped at and the checkpoints the run left."""
    import os
    import signal

    from deep_vision_tpu_torch.core import trainer as trainer_module

    trainer, state = _trainer("resnet", variables, workdir, lr,
                              batch=len(batches[0]["label"]) // max(world, 1))
    step = trainer_module.Trainer.train_step

    def train_step(self, state, batch):
        out = step(self, state, batch)
        if rank == signalled and state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer_module.Trainer.train_step = train_step
    state = trainer.fit([shard(b, rank, world) for b in batches],
                        state=state)
    return {"step": state.step, "preempted": trainer._preempted,
            "checkpoints": trainer.checkpointer.all_steps()}


def loader(rank: int, world: int, root: str, split: str, **kw) -> list:
    """Every batch of an epoch of ``ImageNetLoader.from_records`` with
    the rank and world left to the group."""
    from deep_vision_tpu_torch.data.imagenet import ImageNetLoader

    ld = ImageNetLoader.from_records(root, split, num_workers=0, **kw)
    ld.set_epoch(1)
    try:
        return list(ld)
    finally:
        ld.close()


SCENARIOS = {"steps": steps, "evaluate": evaluate, "fit": fit,
             "dcgan_step": dcgan_step, "loader": loader,
             "preempt": preempt}


def _rank_main(spec_path: str, rank: int, out_path: str) -> None:
    import torch

    torch.set_num_threads(2)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    world = spec["world"]
    from deep_vision_tpu_torch.parallel import distributed

    if world:
        distributed.initialize(f"127.0.0.1:{spec['port']}", world, rank,
                               device="cpu",
                               timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        results = [SCENARIOS[name](rank, world, **kwargs)
                   for name, kwargs in spec["calls"]]
    finally:
        distributed.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
