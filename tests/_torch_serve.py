"""Shared helpers of the serving-plane parity tests (tests/test_torch_
faults.py, test_torch_plane.py, test_torch_plane_http.py,
test_torch_restore_serve.py, test_torch_serve_obs.py): LeNet-5 at full
width (32×32×1) as a serving model of the JAX package and of the port on
the same seeded weights, port checkpoints written the way ``cli.train``
writes them, and small HTTP clients."""

import json
import os
import urllib.error
import urllib.request

import numpy as np

import _torch_zoo as tz
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState as JaxTrainState
from deep_vision_tpu.serve.registry import (
    CheckpointServingModel as JaxServingModel,
)
from deep_vision_tpu_torch.core.checkpoint import Checkpointer
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.optim import OptimizerConfig as PortOptConfig
from deep_vision_tpu_torch.core.optim import build_optimizer as port_optimizer
from deep_vision_tpu_torch.core.state import TrainState
from deep_vision_tpu_torch.serve.registry import CheckpointServingModel


def lenet_variables(seed=0):
    """Seeded flax variables of LeNet-5 (numpy float32)."""
    return tz.variables("lenet5", seed)


def jax_lenet(variables, wire="float32", infer="float32", name="lenet5"):
    """The reference's serving model of LeNet-5 (or its tier ``name``)
    with ``variables``."""
    cfg = jax_get_config(name)
    jm = tz.MODELS[name][0]()
    state = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        tx=build_optimizer(OptimizerConfig()),
        batch_stats=variables.get("batch_stats", {}))
    return JaxServingModel(name, cfg, jm, state, wire_dtype=wire,
                           infer_dtype=infer)


def port_lenet(variables, wire="float32", infer="float32", name="lenet5"):
    """The port's serving model of LeNet-5 with ``variables``, on the
    CPU."""
    return CheckpointServingModel(name, get_config("lenet5"),
                                  tz.port("lenet5", variables),
                                  wire_dtype=wire, infer_dtype=infer,
                                  device="cpu")


def images(n, seed=0, wire="float32", shape=(32, 32, 1)):
    """``n`` seeded inputs: normalized noise on the float32 wire, raw
    bytes on the uint8 wire."""
    rng = np.random.RandomState(seed)
    if wire == "uint8":
        return rng.randint(0, 256, (n, *shape)).astype(np.uint8)
    return rng.randn(n, *shape).astype(np.float32)


def write_step(workdir, step, model, sub="checkpoints"):
    """Checkpoint ``step`` of ``model`` under ``workdir`` as the port's
    trainer writes it (``<workdir>/checkpoints/<step>/checkpoint.pt``);
    returns the step directory."""
    state = TrainState(model, port_optimizer(PortOptConfig(), model), 0)
    return Checkpointer(os.path.join(workdir, sub)).save(
        step, state, extras={"epoch": step})


def lenet_model(seed):
    """A port LeNet-5 with seeded flax weights (the checkpoint payload
    of a "trained" model)."""
    return tz.port("lenet5", lenet_variables(seed))


def post(port, path, body, headers=None, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(port, path, text=False):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            blob = r.read()
            return r.status, blob.decode() if text else json.loads(blob)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
