"""The port stands alone: ``deep_vision_tpu_torch`` imports neither JAX
nor the JAX package, and its entry points refuse to run without CUDA
unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import deep_vision_tpu_torch

PKG_DIR = os.path.dirname(deep_vision_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="deep_vision_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "deep_vision_tpu_torch.serve.engine" in mods
    assert "deep_vision_tpu_torch.core.trainer" in mods
    assert "deep_vision_tpu_torch.cli.train" in mods
    assert "deep_vision_tpu_torch.ops.best_iou" in mods
    assert "deep_vision_tpu_torch.tasks.detection" in mods
    assert "deep_vision_tpu_torch.data.detection" in mods
    for new in ("models.hourglass", "models.centernet", "tasks.centernet",
                "zoo.centernet", "tasks.pose", "data.pose", "zoo.pose",
                "models.lenet", "models.alexnet", "models.vgg",
                "models.inception", "models.mobilenet", "models.shufflenet",
                "zoo.classifiers", "zoo.lenet", "data.mnist",
                "serve.faults", "serve.models", "serve.cache", "obs.mfu",
                "serve.replicas", "deploy.history", "deploy.watcher",
                "deploy.autoscale", "serve.cascade", "serve.brownout",
                "serve.edge", "serve.gateway", "cli.gateway", "serve.jobs",
                "serve.batch_sched", "core.step_graph", "models.pretrained",
                "core.tboard", "core.upload", "core.export", "cli.infer",
                "viz", "data.prep", "data.native", "cli.prepare_data",
                "parallel", "parallel.mesh", "parallel.distributed"):
        assert f"deep_vision_tpu_torch.{new}" in mods
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "             'deep_vision_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'deep_vision_tpu') and sys.modules[n] is not None)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.startswith("ok")


FORBIDDEN = [
    re.compile(r"^\s*import\s+(jax|jaxlib|flax|optax|orbax)\b", re.M),
    re.compile(r"^\s*from\s+(jax|jaxlib|flax|optax|orbax)\b", re.M),
    re.compile(r"\bimport\s+deep_vision_tpu\b(?!_torch)"),
    re.compile(r"\bfrom\s+deep_vision_tpu\."),
    re.compile(r"\bfrom\s+deep_vision_tpu\s+import\b"),
]


def _sources():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "kernel_ab.py")


def test_no_jax_or_reference_imports_in_source():
    hits = []
    for path in _sources():
        with open(path) as fh:
            text = fh.read()
        for pat in FORBIDDEN:
            for m in pat.finditer(text):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0)!r}")
    assert not hits, "\n".join(hits)


def test_forbidden_patterns_catch_the_prefix_trap():
    assert FORBIDDEN[2].search("import deep_vision_tpu")
    assert not FORBIDDEN[2].search("import deep_vision_tpu_torch")
    assert FORBIDDEN[3].search("from deep_vision_tpu.serve import x")
    assert not FORBIDDEN[3].search("from deep_vision_tpu_torch.serve import x")


@pytest.fixture()
def no_cuda(monkeypatch):
    """Entry points must refuse a missing GPU even on a machine with one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_requires_cuda_unless_cpu(no_cuda):
    import torch

    from deep_vision_tpu_torch.core.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_registry_and_cli_require_cuda_unless_cpu(no_cuda):
    from deep_vision_tpu_torch.cli import serve as cli
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    with pytest.raises(RuntimeError):
        ModelRegistry().load_checkpoint("resnet50", wire_dtype="uint8",
                                        infer_dtype="int8")
    with pytest.raises(RuntimeError):
        cli.build_server(cli.build_parser().parse_args(
            ["-m", "resnet50", "--infer-dtype", "int8", "--port", "0"]))


def test_train_cli_requires_cuda_unless_cpu(no_cuda, tmp_path):
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.trainer import Trainer

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["-m", "resnet50", "--synthetic",
                  "--workdir", str(tmp_path)])
    from deep_vision_tpu_torch.core.config import get_config

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(get_config("resnet50"), None, None, workdir=str(tmp_path))
    assert not os.listdir(tmp_path)  # both refused before touching the disk


def test_cli_serves_on_cpu_when_asked(tmp_path):
    """The CLI wiring (parse → registry → engine → server) on the CPU,
    with a tiny registered config and --weights through convert.py."""
    import json
    import urllib.request

    import numpy as np
    import torch

    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.cli import serve as cli
    from deep_vision_tpu_torch.core.config import TrainConfig, register_config
    from deep_vision_tpu_torch.models.resnet import BasicBlock, ResNet

    def ctor():
        return ResNet((1,), BasicBlock, 5, torch.bfloat16)

    register_config("torch_port_cli_tiny")(
        lambda: TrainConfig(name="torch_port_cli_tiny", model=ctor,
                            image_size=16, num_classes=5))
    model = ctor().reset_parameters(torch.Generator().manual_seed(0))
    variables = convert.import_torch_resnet(model.state_dict(),
                                            stage_sizes=(1,),
                                            block="BasicBlock")
    weights = str(tmp_path / "w.npz")
    convert.save_npz(weights, variables)
    args = cli.build_parser().parse_args(
        ["-m", "torch_port_cli_tiny", "--weights", weights,
         "--wire-dtype", "uint8", "--infer-dtype", "int8", "--port", "0",
         "--max-batch", "2", "--warmup", "--device", "cpu"])
    engine, server = cli.build_server(args)
    server.start_background()
    try:
        assert engine.model.weights == weights
        assert engine.model.params_digest
        x = np.random.RandomState(0).randint(0, 256, (16, 16, 3))
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/classify",
            data=json.dumps({"pixels": x.tolist(), "top_k": 2}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert len(body["top"]) == 2
    finally:
        server.shutdown()
        engine.stop()
