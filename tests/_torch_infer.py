"""Shared helpers of the cli.infer parity tests (tests/test_torch_infer.py,
test_torch_infer_detect.py, test_torch_infer_eval.py): a port workdir
holding seeded flax variables, the reference's ``_load_state`` pointed
at the same variables (its own reads Orbax checkpoints), image files
and the CLIs' printed lines."""

import numpy as np
from PIL import Image

import _torch_serve as ts
from deep_vision_tpu.cli import infer as jinfer
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState as JaxTrainState
from deep_vision_tpu_torch.core.config import get_config


def ref_state(cfg_name, variables):
    """What the reference's ``_load_state`` returns, from ``variables``."""
    cfg = jax_get_config(cfg_name)
    jm = cfg.model()
    state = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        tx=build_optimizer(OptimizerConfig()),
        batch_stats=variables.get("batch_stats", {}))
    return jm, state


def point_reference(monkeypatch, cfg_name, variables):
    monkeypatch.setattr(jinfer, "_load_state",
                        lambda cfg, wd: ref_state(cfg_name, variables))


def workdir(tmp_path, cfg_name, variables):
    """A port workdir holding ``variables`` (one checkpoint)."""
    from deep_vision_tpu_torch.core.restore import import_weights

    model = get_config(cfg_name).model()
    import_weights(model, variables)
    wd = str(tmp_path / "wd")
    ts.write_step(wd, 1, model)
    return wd


def images(tmp_path, n, shape, seed=0, mode=None):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"img{i}.png")
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        Image.fromarray(arr, mode).save(p)
        paths.append(p)
    return paths


def lines(capsys, prefix):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(prefix)]
