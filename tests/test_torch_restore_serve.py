"""Serving a training workdir on the CPU: the port's ``core/restore.py``
walks ``<workdir>/checkpoints[_best]/<step>/checkpoint.pt`` as the
reference walks its Orbax steps (mirrors tests/test_faults.py's
restore-fallback case and tests/test_models_plane.py's restore stamps).

A torn newest step falls back to the step before it, with the step, the
fallback flag, the step directory's mtime and the weights' digest
stamped; a save in progress (a ``.<step>-*`` temporary directory) is
invisible; ``cli.train -m lenet5`` followed by ``cli.serve --workdir``
answers exactly as a direct call of the checkpoint it restored."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_serve import get, lenet_model, post, write_step
from deep_vision_tpu_torch.core.checkpoint import FILENAME
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.restore import (
    RAW_WEIGHTS,
    checkpoint_fingerprint,
    load_state,
    params_digest,
)
from deep_vision_tpu_torch.serve.registry import ModelRegistry

pytestmark = [pytest.mark.serve, pytest.mark.chaos]


def _torn_workdir(tmp_path):
    """Steps 1-3 of distinct seeded weights, step 3's file truncated, a
    save in progress beside them, and an empty step directory."""
    wd = str(tmp_path / "wd")
    for step in (1, 2, 3):
        write_step(wd, step, lenet_model(step))
    path = os.path.join(wd, "checkpoints", "3", FILENAME)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    os.makedirs(os.path.join(wd, "checkpoints", ".4-inprogress"))
    os.makedirs(os.path.join(wd, "checkpoints", "5"))
    return wd


def test_torn_newest_step_falls_back(tmp_path):
    wd = _torn_workdir(tmp_path)
    logs, info = [], {}
    model = load_state(get_config("lenet5"), workdir=wd, log=logs.append,
                       info=info)
    step_dir = os.path.join(wd, "checkpoints", "2")
    want = lenet_model(2)
    assert info["step"] == 2 and info["fallback"] is True
    assert info["dir"] == os.path.join(wd, "checkpoints")
    assert info["mtime"] == os.path.getmtime(step_dir)
    assert info["digest"] == params_digest(want) == params_digest(model)
    assert info["weights"] is None and info["ema"] == RAW_WEIGHTS
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert not model.training
    assert any("step 3" in m and "falling back" in m for m in logs)
    assert any("FALLBACK" in m for m in logs)
    # the probe reads names only: the torn step 3 is still the newest
    # complete-looking one; the temporary and the empty step are not
    fp = checkpoint_fingerprint(wd)
    assert fp["step"] == 3
    assert fp["mtime"] == os.path.getmtime(os.path.join(wd, "checkpoints",
                                                        "3"))


def test_sources_order_and_random_init(tmp_path):
    cfg = get_config("lenet5")
    wd = str(tmp_path / "wd")
    info = {}
    load_state(cfg, workdir=wd, log=lambda _m: None, info=info)
    assert info["step"] is None and info["mtime"] is None
    assert info["digest"]  # a digest even for the random init
    assert checkpoint_fingerprint(wd) == {"step": None, "dir": None,
                                          "mtime": None}
    write_step(wd, 7, lenet_model(7))
    write_step(wd, 4, lenet_model(4), sub="checkpoints_best")
    info = {}
    load_state(cfg, workdir=wd, log=lambda _m: None, info=info)
    # checkpoints_best first, as the reference searches
    assert (info["step"], info["fallback"]) == (4, False)
    assert checkpoint_fingerprint(wd)["step"] == 4


def test_every_step_torn_falls_to_next_source(tmp_path):
    wd = str(tmp_path / "wd")
    write_step(wd, 9, lenet_model(9), sub="checkpoints_best")
    with open(os.path.join(wd, "checkpoints_best", "9", FILENAME),
              "wb") as f:
        f.write(b"\x00corrupt\x00")
    write_step(wd, 2, lenet_model(2))
    logs, info = [], {}
    load_state(get_config("lenet5"), workdir=wd, log=logs.append,
               info=info)
    assert info["step"] == 2
    assert any("every retained checkpoint" in m for m in logs)


def test_registry_stamps_restore(tmp_path):
    wd = _torn_workdir(tmp_path)
    sm = ModelRegistry().load_checkpoint("lenet5", workdir=wd,
                                         device="cpu")
    d = sm.describe()
    assert sm.restored_step == 2 and sm.restore_fallback is True
    assert d["restored_step"] == 2 and d["restore_fallback"] is True
    assert d["params_digest"] == params_digest(lenet_model(2))
    assert d["restored_mtime"] == os.path.getmtime(
        os.path.join(wd, "checkpoints", "2"))


def test_weights_and_workdir_are_exclusive():
    from deep_vision_tpu_torch.cli import serve as cli

    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["-m", "lenet5", "--weights", "w.npz",
                                       "--workdir", "wd"])


def test_cli_train_then_serve_workdir(tmp_path, capsys):
    """A model the port's trainer wrote is served by the port's server,
    answering as a direct call of the restored checkpoint."""
    from deep_vision_tpu_torch.cli import serve as cli_serve
    from deep_vision_tpu_torch.cli import train as cli_train

    wd = str(tmp_path / "run")
    assert cli_train.main(["-m", "lenet5", "--synthetic",
                           "--synthetic-size", "64", "--epochs", "1",
                           "--batch-size", "32", "--device", "cpu",
                           "--workdir", wd]) == 0
    args = cli_serve.build_parser().parse_args(
        ["-m", "lenet5", "--workdir", wd, "--wire-dtype", "uint8",
         "--port", "0", "--max-batch", "4", "--device", "cpu"])
    engine, server = cli_serve.build_server(args)
    server.start_background()
    try:
        sm = engine.model
        assert sm.restored_step is not None and not sm.restore_fallback
        # the weights the server restored, loaded by hand
        src = os.path.join(wd, "checkpoints_best") \
            if os.path.isdir(os.path.join(wd, "checkpoints_best")) \
            else os.path.join(wd, "checkpoints")
        payload = torch.load(os.path.join(src, str(sm.restored_step),
                                          FILENAME), weights_only=True)
        trained = get_config("lenet5").model()
        trained.load_state_dict(payload["state"]["model"])
        assert sm.params_digest == params_digest(trained)
        from deep_vision_tpu_torch.ops.ingest import serve_ingest_plain

        x = np.random.RandomState(3).randint(0, 256, (1, 32, 32, 1),
                                             np.uint8)
        with torch.no_grad():
            want = trained.eval()(serve_ingest_plain(
                torch.from_numpy(x), "mnist", quantize=False))[0].numpy()
        status, body, _ = post(server.port, "/v1/classify",
                               {"pixels": x[0].tolist(), "top_k": 10})
        assert status == 200
        got = {t["class"]: t["logit"] for t in body["top"]}
        assert got == {c: float(want[c]) for c in range(10)}
        status, listing = get(server.port, "/v1/models")
        described = listing["models"]["lenet5"]["model"]
        assert described["restored_step"] == sm.restored_step
        assert json.dumps(described["params_digest"]) == \
            json.dumps(params_digest(trained))
    finally:
        server.shutdown()
        engine.stop()
