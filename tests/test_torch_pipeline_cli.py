"""``cli.train --mesh data=1,pipe=4 --microbatches 2 --device cpu`` on the
CPU: ``hourglass_toy`` (four stacks) trains on a pipe grid of four CPU
places with the reference's ``[pipeline]`` line, its checkpoints hold
the pipelined layout and resume bit for bit, and ``load_state`` of its
workdir serves the monolithic ``StackedHourglass`` with the EMA copy;
``--microbatches`` without a pipe axis is ignored; a pipe axis on a
family with no stage sequence exits with the reference's words, and a
``spatial`` axis above 1 names the module still to be ported.  A
ShuffleNet workdir, whose ``state_dict`` has ``stem.`` and ``stages.``
beside ``fc.``, restores as its own network, not as a pipeline
layout."""

import argparse
import os

import pytest
import torch

import jax

from deep_vision_tpu.cli.train import _maybe_pipelined as jax_maybe_pipelined
from deep_vision_tpu.models.hourglass import StackedHourglass as JaxHourglass
from deep_vision_tpu.models.yolo import YoloV3 as JaxYolo
from deep_vision_tpu.parallel import make_mesh as jax_make_mesh
from deep_vision_tpu_torch.cli import train as cli
from deep_vision_tpu_torch.core.checkpoint import Checkpointer
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.optim import build_optimizer
from deep_vision_tpu_torch.core.restore import (
    EMA_WEIGHTS,
    PIPELINE_LAYOUT,
    checkpoint_weights,
    load_state,
)
from deep_vision_tpu_torch.core.state import TrainState
from deep_vision_tpu_torch.models.hourglass import (
    StackedHourglass,
    merge_stacked_variables,
)
from deep_vision_tpu_torch.parallel.pipelined import is_pipelined_state

ARGS = ["-m", "hourglass_toy", "--mesh", "data=1,pipe=4", "--microbatches",
        "2", "--device", "cpu", "--synthetic", "--synthetic-size", "16",
        "--batch-size", "8", "--ema-decay", "0.9"]


def _train(workdir, epochs: int, *extra) -> int:
    return cli.main([*ARGS, "--workdir", str(workdir), "--epochs",
                     str(epochs), *extra])


def test_pipe_grid_trains_resumes_and_serves_the_monolithic_network(
        tmp_path, capsys):
    assert _train(tmp_path / "a", 1) == 0
    out = capsys.readouterr().out
    mesh = jax_make_mesh({"data": 1, "pipe": 4}, devices=jax.devices()[:4])
    jax_maybe_pipelined(JaxHourglass(num_stack=4, num_heatmap=8,
                                     filters=16, order=2), mesh,
                        argparse.Namespace(microbatches=2))
    want = capsys.readouterr().out.strip()
    assert want == "[pipeline] 4 stages over pipe=4, 2 microbatches"
    assert want in out.splitlines()
    ckpt = Checkpointer(str(tmp_path / "a" / "checkpoints"))
    assert ckpt.all_steps() == [2]
    payload = ckpt.load()
    keys = list(payload["state"]["model"])
    assert all(k.startswith(("stem.", "stages.")) for k in keys)
    assert "stages.3.reinject_heat.weight" in keys
    # the workdir serves the monolithic network with the EMA copy
    info = {}
    model = load_state(get_config("hourglass_toy"),
                       workdir=str(tmp_path / "a"), info=info)
    assert isinstance(model, StackedHourglass)
    assert info["layout"] == PIPELINE_LAYOUT
    assert info["ema"] == EMA_WEIGHTS
    assert info["dir"].endswith("checkpoints_best")
    best = Checkpointer(info["dir"]).load(info["step"])
    merged = merge_stacked_variables(checkpoint_weights(best), 4)
    served = model.state_dict()
    assert set(merged) == set(served)
    for k, v in served.items():
        assert torch.equal(v, merged[k]), k
    # a resumed second epoch is the straight two-epoch run bit for bit
    assert _train(tmp_path / "a", 2, "--resume") == 0
    assert _train(tmp_path / "b", 2) == 0
    assert "[resume] restored step=2 start_epoch=2" in \
        capsys.readouterr().out
    resumed, straight = (Checkpointer(str(tmp_path / d / "checkpoints"))
                         .load(4)["state"] for d in ("a", "b"))
    for part in ("model", "ema"):
        for k, v in straight[part].items():
            assert torch.equal(resumed[part][k], v), (part, k)
    for k, v in straight["optimizer"]["mu"].items():
        assert torch.equal(resumed["optimizer"]["mu"][k], v), k


def test_microbatches_without_a_pipe_axis_train_the_monolithic_network(
        tmp_path, capsys):
    argv = [a for a in ARGS if a not in ("--mesh", "data=1,pipe=4")]
    assert cli.main([*argv, "--workdir", str(tmp_path), "--epochs",
                     "1"]) == 0
    assert "[pipeline]" not in capsys.readouterr().out
    keys = Checkpointer(str(tmp_path / "checkpoints")).load()["state"][
        "model"]
    assert "stem_conv.weight" in keys


def _exit(fn, *a) -> str:
    with pytest.raises(SystemExit) as e:
        fn(*a)
    return str(e.value)


def test_a_pipe_axis_on_another_family_exits_with_the_reference_words(
        tmp_path):
    mesh = jax_make_mesh({"data": 1, "pipe": 2}, devices=jax.devices()[:2])
    want = _exit(jax_maybe_pipelined, JaxYolo(num_classes=3), mesh,
                 argparse.Namespace(microbatches=None))
    got = _exit(cli.main, ["-m", "yolov3_toy", "--mesh", "data=1,pipe=2",
                           "--device", "cpu", "--synthetic", "--workdir",
                           str(tmp_path)])
    assert got.rsplit("got ", 1)[0] == want.rsplit("got ", 1)[0]
    assert got.startswith("--mesh pipe axis: pipeline training mode "
                          "supports the stacked-hourglass families")
    got = _exit(cli.main, ["-m", "dcgan", "--mesh", "data=1,pipe=2",
                           "--device", "cpu", "--synthetic", "--workdir",
                           str(tmp_path)])
    assert got.startswith(want.rsplit("got ", 1)[0])
    assert not os.listdir(tmp_path)


def test_a_spatial_axis_names_the_module_still_to_be_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="parallel/spatial.py"):
        cli.main(["-m", "hourglass_toy", "--mesh", "data=1,spatial=2",
                  "--device", "cpu", "--synthetic", "--workdir",
                  str(tmp_path)])


def test_a_shufflenet_workdir_restores_its_own_step(tmp_path):
    cfg = get_config("shufflenet1")
    model = cfg.model()
    keys = list(model.state_dict())
    assert any(k.startswith("stem.") for k in keys)
    assert any(k.startswith("stages.") for k in keys)
    assert not is_pipelined_state(model.state_dict())
    state = TrainState(model, build_optimizer(cfg.optimizer, model), 0)
    Checkpointer(str(tmp_path / "checkpoints")).save(7, state)
    info, lines = {}, []
    served = load_state(cfg, workdir=str(tmp_path), info=info,
                        log=lines.append)
    assert info["step"] == 7 and info["layout"] is None, lines
    assert not any("WARNING" in line for line in lines), lines
    got = served.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
