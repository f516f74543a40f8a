"""``cli.serve``'s mesh flags against the reference's: ``--shard-batches``,
``--mesh D,M``, ``--partition-rules``, ``--partition-strict`` and
``--partition-min-dim``.

The reference's parser is caught at its ``parse_args`` (its ``main``
builds it inline) and compared action by action; both packages'
``_parse_mesh_arg`` and ``build_server`` refuse the same inputs with the
same words.  A ``--mesh 2,2`` server of each package (the reference on
conftest's forced host devices with its ``load_state`` pointed at seeded
LeNet-5 variables, the port on ``--device cpu`` reading the same
variables from ``--weights``) answers ``/v1/classify`` alike, and the
port's ``/metrics`` gauges ``dvt_serve_mesh_shape`` (one sample an axis)
and ``dvt_serve_param_shard_bytes`` agree with its ``/v1/stats`` and
equal the reference's lines."""

import argparse
import json
import urllib.request

import numpy as np
import pytest
import torch

from _torch_serve import lenet_variables
from deep_vision_tpu.cli import serve as jax_cli
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState as JaxTrainState
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.cli import serve as cli
from deep_vision_tpu_torch.serve.http import ServeServer

pytestmark = [pytest.mark.serve, pytest.mark.mesh]

MESH_DESTS = ("shard_batches", "mesh", "partition_rules", "partition_strict",
              "partition_min_dim")


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            jax_cli.main([])
    return seen["parser"]


def _actions(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.default,
                     getattr(a.type, "__name__", a.type), a.nargs)
            for a in parser._actions if a.dest in MESH_DESTS}


def test_mesh_flag_actions_equal_the_reference(monkeypatch):
    want = _actions(_reference_parser(monkeypatch))
    assert sorted(want) == sorted(MESH_DESTS)
    assert _actions(cli.build_parser()) == want


@pytest.mark.parametrize("extra", [
    [], ["--shard-batches", "--serve-devices", "2"],
    ["--mesh", "2,2", "--partition-rules", "classifier",
     "--partition-strict", "--partition-min-dim", "64"],
    ["--mesh", "4", "--partition-rules", "head/kernel=-,model;.*="]],
    ids=["defaults", "shard", "mesh", "mesh1"])
def test_mesh_flags_parse_to_the_reference(monkeypatch, extra):
    argv = ["-m", "lenet5", "--workdir", "w", "--port", "0"] + extra
    ref = _reference_parser(monkeypatch).parse_args(argv)
    mine = cli.build_parser().parse_args(argv)
    assert {k: getattr(mine, k) for k in MESH_DESTS + ("serve_devices",)} \
        == {k: getattr(ref, k) for k in MESH_DESTS + ("serve_devices",)}


@pytest.mark.parametrize("spec", ["2,2", "4", "1,4", " 2 , 2 ", "4,1,",
                                  "0,2", "2,-1", "a,b", "2,2,2", ""])
def test_parse_mesh_arg_equals_the_reference(spec):
    out = []
    for mod in (jax_cli, cli):
        try:
            out.append(mod._parse_mesh_arg(spec))
        except ValueError as e:
            out.append(str(e))
    assert out[1] == out[0]


def _jax_args(**kw):
    base = dict(models=None, model="lenet5", stablehlo=None, buckets=None,
                workdir=None, watch=False, max_replicas=0, min_replicas=0,
                serve_devices=1, max_batch=4, max_wait_ms=1.0, faults=None,
                shard_batches=False, mesh=None, partition_rules=None,
                partition_strict=False, partition_min_dim=64,
                max_queue=64, wire_dtype="float32")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("argv,jax_kw,match", [
    (["-m", "lenet5", "--mesh", "2,2", "--shard-batches"],
     {"mesh": "2,2", "shard_batches": True}, "subsumes"),
    (["--models", "lenet5", "--shard-batches"],
     {"models": "lenet5", "model": None, "shard_batches": True},
     "single-model only"),
    (["--models", "lenet5", "--mesh", "2,2"],
     {"models": "lenet5", "model": None, "mesh": "2,2"},
     "single-model only"),
])
def test_conflicts_raise_the_reference_words(tmp_path, argv, jax_kw, match):
    workdir = str(tmp_path)
    words = []
    with pytest.raises(ValueError, match=match) as e:
        jax_cli.build_server(_jax_args(workdir=workdir, **jax_kw))
    words.append(str(e.value))
    with pytest.raises(ValueError, match=match) as e:
        cli.build_server(cli.build_parser().parse_args(
            argv + ["--workdir", workdir, "--device", "cpu", "--port",
                    "0"]))
    words.append(str(e.value))
    assert words[1] == words[0]


def test_a_mesh_beyond_the_machine_raises_the_reference_words(
        tmp_path, monkeypatch):
    """--mesh 4,4 on 8 local devices: the reference on its 8 forced host
    devices, the port on 8 faked GPUs under --device cuda."""
    with pytest.raises(ValueError) as e:
        jax_cli.build_server(_jax_args(workdir=str(tmp_path), mesh="4,4"))
    want = str(e.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError) as e:
        cli.build_server(cli.build_parser().parse_args(
            ["-m", "lenet5", "--mesh", "4,4", "--port", "0"]))
    assert str(e.value) == want
    assert "needs 16 device(s); only 8 local device(s) present" in want


@pytest.mark.parametrize("flag", [["--mesh", "2,2"], ["--shard-batches"]])
def test_mesh_flags_run_on_cuda_unless_asked_for_the_cpu(flag):
    """The default ``--device cuda`` on a machine without a GPU raises
    before any model work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build_server(cli.build_parser().parse_args(
            ["-m", "lenet5", "--port", "0", *flag]))


@pytest.mark.parametrize("flags,match", [
    (["--partition-rules", "no-equals"], "expected regex=axes"),
    (["--partition-rules", "Dense_0/kernel=-,model", "--partition-strict"],
     "matches no rule"),
    (["--partition-rules", "Conv_0/kernel=model;.*="],
     "should be divisible by 2"),
])
def test_partition_flag_refusals(tmp_path, flags, match):
    """The rule flags refuse what the reference's refuse, in its words."""
    words = []
    ns = _reference_parser_args(["-m", "lenet5", "--workdir",
                                 str(tmp_path), "--mesh", "2,2",
                                 "--wire-dtype", "float32", *flags])
    with pytest.raises(ValueError, match=match) as e:
        jax_cli.build_server(ns)
    words.append(_plain(str(e.value)))
    with pytest.raises(ValueError, match=match) as e:
        cli.build_server(cli.build_parser().parse_args(
            ["-m", "lenet5", "--device", "cpu", "--mesh", "2,2", "--port",
             "0", "--wire-dtype", "float32", *flags]))
    words.append(str(e.value))
    assert words[1] == words[0]


def _plain(words: str) -> str:
    return words.replace(", axis_types=(Auto, Auto)", "") \
        .replace(", memory_kind=device", "")


def _reference_parser_args(argv):
    mp = pytest.MonkeyPatch()
    try:
        return _reference_parser(mp).parse_args(argv)
    finally:
        mp.undo()


@pytest.fixture
def seeded(tmp_path, monkeypatch):
    """The seeded LeNet-5 variables as the reference's restore and as
    the port's ``--weights`` npz."""
    import deep_vision_tpu.core.restore as jrestore

    v = lenet_variables(0)
    path = str(tmp_path / "lenet5.npz")
    convert.save_npz(path, v)

    def load_state(cfg, workdir, **kw):
        info = kw.get("info")
        if info is not None:
            info.update(step=None, dir=None, fallback=False, mtime=None,
                        digest=None)
        m = cfg.model()
        return m, JaxTrainState.create(
            apply_fn=m.apply, params=v["params"],
            tx=build_optimizer(OptimizerConfig()),
            batch_stats=v.get("batch_stats", {}))

    monkeypatch.setattr(jrestore, "load_state", load_state)
    assert jax_get_config("lenet5").num_classes == 10
    return path


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/classify", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode()


def _series(text, names):
    return sorted(ln for ln in text.splitlines()
                  if any(n in ln for n in names))


def test_mesh_2x2_server_answers_as_the_reference(seeded, tmp_path):
    flags = ["--mesh", "2,2", "--partition-min-dim", "64", "--wire-dtype",
             "float32", "--max-batch", "4", "--port", "0"]
    ns = _reference_parser_args(["-m", "lenet5", "--workdir", str(tmp_path),
                                 *flags])
    jeng, jsrv = jax_cli.build_server(ns)
    peng, psrv = cli.build_server(cli.build_parser().parse_args(
        ["-m", "lenet5", "--weights", seeded, "--device", "cpu", *flags]))
    gauges = ("dvt_serve_mesh_shape", "dvt_serve_param_shard_bytes")
    try:
        jsrv.start_background()
        psrv.start_background()
        rng = np.random.RandomState(4)
        for _ in range(6):
            body = json.dumps({"pixels": rng.randn(32, 32, 1).tolist(),
                               "top_k": 5}).encode()
            (js, jr), (ps, pr) = _post(jsrv.port, body), \
                _post(psrv.port, body)
            assert js == ps == 200
            assert [t["class"] for t in pr["top"]] == \
                [t["class"] for t in jr["top"]]
            np.testing.assert_allclose([t["logit"] for t in pr["top"]],
                                       [t["logit"] for t in jr["top"]],
                                       rtol=1e-5, atol=1e-5)
        stats = json.loads(_get(psrv.port, "/v1/stats"))["lenet5"]
        health = json.loads(_get(psrv.port, "/v1/healthz"))
        assert stats["mesh_shape"] == {"data": 2, "model": 2}
        assert health["engines"]["lenet5"]["mesh_shape"] == \
            {"data": 2, "model": 2}
        assert 0 < stats["param_shard_bytes"] < stats["param_global_bytes"]
        assert stats["buckets"] == [2, 4]
        mine = _series(_get(psrv.port, "/metrics"), gauges)
        assert f'dvt_serve_param_shard_bytes{{model="lenet5"}} ' \
               f'{stats["param_shard_bytes"]}' in mine
        for axis, size in stats["mesh_shape"].items():
            assert f'dvt_serve_mesh_shape{{axis="{axis}",model="lenet5"}} ' \
                   f'{size}' in mine
        assert mine == _series(_get(jsrv.port, "/metrics"), gauges)
    finally:
        for srv, eng in ((jsrv, jeng), (psrv, peng)):
            srv.shutdown()
            eng.stop()


@pytest.fixture
def dvt_logger_restored():
    """``main`` attaches a stderr handler to the ``dvt`` logger
    (``obs/log.configure_logging``) that outlives the test, bound to the
    capture stream pytest closes after it; put the logger back as it
    was, so a later test of this process logs through it unchanged."""
    import logging

    root = logging.getLogger("dvt")
    saved = (list(root.handlers), root.level, root.propagate)
    yield
    root.handlers[:] = saved[0]
    root.setLevel(saved[1])
    root.propagate = saved[2]


def test_boot_lines_and_shard_batches(seeded, monkeypatch, capsys,
                                      dvt_logger_restored):
    """``main`` prints the mesh, the per-chip and logical bytes; with
    --shard-batches over 2 CPUs, the sharded-batches line and the
    reference's bucket ladder."""
    monkeypatch.setattr(ServeServer, "serve_forever",
                        lambda self: (_ for _ in ()).throw(
                            KeyboardInterrupt()))
    common = ["-m", "lenet5", "--weights", seeded, "--device", "cpu",
              "--port", "0", "--wire-dtype", "float32", "--max-batch", "8",
              "--drain-deadline", "0"]
    assert cli.main(common + ["--mesh", "2,2", "--partition-min-dim",
                              "64"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 2-D mesh 2×2 data×model: sharded over 4 devices " \
           "['cpu', 'cpu', 'cpu', 'cpu'] (cpu); per-chip params " \
           "128,984 B of 246,824 B logical" in out
    assert "buckets=[2, 4, 8]" in out
    assert cli.main(common + ["--shard-batches", "--serve-devices",
                              "2"]) == 0
    out = capsys.readouterr().out
    assert "[serve] sharded batches: sharded over 2 devices " \
           "['cpu', 'cpu'] (cpu)" in out
    assert "buckets=[2, 4, 8]" in out
