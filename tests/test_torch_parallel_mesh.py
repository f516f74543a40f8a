"""The port's mesh and process-group helpers (``deep_vision_tpu_torch/
parallel``) against the reference's ``deep_vision_tpu/parallel``: mesh
specs and ``-1``, the reference's ``ValueError`` words, the global-batch
divisibility check, the axes a later slice brings, and ``initialize()``
as a no-op or reading ``torch.distributed.run``'s variables (in child
processes, so this one never joins a group)."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from _torch_dist_worker import free_port
from deep_vision_tpu.parallel import distributed as jax_distributed
from deep_vision_tpu.parallel import make_mesh as jax_make_mesh
from deep_vision_tpu.parallel import shard_batch as jax_shard_batch
from deep_vision_tpu.parallel import (
    shard_batch_stacked as jax_shard_batch_stacked,
)
from deep_vision_tpu_torch.core.trainer import check_scan_backend
from deep_vision_tpu_torch.parallel import (
    DATA_AXIS,
    batch_sharding,
    distributed,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_batch_stacked,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK")


def _error(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_default_mesh_is_one_rank_on_data_without_a_group():
    mesh = make_mesh()
    assert mesh.shape == {DATA_AXIS: 1} and not mesh.grouped
    assert mesh.rank == 0 and mesh.is_writer and not mesh.reduces
    assert mesh.devices.tolist() == [0]
    # every collective is a no-op without a group
    t = torch.ones(3)
    assert mesh.all_reduce_(t) is t and t.tolist() == [1.0] * 3
    assert mesh.any(True) and not mesh.any(False)
    assert mesh.gather_objects({"a": 1}) == [{"a": 1}]
    assert mesh.broadcast_object(7) == 7
    mesh.barrier()
    model = torch.nn.Linear(2, 2)
    before = model.weight.detach().clone()
    assert replicate(model, mesh) is model
    assert torch.equal(model.weight, before)


@pytest.mark.parametrize("spec", [{"data": -1}, {"model": 1, "data": -1},
                                  {"data": 1}])
def test_minus_one_resolves_as_the_reference(spec):
    want = jax_make_mesh(spec, devices=jax.devices()[:1])
    got = make_mesh(spec)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)


@pytest.mark.parametrize("spec", [{"data": 2}, {"data": 4, "model": 2}])
def test_too_large_a_mesh_raises_the_reference_words(spec):
    want = _error(jax_make_mesh, spec, devices=jax.devices()[:1])
    assert _error(make_mesh, spec) == want
    assert "needs" in want and "have 1" in want


def test_pod_mesh_resolves_minus_one_against_the_world():
    assert distributed.make_pod_mesh({"data": -1}).shape == {"data": 1}
    want = jax_distributed.make_pod_mesh({"data": -1})
    assert want.shape["data"] == len(jax.devices())


@pytest.mark.parametrize("axis,later", [("model", "parallel/partition.py"),
                                        ("spatial", "parallel/spatial.py")])
def test_axes_of_later_slices_are_refused_naming_them(axis, later):
    with pytest.raises(NotImplementedError, match=later):
        make_mesh({"data": 2, axis: 2}, devices=list(range(4)))
    # a size-1 axis is no parallelism: accepted
    assert make_mesh({"data": 1, axis: 1}).shape == {"data": 1, axis: 1}


@pytest.mark.parametrize("device,want", [
    ("cpu", ["cpu"] * 4), ("cuda:3", ["cuda:3"] * 4)])
def test_the_pipe_axis_is_a_grid_of_the_rank_s_places(device, want):
    """``pipe`` lies inside a rank: data=2,pipe=4 is two ranks, each with
    four places; an explicit device is every place."""
    mesh = make_mesh({"data": 2, "pipe": 4}, devices=[0, 1],
                     pipe_device=device)
    assert mesh.shape == {"data": 2, "pipe": 4}
    assert mesh.pipe_size == 4 and mesh.data_size == 2
    assert [str(d) for d in mesh.pipe_devices] == want
    assert mesh.devices.shape == (2,)
    # the pipe axis counts no rank: data=2,pipe=4 over 8 ranks is short
    with pytest.raises(ValueError, match="uses 2 of the 8 ranks"):
        make_mesh({"data": 2, "pipe": 4}, devices=list(range(8)),
                  pipe_device="cpu")
    # a size-1 pipe axis is one place
    assert make_mesh({"data": 1, "pipe": 1}, pipe_device="cpu") \
        .pipe_devices == [torch.device("cpu")]
    # -1 resolves over the ranks alone
    assert make_mesh({"data": -1, "pipe": 4}, devices=[0, 1],
                     pipe_device="cpu").shape == {"data": 2, "pipe": 4}


def test_a_pipe_grid_larger_than_the_machine_raises(monkeypatch):
    """Plain cuda takes cards r·p … r·p+p−1 and raises the reference's
    words on a machine with fewer; it never falls back to the CPU."""
    from deep_vision_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in mesh_mod.pipe_places(2, "cuda", 1)] == \
        ["cuda:2", "cuda:3"]
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        mesh_mod.pipe_places(2, None, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_mesh({"data": 1, "pipe": 4})


def test_a_mesh_must_hold_every_rank():
    with pytest.raises(ValueError, match="every rank"):
        make_mesh({"data": 2}, devices=list(range(4)))


def test_indivisible_global_batch_raises_the_reference_words():
    jmesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    mesh = make_mesh({"data": 2}, devices=[0, 1])
    batch = {"image": np.zeros((3, 4, 4, 3), np.float32),
             "step": np.float32(1.0)}
    assert _error(shard_batch, batch, mesh) == \
        _error(jax_shard_batch, batch, jmesh)
    stacked = {"image": np.zeros((2, 3, 4, 4, 3), np.float32),
               "lr": np.zeros((2,), np.float32)}
    assert _error(shard_batch_stacked, stacked, mesh) == \
        _error(jax_shard_batch_stacked, stacked, jmesh)
    # a divisible batch moves to the device as tensors, 0-d leaves too
    ok = shard_batch({"image": np.ones((4, 2), np.float32)}, mesh, "cpu")
    assert isinstance(ok["image"], torch.Tensor)
    assert ok["image"].shape[0] == 4
    assert shard_batch_stacked({"x": np.ones((2, 4), np.float32)}, mesh,
                               "cpu")["x"].shape == (2, 4)


def test_shardings_are_the_reference_partition_specs():
    mesh = make_mesh()
    jmesh = jax_make_mesh({"data": 1}, devices=jax.devices()[:1])
    from deep_vision_tpu.parallel import batch_sharding as jb
    from deep_vision_tpu.parallel import replicated_sharding as jr

    assert batch_sharding(mesh, 4) == tuple(jb(jmesh, 4).spec)
    assert batch_sharding(mesh) == tuple(jb(jmesh).spec)
    assert replicated_sharding(mesh) == tuple(jr(jmesh).spec)


def _clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _child(code: str, **env) -> str:
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_clean_env(**env), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_initialize_is_a_no_op_for_one_unconfigured_process():
    out = _child(
        "from deep_vision_tpu_torch.parallel import distributed as d\n"
        "import torch.distributed as dist\n"
        "print(d.initialize(), dist.is_initialized(), d.process_count(),"
        " d.process_index(), d.backend())\n")
    assert out == "False False 1 0 None"


def test_initialize_reads_the_torchrun_variables():
    port = str(free_port())
    out = _child(
        "from deep_vision_tpu_torch.parallel import distributed as d\n"
        "from deep_vision_tpu_torch.parallel import make_mesh\n"
        "ok = d.initialize(device='cpu', timeout_s=30)\n"
        "m = make_mesh()\n"
        "print(ok, d.process_count(), d.process_index(), d.backend(),\n"
        "      m.shape, m.grouped)\n"
        "d.shutdown()\n",
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK="0",
        WORLD_SIZE="1", LOCAL_RANK="0")
    assert out == "True 1 0 gloo {'data': 1} True"


def test_explicit_arguments_win_over_the_environment():
    port = str(free_port())
    out = _child(
        "from deep_vision_tpu_torch.parallel import distributed as d\n"
        f"d.initialize('127.0.0.1:{port}', 1, 0, device='cpu',"
        " timeout_s=30)\n"
        "print(d.process_count(), d.process_index())\n"
        "d.shutdown()\n",
        MASTER_ADDR="127.0.0.2", MASTER_PORT="1", RANK="3",
        WORLD_SIZE="5")
    assert out == "1 0"


def test_a_local_rank_beyond_the_cards_raises_naming_both(monkeypatch):
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3.*has 2 CUDA"):
        distributed.initialize("127.0.0.1:1", 4, 3)
    assert not distributed.is_initialized()


def test_nccl_needs_a_card():
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize("127.0.0.1:1", 1, 0, backend="nccl",
                               device="cpu")


def test_scan_steps_under_gloo_on_the_card_is_refused():
    gloo = types.SimpleNamespace(grouped=True, backend="gloo")
    with pytest.raises(ValueError, match="'gloo' backend cannot"):
        check_scan_backend(gloo, torch.device("cuda", 0), 4)
    # NCCL captures its collectives; the CPU never captures; K = 1 runs
    # no graph
    check_scan_backend(types.SimpleNamespace(grouped=True, backend="nccl"),
                       torch.device("cuda", 0), 4)
    check_scan_backend(gloo, torch.device("cpu"), 4)
    check_scan_backend(gloo, torch.device("cuda", 0), 1)


def test_rank_zero_keeps_the_single_process_seeds():
    from deep_vision_tpu_torch.core.trainer import step_seed

    seeds = set()
    for stream in (None, 1, 2, 3):
        assert step_seed(7, 5, stream, rank=0) == step_seed(7, 5, stream)
        for rank in (0, 1, 2):
            seeds.add(step_seed(7, 5, stream, rank))
    # every (stream, rank) pair draws its own seed
    assert len(seeds) == 12


def test_a_dead_peer_fails_a_collective_instead_of_hanging(tmp_path):
    """Rank 1 leaves the group; rank 0's next all-reduce fails well
    inside its collective timeout and the process exits non-zero."""
    port = str(free_port())
    code = (
        "import sys, torch\n"
        "from deep_vision_tpu_torch.parallel import distributed as d\n"
        "from deep_vision_tpu_torch.parallel import make_mesh\n"
        "rank = int(sys.argv[1])\n"
        f"d.initialize('127.0.0.1:{port}', 2, rank, device='cpu',"
        " timeout_s=20)\n"
        "mesh = make_mesh()\n"
        "mesh.barrier()\n"
        "if rank == 1:\n"
        "    sys.exit(0)\n"
        "mesh.all_reduce_(torch.ones(4))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=REPO, env=_clean_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in (0, 1)]
    try:
        out0, _ = procs[0].communicate(timeout=90)
        procs[1].wait(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[1].returncode == 0
    assert procs[0].returncode != 0, out0[-2000:]
