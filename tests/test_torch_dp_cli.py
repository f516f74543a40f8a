"""``cli.train --mesh`` on the CPU: two gloo ranks launched by ``python
-m torch.distributed.run --standalone --nproc-per-node 2`` train
``resnet34`` (32², a rank's batch 4 = ``cfg.batch_size``, the global 8)
on tiny raw records for an epoch, then resume a second one; and the
refusals outside a launched group."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deep_vision_tpu_torch.cli import train as cli
from deep_vision_tpu_torch.data.records import RecordWriter, shard_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(root, n_train=16, n_val=8, side=36):
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_val)):
        with RecordWriter(shard_name(str(root), split, 0, 1)) as w:
            for i in range(n):
                img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
                w.write({"label": int(i % 10), "enc": "raw",
                         "shape": [side, side, 3]}, img.tobytes())


def _torchrun(args: list, cwd, logs) -> list:
    """Each rank's stdout of a two-rank launch (torchrun writes them to
    files of their own: one pipe would interleave the ranks' lines)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--redirects", "3", "--log-dir",
         str(logs), "-m", "deep_vision_tpu_torch.cli.train", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)
    outs = []
    for rank in (0, 1):
        (path,) = glob.glob(os.path.join(str(logs), "**", str(rank),
                                         "stdout.log"), recursive=True)
        with open(path) as f:
            outs.append(f.read())
    assert r.returncode == 0, (outs, r.stderr[-3000:])
    return outs


def test_two_ranks_train_and_resume_through_torchrun(tmp_path):
    data, work = tmp_path / "data", tmp_path / "work"
    _records(data)
    argv = ["-m", "resnet34", "--mesh", "data=2", "--device", "cpu",
            "--data-format", "records", "--data-root", str(data),
            "--workdir", str(work), "--num-workers", "0",
            "--batch-size", "4", "--image-size", "32"]
    outs = _torchrun(argv + ["--epochs", "1"], tmp_path, tmp_path / "l1")
    for rank, out in enumerate(outs):
        assert (f"device: cpu mesh={{'data': 2}} rank={rank} "
                f"backend=gloo") in out
    # eval sums are all-reduced: both ranks print the same metrics
    finals = [_final(out) for out in outs]
    assert finals[0] == finals[1], finals
    # 16 records over 2 ranks at a rank's batch 4: 2 steps an epoch
    assert sorted(os.listdir(work / "checkpoints")) == ["2"]
    outs = _torchrun(argv + ["--epochs", "2", "--resume"], tmp_path,
                     tmp_path / "l2")
    for out in outs:
        assert "[resume] restored step=2 start_epoch=2" in out
    assert sorted(os.listdir(work / "checkpoints")) == ["2", "4"]
    lines = [json.loads(s) for s in
             (work / "metrics.jsonl").read_text().splitlines()]
    keys = [(d["name"], d["step"]) for d in lines]
    assert len(keys) == len(set(keys))
    assert [d["step"] for d in lines if d["name"] == "val_loss"] == [2, 4]
    finals = [_final(out) for out in outs]
    assert finals[0] == finals[1], finals


def _final(out: str) -> str:
    (line,) = [s for s in out.splitlines() if s.startswith("final:")]
    return line


@pytest.mark.parametrize("spec,ranks", [("data=2", 2),
                                        ("data=2,model=2", 4)])
def test_a_mesh_outside_a_launched_group_names_torchrun(tmp_path, spec,
                                                        ranks):
    with pytest.raises(SystemExit) as e:
        cli.main(["-m", "resnet34", "--mesh", spec, "--device", "cpu",
                  "--synthetic", "--workdir", str(tmp_path)])
    msg = str(e.value)
    assert "torch.distributed.run" in msg
    assert f"--nproc-per-node {ranks}" in msg


def test_microbatches_wait_for_the_pipeline_slice(tmp_path):
    with pytest.raises(SystemExit, match="pipeline"):
        cli.main(["-m", "resnet34", "--microbatches", "4", "--device", "cpu",
                  "--synthetic", "--workdir", str(tmp_path)])


def test_mesh_flags_match_the_reference_parser():
    from deep_vision_tpu.cli.train import build_parser as jax_parser

    def actions(p):
        return {a.dest: (a.option_strings, a.default, a.type, a.help)
                for a in p._actions if a.dest in ("mesh", "microbatches")}

    want, got = actions(jax_parser()), actions(cli.build_parser())
    assert set(got) == {"mesh", "microbatches"}
    for dest in got:
        assert got[dest][:3] == want[dest][:3], dest
    assert got["microbatches"][3] == want["microbatches"][3]
    # the reference's help, plus the port's launch and scope note
    assert got["mesh"][3].startswith(want["mesh"][3].split(" — ")[0]
                                     .split(" (image rows")[0])
