"""The port's tfevents writer (``core/tboard.py``) and ``MetricLogger``
against the reference's: crc32c, every event record byte for byte under
one patched clock, the logger's event files on and off, and a
``cli.train`` run leaving ``workdir/tensorboard/events.*``."""

import glob
import os
import struct

import pytest

from deep_vision_tpu.core import metrics as ref_metrics
from deep_vision_tpu.core import tboard as ref
from deep_vision_tpu_torch.core import metrics as port_metrics
from deep_vision_tpu_torch.core import tboard as port


def test_crc32c_known_vectors():
    # RFC 3720 test vectors
    for mod in (ref, port):
        assert mod._crc32c(b"") == 0x0
        assert mod._crc32c(b"123456789") == 0xE3069283
        assert mod._crc32c(bytes(32)) == 0x8A9136AA
        assert mod._crc32c(bytes(range(32))) == 0x46DD794E
    for data in (b"", b"abc", bytes(range(256)) * 3):
        assert port._masked_crc(data) == ref._masked_crc(data)


@pytest.mark.parametrize("kwargs", [
    dict(file_version="brain.Event:2"),
    dict(step=0, scalars=[("loss", 1.5)]),
    dict(step=7, scalars=[("val_top1", 0.9), ("val_top5", 0.99)]),
    dict(step=2**40, scalars=[("x", -3.25e-7), ("y", float("inf"))]),
    dict(step=-1, scalars=[("neg", float("nan"))]),
])
def test_event_bytes_equal_reference(kwargs):
    assert port._event(1234.5, **kwargs) == ref._event(1234.5, **kwargs)


def _records(path):
    """(header, payload) of every TFRecord in ``path``, crcs checked."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        payload = data[pos + 12:pos + 12 + n]
        (pcrc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        assert hcrc == port._masked_crc(header)
        assert pcrc == port._masked_crc(payload)
        out.append(payload)
        pos += 16 + n
    return out


def _write_both(tmp_path, monkeypatch, make, drive):
    """Run ``drive`` on the reference's and the port's writer under one
    frozen clock and hostname; returns both files' bytes."""
    monkeypatch.setattr("time.time", lambda: 1700000000.25)
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    got = {}
    for name, mod in (("ref", ref), ("port", port)):
        d = tmp_path / name
        drive(make(mod, str(d)))
        (path,) = glob.glob(str(d / "**" / "events.out.tfevents.*"),
                            recursive=True)
        assert os.path.basename(path) == \
            "events.out.tfevents.1700000000.host"
        got[name] = open(path, "rb").read()
    return got


def test_file_framing_equals_reference(tmp_path, monkeypatch):
    def drive(w):
        w.scalar("train_loss", 1.5, step=1)
        w.scalar("train_loss", 0.75, step=2)
        w.scalars({"val_top1": 0.9, "val_top5": 0.99}, step=2)
        w.close()

    got = _write_both(tmp_path, monkeypatch,
                      lambda mod, d: mod.TFEventWriter(d), drive)
    assert got["port"] == got["ref"]
    assert len(_records(tmp_path / "port" /
                        "events.out.tfevents.1700000000.host")) == 4


def test_metric_logger_events_equal_reference(tmp_path, monkeypatch):
    """Both loggers write the same event file for the same logs (the
    reference's resolves its paths through ``jax.process_index``, 0
    here)."""
    def drive(logger):
        logger.log("loss", 10, 3.25)
        logger.log_dict(20, {"top1": 0.5, "top5": 0.75})
        logger.log_input_block(20, {"batches": 2, "input_stall_frac": 0.1,
                                    "h2d_bytes_per_step": 64.0,
                                    "producer_ms": {"h2d": 2.0}})
        logger._tb.close()

    got = _write_both(
        tmp_path, monkeypatch,
        lambda mod, d: (ref_metrics if mod is ref else port_metrics)
        .MetricLogger(d), drive)
    assert got["port"] == got["ref"]


def test_metric_logger_tensorboard_on_by_default_and_off(tmp_path):
    logger = port_metrics.MetricLogger(str(tmp_path / "on"))
    assert not os.path.exists(tmp_path / "on" / "tensorboard")  # lazy
    logger.log("loss", 1, 1.0)
    assert glob.glob(str(tmp_path / "on" / "tensorboard" / "events.*"))
    assert (tmp_path / "on" / "metrics.jsonl").exists()
    off = port_metrics.MetricLogger(str(tmp_path / "off"),
                                    tensorboard=False)
    off.log("loss", 1, 1.0)
    off.log_dict(2, {"a": 1.0})
    assert not glob.glob(str(tmp_path / "off" / "tensorboard" / "*"))
    assert (tmp_path / "off" / "metrics.jsonl").exists()


def test_cli_train_writes_event_files(tmp_path):
    from deep_vision_tpu_torch.cli import train as cli

    work = tmp_path / "w"
    assert cli.main(["-m", "lenet5", "--synthetic", "--synthetic-size", "64",
                     "--batch-size", "32", "--epochs", "1", "--workdir",
                     str(work), "--device", "cpu"]) == 0
    (path,) = glob.glob(str(work / "tensorboard" / "events.*"))
    payloads = _records(path)
    assert len(payloads) > 2
    assert b"val_top1" in b"".join(payloads)
    assert b"train_loss" in b"".join(payloads)
