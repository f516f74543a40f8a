"""The ``torch.export`` archive (``core/export.py``) and its server
(``cli.serve --stablehlo``): the exported forward equals the eager one,
BatchNorm models included; the workdir's weights, not the archive's,
serve; answers over HTTP equal direct calls; the reference's refusals
(non-float32 wire or compute before any file is read, an unavailable
batch, ``--models`` with ``--stablehlo``)."""

import numpy as np
import pytest
import torch

import _torch_serve as ts
from deep_vision_tpu_torch.cli import infer
from deep_vision_tpu_torch.cli import serve as cli
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.export import export_forward, load_exported
from deep_vision_tpu_torch.models.resnet import BottleneckBlock, ResNet
from deep_vision_tpu_torch.serve.registry import ModelRegistry


def _resnet(seed):
    model = ResNet((1, 1), BottleneckBlock, 5, torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    # non-trivial running statistics, so eval BatchNorm is exercised
    g = torch.Generator().manual_seed(seed + 100)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model.eval()


@pytest.mark.parametrize("name", ["lenet5", "resnet_bn"])
def test_round_trip_equals_eager(tmp_path, name):
    if name == "lenet5":
        model, other = ts.lenet_model(0).eval(), ts.lenet_model(1).eval()
        shape = (3, 32, 32, 1)
    else:
        model, other = _resnet(0), _resnet(1)
        shape = (3, 32, 32, 3)
    path = str(tmp_path / "m.pt2")
    n = export_forward(model, None, shape, path)
    assert n > 0
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape)
                         .astype(np.float32))
    call = load_exported(path)
    assert call.fixed_batch == 3 and call.input_shape == shape
    assert sorted(call.param_names) == sorted(model.state_dict())
    with torch.no_grad():
        assert torch.equal(call(x), model(x))
        # the weights of another checkpoint, loaded at load time, serve
        # instead of the archive's own copy
        swapped = load_exported(path, weights=other.state_dict())
        want = other(x)
        assert torch.equal(swapped(x), want)
        assert not torch.equal(want, model(x))
    with pytest.raises(RuntimeError):
        load_exported(path, weights={"nope": torch.zeros(1)})


def _workdir(tmp_path):
    wd = str(tmp_path / "wd")
    model = ts.lenet_model(3)
    ts.write_step(wd, 2, model)
    return wd, model.eval()


def _serve_answers(argv, xs):
    engine, server = cli.build_server(cli.build_parser().parse_args(
        ["-m", "lenet5", "--port", "0", "--device", "cpu", *argv]))
    server.start_background()
    try:
        answers = []
        for x in xs:
            code, body, _ = ts.post(server.port, "/v1/classify",
                                    {"pixels": x.tolist(), "top_k": 5})
            assert code == 200, body
            answers.append(body["top"])
        return engine, answers
    finally:
        server.shutdown()
        engine.stop()


def test_cli_infer_export_then_serve_over_http(tmp_path, capsys):
    """``cli.infer export`` then ``cli.serve --stablehlo``: every answer
    equals the checkpoint server's on the float32 wire (the eager model
    through the same engine) bit for bit, and the direct eager call at
    batch 1 in classes, its logits within 1e-6 relative (the engine's
    thread rounds a CPU convolution its own way, whichever model
    runs)."""
    wd, model = _workdir(tmp_path)
    archive = str(tmp_path / "model.pt2")
    assert infer.main(["export", "-m", "lenet5", "--workdir", wd, "--out",
                       archive, "--device", "cpu"]) == 0
    assert "bytes of torch.export archive" in capsys.readouterr().out
    xs = ts.images(4, seed=5)
    engine, got = _serve_answers(["--stablehlo", archive, "--workdir", wd,
                                  "--warmup"], xs)
    sm = engine.model
    assert engine.buckets == [1] and sm.fixed_batch == 1
    assert str(sm.wire_dtype) == "float32" and sm.restored_step == 2
    _, eager = _serve_answers(["--workdir", wd, "--wire-dtype", "float32",
                               "--max-batch", "1"], xs)
    assert got == eager
    for x, top in zip(xs, got):
        with torch.no_grad():
            want = model(torch.from_numpy(x[None]))[0].numpy()
        classes = np.argsort(want)[-5:][::-1]
        assert [t["class"] for t in top] == classes.tolist()
        np.testing.assert_allclose([t["logit"] for t in top],
                                   want[classes],
                                   rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("infer_dtype", ["bfloat16", "int8"])
def test_non_float32_compute_refused_before_any_file(tmp_path, infer_dtype):
    missing = str(tmp_path / "does-not-exist.pt2")
    with pytest.raises(ValueError, match="f32-wire/f32-compute only"):
        cli.build_server(cli.build_parser().parse_args(
            ["-m", "lenet5", "--stablehlo", missing, "--workdir",
             str(tmp_path / "nowhere"), "--infer-dtype", infer_dtype,
             "--port", "0", "--device", "cpu"]))
    with pytest.raises(ValueError, match="f32-wire/f32-compute only"):
        ModelRegistry().load_exported("lenet5", missing,
                                      workdir=str(tmp_path / "nowhere"),
                                      infer_dtype=infer_dtype, device="cpu")


def test_uint8_wire_refused_before_any_file(tmp_path):
    with pytest.raises(ValueError, match="f32-wire/f32-compute only"):
        ModelRegistry().load_exported("lenet5", str(tmp_path / "no.pt2"),
                                      workdir=str(tmp_path / "nowhere"),
                                      wire_dtype="uint8", device="cpu")


def test_unavailable_batch_names_the_exported_sizes(tmp_path):
    from deep_vision_tpu_torch.serve.engine import BatchingEngine

    wd, _ = _workdir(tmp_path)
    archive = str(tmp_path / "m.pt2")
    export_forward(ts.lenet_model(0).eval(), None, (2, 32, 32, 1), archive)
    sm = ModelRegistry().load_exported("lenet5", archive, workdir=wd,
                                       device="cpu")
    assert sm.bucket_sizes == [2]
    with pytest.raises(ValueError, match=r"bucket sizes \[2\]; batch 4 "
                                         r"unavailable"):
        sm.compile_bucket(4)
    run = sm.compile_bucket(2)
    with pytest.raises(ValueError, match="batch 3 unavailable"):
        run(np.zeros((3, 32, 32, 1), np.float32))
    assert run(np.zeros((2, 32, 32, 1), np.float32)).shape == (2, 10)
    with pytest.raises(ValueError, match=r"requested buckets \[1, 2\] "
                                         r"unavailable"):
        BatchingEngine(sm, buckets=[1, 2])
    assert BatchingEngine(sm).buckets == [2]


def test_models_with_stablehlo_refused(tmp_path):
    with pytest.raises(ValueError, match="multi-model serving"):
        cli.build_server(cli.build_parser().parse_args(
            ["--models", "lenet5", "--stablehlo", "x.pt2", "--workdir",
             str(tmp_path), "--port", "0", "--device", "cpu"]))


def test_the_archive_serves_the_workdir_weights(tmp_path):
    """An archive exported from one checkpoint serves another workdir's
    weights, which the registry restores and loads by name."""
    wd, model = _workdir(tmp_path)
    archive = str(tmp_path / "m.pt2")
    export_forward(ts.lenet_model(0).eval(), None, (1, 32, 32, 1), archive)
    sm = ModelRegistry().load_exported("lenet5", archive, workdir=wd,
                                       device="cpu")
    x = ts.images(1, seed=9)
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    assert torch.equal(sm.compile_bucket(1)(x), want)
    assert get_config("lenet5").task == sm.task
