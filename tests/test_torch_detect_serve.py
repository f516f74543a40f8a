"""The port's detect serving on the CPU, against the JAX reference:
bucket callables (uint8 wire → ingest → YOLOv3 or CenterNet → the
decode epilogue), device vs host decode, the engine's dict rows and
their D2H bytes, ``POST /v1/detect``, ``load_state`` of detection
weights, and int8 quantization of the two families.

The JAX side is the reference's ``CheckpointServingModel`` built from
its ``TrainConfig`` and a ``TrainState`` on the same seeded flax weights
(non-zero BatchNorm scales), with the Pallas ingest in interpret mode
for int8; the decode knobs are set on both sides.  The toy configs
compute in float32 (int8 weights dequantize to float32), so boxes and
scores agree within 1e-4·max|ref| at float32 and at int8 alike, and the
kept set (classes and valid flags) is equal."""

import concurrent.futures
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from _torch_port import images, seeded_variables
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState
from deep_vision_tpu.serve.registry import (
    CheckpointServingModel as JaxServingModel,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.restore import import_weights, load_state
from deep_vision_tpu_torch.models.common import Conv2d
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.http import ServeServer
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)
from deep_vision_tpu_torch.serve.workloads import WORKLOADS

pytestmark = pytest.mark.serve

DETECT = WORKLOADS["detect"]
BOUND = 1e-4
#: one image's device-decoded row: boxes (K, 4) f32, scores f32,
#: classes int32, valid f32
ROW_BYTES_PER_K = 16 + 4 + 4 + 4
#: the default K and a floor inside the seeded models' score range, so
#: that the valid flags carry information
KNOBS = {"detect_topk": 100, "detect_score_threshold": 0.5}


def _variables(name, seed=3):
    """Seeded flax weights of config ``name``.  CenterNet's heads get
    their last conv scaled by 1/10 and the heatmap the reference's
    −2.19 prior bias: with every kernel at He scale the seeded heatmap
    logits spread over ±50, where the sigmoid rounds most peaks to
    exactly 1.0 and the decode ranks ties alone."""
    cfg = jax_get_config(name)
    jm = cfg.model()
    size = cfg.image_size
    v = seeded_variables(jm, (size, size, 3), seed=seed)
    if cfg.task == "centernet":
        for key, head in v["params"].items():
            if key.startswith("DetectionHead_"):
                head["Conv_1"]["kernel"] = head["Conv_1"]["kernel"] * 0.1
                if int(key.rsplit("_", 1)[1]) % 3 == 0:  # the heatmap
                    head["Conv_1"]["bias"] = np.full_like(
                        head["Conv_1"]["bias"], -2.19)
    return cfg, jm, v


def _pair(name, infer_dtype, **knobs):
    """(JAX serving model, port serving model) on the same weights."""
    jcfg, jm, v = _variables(name)
    state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                              tx=build_optimizer(OptimizerConfig()),
                              batch_stats=v["batch_stats"])
    jsm = JaxServingModel(name, jcfg, jm, state, wire_dtype="uint8",
                          infer_dtype=infer_dtype)
    cfg = get_config(name)
    model = cfg.model()
    import_weights(model, v)
    psm = CheckpointServingModel(name, cfg, model, wire_dtype="uint8",
                                 infer_dtype=infer_dtype, device="cpu")
    for sm in (jsm, psm):
        for k, val in dict(KNOBS, **knobs).items():
            setattr(sm, k, val)
    return jsm, psm


CASES = {
    "yolo_f32": ("yolov3_toy", "float32", {}),
    "yolo_int8": ("yolov3_toy", "int8", {}),
    "yolo_int8_soft_cap": ("yolov3_toy", "int8",
                           {"detect_soft_nms": "gaussian",
                            "detect_soft_sigma": 0.4,
                            "detect_max_per_class": 4}),
    "centernet_f32": ("centernet_toy", "float32", {}),
    "centernet_int8": ("centernet_toy", "int8", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bucket_matches_reference(case):
    name, infer_dtype, knobs = CASES[case]
    jsm, psm = _pair(name, infer_dtype, **knobs)
    if infer_dtype == "int8":
        assert psm.quant.act_scale == jsm.quant.act_scale
    x = images(4, 64, seed=5)
    ref = jax.device_get(jsm.compile_bucket(4)(x))
    got = psm.compile_bucket(4)(x)
    assert set(got) == set(ref) == {"boxes", "scores", "classes", "valid"}
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
    np.testing.assert_array_equal(got["classes"].numpy(), ref["classes"])
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    for key in ("boxes", "scores"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=BOUND * np.abs(r).max())
    valid = got["valid"].numpy()
    assert 0 < valid.sum() < valid.size  # a kept set and a trimmed tail


@pytest.fixture(scope="module")
def served():
    """The port's serving models on seeded weights, device decode."""
    out = {}
    for name in ("yolov3_toy", "centernet_toy", "yolov3_toy416"):
        cfg = get_config(name)
        _, _, v = _variables(name)
        model = cfg.model()
        import_weights(model, v)
        sm = CheckpointServingModel(name, cfg, model, wire_dtype="uint8",
                                    infer_dtype="int8", device="cpu")
        for k, val in KNOBS.items():
            setattr(sm, k, val)
        out[name] = sm
    return out


def _host_view(sm):
    import copy

    view = copy.copy(sm)
    view.detect_decode = "host"
    return view


@pytest.mark.parametrize("name", ["yolov3_toy", "centernet_toy"])
def test_device_and_host_decode_answer_identically(served, name):
    sm = served[name]
    x = images(3, 64, seed=8)
    dev = sm.compile_bucket(4)(np.concatenate([x, x[:1]]))
    dense = _host_view(sm).compile_bucket(4)(np.concatenate([x, x[:1]]))
    assert isinstance(dev, dict) and not isinstance(dense, dict)
    for i in range(3):
        row_dev = {k: v[i].numpy() for k, v in dev.items()}
        row_host = map_rows(dense, i)
        for body in ({}, {"score_threshold": 0.0}, {"score_threshold": 0.2}):
            a = DETECT.respond(sm, body, row_dev)
            b = DETECT.respond(_host_view(sm), body, row_host)
            assert json.dumps(a) == json.dumps(b)
    low = DETECT.respond(sm, {"score_threshold": 0.0}, row_dev)
    assert low["num_detections"] > 0


def map_rows(tree, i):
    if isinstance(tree, (tuple, list)):
        return tuple(map_rows(t, i) for t in tree)
    return tree[i].numpy()


def test_respond_trims_and_floors(served):
    sm = served["yolov3_toy"]
    k = sm.detect_topk
    row = {"boxes": np.tile([0.1, 0.1, 0.4, 0.5], (k, 1)).astype(np.float32),
           "scores": np.linspace(0.9, 0.0, k, dtype=np.float32),
           "classes": np.zeros(k, np.int32),
           "valid": (np.arange(k) < 7).astype(np.float32)}
    out = DETECT.respond(sm, {"score_threshold": 0.5}, row)
    assert out["num_detections"] == 7 == len(out["detections"])
    edge = float(row["scores"][3])
    out = DETECT.respond(sm, {"score_threshold": edge}, row)
    assert out["num_detections"] == 4
    # a request threshold under the compiled floor clamps to it
    assert DETECT.respond(sm, {"score_threshold": 0.0}, row)[
        "num_detections"] == 7
    assert DETECT.respond(sm, {}, row)["num_detections"] == 7


@pytest.mark.parametrize("decode", ["device", "host"])
def test_engine_rows_and_d2h_bytes(served, decode):
    """yolov3_toy416 at bucket 1 and bucket 4 (3 requests, one padded
    image): device decode ships exactly K·28 bytes per padded image;
    host decode ships the dense pyramid, ≥100× more."""
    sm = served["yolov3_toy416"]
    model = sm if decode == "device" else _host_view(sm)
    k = sm.detect_topk
    x = images(3, 416, seed=2)
    eng = BatchingEngine(model, buckets=(1, 4), max_batch=4,
                         max_wait_ms=200.0, pipeline_depth=2).start()
    try:
        one = eng.infer(x[0], timeout=120)
        futs = [eng.submit(img) for img in x]
        rows = [f.result(120) for f in futs]
        st = eng.stats()
    finally:
        eng.stop()
    by_bucket = st["pipeline"]["d2h_bytes_by_bucket"]
    if decode == "device":
        assert isinstance(one, dict)
        assert one["boxes"].shape == (k, 4)
        assert one["classes"].dtype == np.int32
        assert by_bucket[1] == k * ROW_BYTES_PER_K
        per_image = k * ROW_BYTES_PER_K
    else:
        assert isinstance(one, tuple) and len(one) == 3
        assert one[0].shape == (52, 52, 3, 8)
        per_image = sum(a.nbytes for a in one)
        assert per_image >= 100 * k * ROW_BYTES_PER_K
        assert by_bucket[1] == per_image
    # every batch copies its whole bucket, padding included
    assert st["pipeline"]["d2h_bytes"] == sum(by_bucket.values()) == \
        per_image * (st["served"] + st["padded_images"])
    assert st["served"] == 4 and st["batches"] < 4
    # the same image answers alike at bucket 1 and in a batch of 4 (the
    # CPU's convolutions may round differently at another batch size)
    a = DETECT._decoded(model, one)
    b = DETECT._decoded(model, rows[0])
    np.testing.assert_array_equal(a["classes"], b["classes"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(a[key], b[key], rtol=0,
                                   atol=BOUND * np.abs(a[key]).max())


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_detect_and_mismatched_verbs(served, tmp_path):
    """One server with a detection model and a classifier:
    ``/v1/detect`` with ``score_threshold`` answers what a direct
    ``respond`` answers; each model's wrong verb answers 400 naming the
    right route; an unknown route 404 with the supported verbs."""
    from deep_vision_tpu_torch.cli import serve as cli

    sm = served["centernet_toy"]
    reg = ModelRegistry()
    reg.add(sm)
    # the classifier's bucket is never run: only its verb is checked
    clf = reg.load_checkpoint("resnet34", device="cpu")
    engines = {sm.name: BatchingEngine(sm, max_batch=4, max_wait_ms=20.0),
               clf.name: BatchingEngine(clf, max_batch=1)}
    srv = None
    try:
        for eng in engines.values():
            eng.start()
        srv = ServeServer(reg, engines).start_background()
        x = images(3, 64, seed=11)
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(lambda img: _post(
                srv.port, "/v1/detect",
                {"model": sm.name, "pixels": img.tolist(),
                 "score_threshold": 0.1}), x))
        # the engine may batch the three requests in any buckets, and the
        # CPU's convolutions round differently at another batch size:
        # the kept set must be equal, boxes and scores close
        direct = sm.compile_bucket(4)(np.concatenate([x, x[:1]]))
        for i, (status, body) in enumerate(replies):
            assert status == 200, body
            row = {k: v[i].numpy() for k, v in direct.items()}
            want = DETECT.respond(sm, {"score_threshold": 0.1}, row)
            assert body["model"] == sm.name
            assert body["num_detections"] == want["num_detections"] > 0
            got_d, want_d = body["detections"], want["detections"]
            assert [d["class"] for d in got_d] == \
                [d["class"] for d in want_d]
            np.testing.assert_allclose([d["score"] for d in got_d],
                                       [d["score"] for d in want_d],
                                       rtol=0, atol=1e-5)
            # boxes are rounded to 4 places: one rounding step apart
            np.testing.assert_allclose([d["box"] for d in got_d],
                                       [d["box"] for d in want_d],
                                       rtol=0, atol=1.5e-4)
        status, body = _post(srv.port, "/v1/classify",
                             {"model": sm.name, "pixels": x[0].tolist()})
        assert status == 400 and "/v1/detect" in body["error"]
        status, body = _post(srv.port, "/v1/detect",
                             {"model": clf.name, "pixels": []})
        assert status == 400 and "/v1/classify" in body["error"]
        status, body = _post(srv.port, "/v1/detect",
                             {"model": sm.name, "pixels": x[0].tolist(),
                              "score_threshold": "high"})
        assert status == 400
        status, body = _post(srv.port, "/v1/pose",
                             {"model": clf.name, "pixels": []})
        assert status == 400 and "/v1/classify" in body["error"]
        status, body = _post(srv.port, "/v1/generate",
                             {"model": sm.name, "pixels": []})
        assert status == 400 and "/v1/detect" in body["error"]
        status, body = _post(srv.port, "/v1/frobnicate", {"pixels": []})
        assert status == 404
        assert body["supported_verbs"] == ["classify", "detect", "generate",
                                           "pose"]
        status, models = _get(srv.port, "/v1/models")
        desc = models["models"][sm.name]["model"]
        assert desc["workload"] == "detect"
        assert desc["detect"]["top_k"] == KNOBS["detect_topk"]
        assert "detect" not in models["models"][clf.name]["model"]
        status, stats = _get(srv.port, "/v1/stats")
        assert "serve_ingest" in stats["kernels"]
        assert stats[sm.name]["served"] == 3
    finally:
        if srv is not None:
            srv.shutdown()
        for eng in engines.values():
            eng.stop()
    # the CLI's --detect-* flags reach the served model
    args = cli.build_parser().parse_args(
        ["-m", "centernet_toy", "--port", "0", "--device", "cpu",
         "--infer-dtype", "int8", "--detect-topk", "7",
         "--detect-decode", "host", "--detect-soft-nms", "linear",
         "--detect-max-per-class", "2"])
    engine, server = cli.build_server(args)
    server.start_background()
    try:
        d = engine.model.describe()["detect"]
        assert d == {"decode": "host", "top_k": 7, "score_threshold": 0.05,
                     "iou_threshold": 0.5, "soft_nms": "linear",
                     "soft_sigma": 0.5, "max_per_class": 2}
    finally:
        server.shutdown()
        engine.stop()


def test_serving_leaves_device_constants_usable_by_autograd(served):
    """The detect decode runs in inference mode and caches its device
    constants (``device_scalar``, e.g. each grid); a training step that
    divides by the same constant afterwards must still backpropagate."""
    from deep_vision_tpu_torch.ops.ingest import device_scalar
    from deep_vision_tpu_torch.tasks.detection import decode_boxes

    sm = served["yolov3_toy"]
    sm.compile_bucket(1)(images(1, 64, seed=1))  # grids 8, 4, 2
    raw = torch.zeros((1, 8, 8, 3, 8), requires_grad=True)
    box, _, _ = decode_boxes(raw, torch.ones((3, 2)))
    box.sum().backward()
    assert raw.grad is not None and torch.isfinite(raw.grad).all()
    assert not device_scalar(8.0, torch.device("cpu")).is_inference()


def test_load_checkpoint_validates_detect_knobs():
    reg = ModelRegistry()
    with pytest.raises(ValueError, match="detect_decode"):
        reg.load_checkpoint("centernet_toy", device="cpu",
                            detect_decode="edge")
    with pytest.raises(ValueError, match="detect_soft_nms"):
        reg.load_checkpoint("yolov3_toy", device="cpu",
                            detect_soft_nms="hard")


@pytest.mark.parametrize("name", ["yolov3_toy", "centernet_toy"])
def test_load_state_of_detection_weights(name, tmp_path):
    """``--weights`` of a detection model goes through its family's
    importer: the served model holds exactly the archive's weights."""
    _, _, v = _variables(name)
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, v)
    info = {}
    model = load_state(get_config(name), path, log=lambda _m: None,
                       info=info)
    assert info["weights"] == path and info["digest"]
    if name.startswith("yolo"):
        back = convert.yolo_to_flax(model.state_dict(), model.blocks)
    else:
        back = convert.centernet_to_flax(model.state_dict(), model.num_stack,
                                         model.order, model.filters)
    back = convert.flatten_tree(back)
    want = convert.flatten_tree(v)
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_load_state_names_an_unknown_family(tmp_path):
    from deep_vision_tpu_torch.core import config as port_config

    port_config.register_config("torch_port_unknown_family")(
        lambda: port_config.TrainConfig(
            name="torch_port_unknown_family",
            model=lambda: torch.nn.Linear(2, 2)))
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, {"params": {"Dense_0": {"kernel": np.zeros(
        (2, 2), np.float32)}}})
    with pytest.raises(TypeError, match="Linear"):
        load_state(get_config("torch_port_unknown_family"), path)


@pytest.mark.parametrize("name", ["yolov3_toy", "centernet_toy"])
def test_int8_quantizes_every_conv_per_channel(served, name):
    """Every conv of Darknet-53 and the YOLO heads, or of the hourglass
    and the CenterNet heads, holds int8 codes with one float32 scale an
    output channel; biases and BatchNorm stay float32."""
    sm = served[name]
    convs = [m for m in sm._model.modules() if isinstance(m, Conv2d)]
    assert convs
    for m in convs:
        assert m.weight.dtype == torch.int8
        assert m.weight_scale.shape == (m.weight.shape[0],)
        assert m.weight_scale.dtype == torch.float32
        if m.bias is not None:
            assert m.bias.dtype == torch.float32
    with_bias = sum(m.bias is not None for m in convs)
    if name == "centernet_toy":
        assert with_bias == len(convs)  # every flax nn.Conv has a bias
    else:
        assert with_bias == 3  # the three heads' 1×1 output convs
    assert sm.describe()["quant"]["ingest"] == "serve_ingest"


def test_profile_detect_bucket_on_cpu(served):
    """The profile splits a detect bucket into the forward and the
    epilogue; device fields stay null on the CPU."""
    from deep_vision_tpu_torch.obs.profile import kernel_group, profile_bucket

    rep = profile_bucket(served["centernet_toy"], 2, iters=2)
    assert rep["wall_ms_per_forward"] > 0
    assert rep["device_ms_by_group"] is None
    assert rep["epilogue"]["wall_ms_per_call"] > 0
    assert rep["forward_only"]["wall_ms_per_forward"] > 0
    assert kernel_group("void at::native::sort_kernel", "epilogue") == \
        "epilogue"
    assert kernel_group("void serve_ingest_kernel<true>") == "serve_ingest"
