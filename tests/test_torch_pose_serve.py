"""The port's pose serving on the CPU, against the JAX reference: the
``hourglass_toy`` bucket callable (uint8 wire → ingest → Stacked
Hourglass → the heatmap decode epilogue) against the reference's
``CheckpointServingModel`` at float32 and int8, the engine's keypoint
rows and their D2H bytes, ``POST /v1/pose`` with the verb routing both
ways, ``load_state`` of pose weights, and the profile's epilogue group.

Tolerances: scores within 1e-4 of the largest (float32 convolutions in
other orders; int8 weights dequantize to float32 on both sides);
keypoints exact on every channel whose decode the bound cannot move
(the peak beats the runner-up cell, and each refining neighbour pair
differs, by more than the bound), most channels."""

import concurrent.futures
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import images, seeded_variables
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState
from deep_vision_tpu.models.hourglass import StackedHourglass as JaxHourglass
from deep_vision_tpu.serve.registry import (
    CheckpointServingModel as JaxServingModel,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core import config as port_config
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.restore import import_weights, load_state
from deep_vision_tpu_torch.models.common import Conv2d
from deep_vision_tpu_torch.models.hourglass import StackedHourglass
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.http import ServeServer
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)
from deep_vision_tpu_torch.serve.workloads import WORKLOADS

pytestmark = pytest.mark.serve

POSE = WORKLOADS["pose"]
BOUND = 1e-4
#: one image's device-decoded row per keypoint: (x, y) and a score,
#: float32
ROW_BYTES_PER_KEYPOINT = 2 * 4 + 4
#: a 16-keypoint model at the toy's width, for the MPII row size
TOY16 = "torch_port_hourglass16"
TOY16_KW = dict(num_stack=2, num_heatmap=16, filters=16, order=2)
port_config.register_config(TOY16)(lambda: port_config.TrainConfig(
    name=TOY16, task="pose", image_size=64, num_classes=16,
    model=lambda: StackedHourglass(**TOY16_KW)))


def _variables(model, seed=3):
    """Seeded flax weights of a StackedHourglass (non-zero BatchNorm
    scales), its heatmap convs scaled by 1e-3 so that the heatmaps
    start near a trained model's scale rather than at 1e5."""
    v = seeded_variables(model, (64, 64, 3), seed=seed)
    for s in range(model.num_stack):
        conv = v["params"][f"Conv_{2 + 4 * s}"]
        conv["kernel"] = conv["kernel"] * 1e-3
    return v


def _pair(infer_dtype):
    """(JAX serving model, port serving model) of hourglass_toy on the
    same weights."""
    jcfg = jax_get_config("hourglass_toy")
    jm = jcfg.model()
    v = _variables(jm)
    state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                              tx=build_optimizer(OptimizerConfig()),
                              batch_stats=v["batch_stats"])
    jsm = JaxServingModel("hourglass_toy", jcfg, jm, state,
                          wire_dtype="uint8", infer_dtype=infer_dtype)
    cfg = get_config("hourglass_toy")
    model = cfg.model()
    import_weights(model, v)
    psm = CheckpointServingModel("hourglass_toy", cfg, model,
                                 wire_dtype="uint8", infer_dtype=infer_dtype,
                                 device="cpu")
    return jsm, psm


def _decisive(heat: np.ndarray, bound: float) -> np.ndarray:
    """(B, K) mask of the channels of (B, H, W, K) heatmaps whose
    refined peak no change within ``bound`` can move."""
    b, h, w, k = heat.shape
    flat = heat.reshape(b, h * w, k)
    top2 = np.sort(flat, axis=1)[:, -2:, :]
    ok = top2[:, 1] - top2[:, 0] > bound
    idx = flat.argmax(1)
    yi, xi = idx // w, idx % w
    for dy, dx in ((0, 1), (1, 0)):
        a = np.take_along_axis(flat, (np.clip(yi + dy, 0, h - 1) * w
                                      + np.clip(xi + dx, 0, w - 1))[:, None],
                               1)[:, 0]
        c = np.take_along_axis(flat, (np.clip(yi - dy, 0, h - 1) * w
                                      + np.clip(xi - dx, 0, w - 1))[:, None],
                               1)[:, 0]
        ok &= np.abs(a - c) > bound
    return ok


@pytest.mark.parametrize("infer_dtype", ["float32", "int8"])
def test_bucket_matches_reference(infer_dtype):
    jsm, psm = _pair(infer_dtype)
    if infer_dtype == "int8":
        assert psm.quant.act_scale == jsm.quant.act_scale
        convs = [m for m in psm._model.modules() if isinstance(m, Conv2d)]
        assert convs and all(m.weight.dtype == torch.int8 and
                             m.weight_scale.shape == (m.weight.shape[0],)
                             for m in convs)
    x = images(4, 64, seed=5)
    ref = jax.device_get(jsm.compile_bucket(4)(x))
    got = psm.compile_bucket(4)(x)
    assert set(got) == set(ref) == {"keypoints", "scores"}
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
    r_scores = np.asarray(ref["scores"])
    bound = BOUND * np.abs(r_scores).max()
    np.testing.assert_allclose(got["scores"].numpy(), r_scores, rtol=0,
                               atol=bound)
    heat = psm.compile_bucket(4, epilogue=False)(x)[-1].numpy()
    sure = _decisive(heat, 2 * bound)
    assert sure.mean() > 0.75, sure.mean()
    np.testing.assert_array_equal(got["keypoints"].numpy()[sure],
                                  np.asarray(ref["keypoints"])[sure])


@pytest.fixture(scope="module")
def toy16():
    """The 16-keypoint toy served int8 on seeded weights."""
    cfg = get_config(TOY16)
    model = cfg.model()
    import_weights(model, _variables(
        JaxHourglass(dtype=jnp.float32, **TOY16_KW), seed=4))
    return CheckpointServingModel(TOY16, cfg, model, wire_dtype="uint8",
                                  infer_dtype="int8", device="cpu")


def test_engine_rows_and_d2h_bytes(toy16):
    """Bucket 1 and bucket 4 (3 requests, one padded image): a row is
    16 keypoints and their scores, 192 bytes an image on the wire back,
    padding included."""
    sm = toy16
    x = images(3, 64, seed=2)
    eng = BatchingEngine(sm, buckets=(1, 4), max_batch=4, max_wait_ms=200.0,
                         pipeline_depth=2).start()
    try:
        one = eng.infer(x[0], timeout=120)
        futs = [eng.submit(img) for img in x]
        rows = [f.result(120) for f in futs]
        st = eng.stats()
    finally:
        eng.stop()
    per_image = 16 * ROW_BYTES_PER_KEYPOINT
    assert per_image == 192
    assert set(one) == {"keypoints", "scores"}
    assert one["keypoints"].shape == (16, 2) and one["scores"].shape == (16,)
    assert one["keypoints"].dtype == one["scores"].dtype == np.float32
    by_bucket = st["pipeline"]["d2h_bytes_by_bucket"]
    assert by_bucket[1] == per_image
    assert st["pipeline"]["d2h_bytes"] == sum(by_bucket.values()) == \
        per_image * (st["served"] + st["padded_images"])
    assert st["served"] == 4 and st["batches"] < 4
    # the same image at bucket 1 and in a batch of 4 (the CPU's
    # convolutions may round differently at another batch size)
    np.testing.assert_allclose(rows[0]["scores"], one["scores"], rtol=0,
                               atol=BOUND * np.abs(one["scores"]).max())


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


def test_http_pose_and_mismatched_verbs(toy16):
    """One server with the pose model (bucket 1: every answer is the
    direct bucket-1 call's), a classifier and a detector: ``/v1/pose``
    answers the keypoints in heatmap pixels; a request to a model on
    another model's verb answers 400 naming the right route, every way;
    an unknown verb 404 with the three verbs."""
    sm = toy16
    reg = ModelRegistry()
    reg.add(sm)
    # the other two models' buckets are never run: only verbs are checked
    clf = reg.load_checkpoint("resnet34", device="cpu")
    det = reg.load_checkpoint("centernet_toy", device="cpu")
    engines = {sm.name: BatchingEngine(sm, buckets=(1,), max_batch=1),
               clf.name: BatchingEngine(clf, max_batch=1),
               det.name: BatchingEngine(det, max_batch=1)}
    srv = None
    try:
        for eng in engines.values():
            eng.start()
        srv = ServeServer(reg, engines).start_background()
        x = images(3, 64, seed=11)
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(lambda img: _post(
                srv.port, "/v1/pose",
                {"model": sm.name, "pixels": img.tolist()}), x))
        fn = sm.compile_bucket(1)
        for img, (status, body) in zip(x, replies):
            assert status == 200, body
            row = {k: v[0].numpy() for k, v in fn(img[None]).items()}
            assert body == json.loads(json.dumps(POSE.respond(sm, {}, row)))
            assert body["model"] == sm.name and body["space"] == "heatmap"
            assert len(body["keypoints"]) == 16
            assert set(body["keypoints"][0]) == {"x", "y", "score"}
        for verb, model, right in (("classify", sm, "pose"),
                                   ("detect", sm, "pose"),
                                   ("pose", clf, "classify"),
                                   ("pose", det, "detect")):
            status, body = _post(srv.port, f"/v1/{verb}",
                                 {"model": model.name,
                                  "pixels": x[0].tolist()})
            assert status == 400 and f"/v1/{right}" in body["error"], \
                (verb, model.name, body)
        status, body = _post(srv.port, "/v1/generate",
                             {"model": sm.name, "pixels": []})
        assert status == 400 and "/v1/pose" in body["error"]
        status, body = _post(srv.port, "/v1/frobnicate", {"pixels": []})
        assert status == 404
        assert body["supported_verbs"] == ["classify", "detect", "generate",
                                           "pose"]
        _, models = _get(srv.port, "/v1/models")
        desc = models["models"][sm.name]["model"]
        assert desc["workload"] == "pose" and "detect" not in desc
        assert desc["quant"]["ingest"] == "serve_ingest"
        _, stats = _get(srv.port, "/v1/stats")
        assert "serve_ingest" in stats["kernels"]
        assert stats[sm.name]["served"] == 3
    finally:
        if srv is not None:
            srv.shutdown()
        for eng in engines.values():
            eng.stop()


def test_cli_serves_pose_on_cpu():
    from deep_vision_tpu_torch.cli import serve as cli

    args = cli.build_parser().parse_args(
        ["-m", "hourglass_toy", "--port", "0", "--device", "cpu",
         "--infer-dtype", "int8", "--max-batch", "2"])
    engine, server = cli.build_server(args)
    server.start_background()
    try:
        x = images(1, 64, seed=3)[0]
        status, body = _post(server.port, "/v1/pose",
                             {"pixels": x.tolist()})
        assert status == 200 and len(body["keypoints"]) == 8
        assert engine.model.describe()["workload"] == "pose"
    finally:
        server.shutdown()
        engine.stop()


def test_load_state_of_pose_weights(tmp_path):
    """``--weights`` of a pose model goes through the StackedHourglass
    importer: the served model holds exactly the archive's weights."""
    cfg = get_config("hourglass_toy")
    v = _variables(jax_get_config("hourglass_toy").model())
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, v)
    info = {}
    model = load_state(cfg, path, log=lambda _m: None, info=info)
    assert isinstance(model, StackedHourglass)
    assert info["weights"] == path and info["digest"]
    back = convert.flatten_tree(convert.stacked_hourglass_to_flax(
        model.state_dict(), model.num_stack, model.num_heatmap,
        model.filters, model.num_residual, model.order))
    want = convert.flatten_tree(v)
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_profile_pose_bucket_on_cpu(toy16):
    """The profile splits a pose bucket into the forward and the
    epilogue; device fields stay null on the CPU."""
    from deep_vision_tpu_torch.obs.profile import profile_bucket

    rep = profile_bucket(toy16, 2, iters=2)
    assert rep["wall_ms_per_forward"] > 0
    assert rep["device_ms_by_group"] is None
    assert rep["epilogue"]["wall_ms_per_call"] > 0
    assert rep["forward_only"]["wall_ms_per_forward"] > 0
