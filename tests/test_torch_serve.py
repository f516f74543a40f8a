"""The port's serving slice end to end on the CPU, against the JAX
reference: int8 bucket callables (uint8 wire → ``serve_ingest`` →
dequantized int8 weights → logits) and the HTTP server.

The JAX side is the reference's own ``CheckpointServingModel`` with its
Pallas ingest in interpret mode, built here from a ``TrainConfig`` and a
``TrainState`` on the same seeded weights.  Tolerances, as for the model
alone: float32 compute within 1e-4·max|ref|, bfloat16 within
3e-2·max|ref| with top-1 equal on most rows."""

import concurrent.futures
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import (
    images,
    jax_model,
    load_port,
    port_model,
    seeded_variables,
)
from deep_vision_tpu.core.config import TrainConfig as JaxTrainConfig
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState
from deep_vision_tpu.serve.registry import (
    CheckpointServingModel as JaxServingModel,
)
from deep_vision_tpu_torch.core.config import TrainConfig
from deep_vision_tpu_torch.ops.ingest import serve_ingest
from deep_vision_tpu_torch.serve.admission import AdmissionController
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.http import ServeServer
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)

pytestmark = pytest.mark.serve

BOUND = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(model_dtype, infer_dtype="int8", seed=2):
    """(JAX serving model, port serving model) on the same weights."""
    dt = DTYPES[model_dtype]
    jm = jax_model((1, 1), "BottleneckBlock", 10, dt)
    variables = seeded_variables(jm, (32, 32, 3), seed=seed)
    jcfg = JaxTrainConfig(name="torch_port_tiny", model=lambda: jm,
                          image_size=32, channels=3, num_classes=10)
    state = TrainState.create(apply_fn=jm.apply, params=variables["params"],
                              tx=build_optimizer(OptimizerConfig()),
                              batch_stats=variables["batch_stats"])
    jsm = JaxServingModel("tiny", jcfg, jm, state, wire_dtype="uint8",
                          infer_dtype=infer_dtype)
    cfg = TrainConfig(name="torch_port_tiny",
                      model=lambda: port_model((1, 1), dtype=dt),
                      image_size=32, channels=3, num_classes=10)
    psm = CheckpointServingModel(
        "tiny", cfg, load_port(cfg.model(), variables), wire_dtype="uint8",
        infer_dtype=infer_dtype, device="cpu")
    return jsm, psm


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


@pytest.mark.parametrize("model_dtype,infer_dtype", [
    ("float32", "int8"), ("bfloat16", "int8"), ("float32", "float32")])
def test_bucket_matches_reference(model_dtype, infer_dtype):
    jsm, psm = _pair(model_dtype, infer_dtype)
    if infer_dtype == "int8":
        assert psm.quant.act_scale == jsm.quant.act_scale
    x = images(8, 32, seed=5)
    ref = np.asarray(jsm.compile_bucket(8)(x))
    got = psm.compile_bucket(8)(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 10)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=BOUND[model_dtype] * np.abs(ref).max())
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    assert agree >= (8 if model_dtype == "float32" else 6), \
        f"top-1 agrees on {agree}/8"


def test_int8_weights_resident(f32_pair):
    _, psm = f32_pair
    d = psm.describe()
    assert d["quant"]["ingest"] == "serve_ingest"
    assert psm._model.fc.weight.dtype == torch.int8
    assert psm.param_bytes() == d["quant"]["param_bytes"]


def test_bucket_rejects_wrong_shape(f32_pair):
    _, psm = f32_pair
    with pytest.raises(ValueError):
        psm.compile_bucket(2)(images(3, 32))


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def server(f32_pair):
    def boot(max_queue=256):
        _, psm = f32_pair
        reg = ModelRegistry()
        reg.add(psm)
        eng = BatchingEngine(psm, max_batch=4, max_wait_ms=20.0,
                             admission=AdmissionController(
                                 max_queue=max_queue, max_wait_ms=20.0))
        eng.start()
        srv = ServeServer(reg, {psm.name: eng}).start_background()
        booted.append((srv, eng))
        return srv, eng

    booted = []
    yield boot
    for srv, eng in booted:
        srv.shutdown()
        eng.stop()


def test_http_classify_matches_reference(f32_pair, server):
    jsm, _ = f32_pair
    srv, eng = server()
    x = images(4, 32, seed=9)
    ref = np.asarray(jsm.compile_bucket(4)(x))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        replies = list(pool.map(
            lambda img: _post(srv.port, "/v1/classify",
                              {"pixels": img.tolist(), "top_k": 3}), x))
    bound = 1e-4 * np.abs(ref).max()
    for (status, body, _), row in zip(replies, ref):
        assert status == 200, body
        assert body["model"] == "tiny" and len(body["top"]) == 3
        want = np.argsort(row)[-3:][::-1]
        assert [t["class"] for t in body["top"]] == want.tolist()
        np.testing.assert_allclose([t["logit"] for t in body["top"]],
                                   row[want], rtol=0, atol=bound)
        assert body["top"][0]["prob"] >= body["top"][1]["prob"]
    st = eng.stats()
    assert st["served"] == 4 and st["batches"] >= 1
    # the CPU path computes the plain ingest: no kernel launches here
    status, stats = _get(srv.port, "/v1/stats")
    assert status == 200 and stats["kernels"] == {
        "serve_ingest": serve_ingest.launches}


def test_http_healthz_models_and_errors(server):
    srv, _ = server()
    status, body = _get(srv.port, "/v1/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["engines"]["tiny"]["batcher_alive"]
    status, body = _get(srv.port, "/v1/models")
    assert status == 200
    assert body["models"]["tiny"]["model"]["infer_dtype"] == "int8"
    assert _post(srv.port, "/v1/classify", {"pixels": [[1, 2]]})[0] == 400
    # image_b64 decodes with PIL (501 only without it,
    # tests/test_torch_serve_obs.py): two bytes are no image
    assert _post(srv.port, "/v1/classify", {"image_b64": "AA=="})[0] == 400
    assert _post(srv.port, "/v1/classify", {})[0] == 400
    # a classifier on the detect, pose or generate verb: 400 naming its
    # own route
    for verb in ("detect", "pose", "generate"):
        status, body, _ = _post(srv.port, f"/v1/{verb}", {"pixels": []})
        assert status == 400 and "/v1/classify" in body["error"]
    assert _post(srv.port, "/v1/frobnicate", {"pixels": []})[0] == 404
    assert _get(srv.port, "/v1/nope")[0] == 404


def test_http_sheds_with_429(server):
    srv, eng = server(max_queue=0)
    status, body, headers = _post(
        srv.port, "/v1/classify", {"pixels": images(1, 32)[0].tolist()})
    assert status == 429 and "queue_full" in body["error"]
    assert eng.admission.stats()["shed_queue_full"] == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_batches_match_bucket_calls(f32_pair, depth):
    """Served rows equal the bucket callable's rows for the same inputs,
    synchronous (depth 1) or pipelined (depth 2); staging buffers are
    reused across batches."""
    _, psm = f32_pair
    x = images(6, 32, seed=13)
    ref = psm.compile_bucket(8)(np.concatenate(
        [x, np.zeros((2, 32, 32, 3), np.uint8)])).numpy()[:6]
    eng = BatchingEngine(psm, max_batch=4, max_wait_ms=50.0,
                         pipeline_depth=depth).start()
    try:
        for _ in range(2):
            futs = [eng.submit(img) for img in x]
            rows = [f.result(60) for f in futs]
            np.testing.assert_allclose(np.stack(rows), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max())
        st = eng.stats()
        assert st["served"] == 12 and st["padded_images"] >= 0
        assert st["pipeline"]["staging"]["reused"] >= 1
        assert st["pipeline"]["h2d_bytes"] > 0
        assert st["health"]["state"] == "ok"
    finally:
        eng.stop()


def test_engine_sheds_when_not_running(f32_pair):
    from deep_vision_tpu_torch.serve.admission import Shed

    _, psm = f32_pair
    eng = BatchingEngine(psm, max_batch=2)
    res = eng.submit(images(1, 32)[0]).result(5)
    assert isinstance(res, Shed) and res.reason == "shutdown"
    eng.start()
    eng.stop()
    res = eng.submit(images(1, 32)[0]).result(5)
    assert isinstance(res, Shed) and res.reason == "shutdown"


def test_engine_deadline_shed(f32_pair):
    from deep_vision_tpu_torch.serve.admission import Shed

    _, psm = f32_pair
    with BatchingEngine(psm, max_batch=2, max_wait_ms=5.0) as eng:
        res = eng.submit(images(1, 32)[0], deadline_ms=0.001).result(5)
        assert isinstance(res, Shed) and res.reason == "deadline"
        assert eng.admission.stats()["shed_deadline"] == 1


def test_profile_bucket_on_cpu(f32_pair):
    """The profiling tool runs on the CPU; device fields stay null there."""
    from deep_vision_tpu_torch.obs.profile import kernel_group, profile_bucket

    _, psm = f32_pair
    rep = profile_bucket(psm, 2, iters=2)
    assert rep["wall_ms_per_forward"] > 0
    assert rep["device_busy_ms_per_forward"] is None
    assert kernel_group("void serve_ingest_kernel<true>") == "serve_ingest"
    assert kernel_group("sm90_xmma_fprop_implicit_gemm") == "conv"
    assert kernel_group("nvjet_tst_128x192_64x5_2x1_v_bz_coopB_TNN") == "conv"
    assert kernel_group("vectorized_elementwise_kernel") == "other"
