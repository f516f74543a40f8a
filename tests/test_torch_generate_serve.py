"""The port's ``/v1/generate`` serving on the CPU, against the JAX
reference: ``GenerateWorkload.decode`` by seed and by latent with every
400, the uint8 epilogue's bytes (ties at .5 included), the ``dcgan`` and
a small ``cyclegan`` bucket callable against the reference's
``CheckpointServingModel`` (float32, and int8 for CycleGAN on the uint8
wire through the plain "gan" prologue), the engine's D2H bytes an image,
``POST /v1/generate`` over HTTP with the verb routing both ways, and
``load_state`` of a GAN ``.npz``.

Tolerances: float32 compute: the float outputs within 1e-4 of their
largest magnitude, the uint8 codes within 1 and equal on at least 99%
(a code at a rounding boundary may take its neighbour); the ``dcgan``
recipe computes in bf16 on both sides: outputs within 1e-2 of the
largest (measured 5.8e-3), codes within 2 (measured 1, on 6% of the
pixels).  Decode, epilogue and D2H are exact."""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import seeded_variables
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState
from deep_vision_tpu.models import gan as jgan
from deep_vision_tpu.serve.registry import (
    CheckpointServingModel as JaxServingModel,
)
from deep_vision_tpu.serve.workloads import (
    GenerateWorkload as JaxGenerateWorkload,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core import config as port_config
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.restore import import_weights, load_state
from deep_vision_tpu_torch.models import gan
from deep_vision_tpu_torch.models.common import ConvTranspose2d
from deep_vision_tpu_torch.models.resnet import BasicBlock, ResNet
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.http import ServeServer
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)
from deep_vision_tpu_torch.serve.workloads import WORKLOADS

pytestmark = pytest.mark.serve

GENERATE = WORKLOADS["generate"]
SMALL = "torch_port_cyclegan_small"
DCGAN32 = "torch_port_dcgan_f32"
TINY = "torch_port_generate_classify_tiny"
port_config.register_config(SMALL)(lambda: port_config.TrainConfig(
    name=SMALL, task="gan_cyclegan", image_size=32, num_classes=0,
    model=lambda: gan.CycleGANGenerator(2)))
port_config.register_config(DCGAN32)(lambda: port_config.TrainConfig(
    name=DCGAN32, task="gan_dcgan", image_size=28, channels=1,
    num_classes=0, model=lambda: gan.DCGANGenerator()))
port_config.register_config(TINY)(lambda: port_config.TrainConfig(
    name=TINY, image_size=16, num_classes=5,
    model=lambda: ResNet((1,), BasicBlock, 5)))


class _Shape:
    def __init__(self, shape):
        self.input_shape = shape


def _both_decode(body, shape=(100,)):
    """(port result or its ValueError, reference result or its
    ValueError)."""
    out = []
    for wl in (GENERATE, JaxGenerateWorkload()):
        try:
            out.append(wl.decode(body, _Shape(shape)))
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("body", [
    {}, {"seed": 7}, {"seed": "12"}, {"seed": -3},
    {"latent": list(np.linspace(-2, 2, 100))},
    {"latent": [[0.5] * 100]}, {"latent": [0.0] * 3},
    {"latent": [float("nan")] * 100}, {"latent": ["x"] * 100},
    {"seed": "x"}, {"seed": [1, 2]}, {"seed": None}])
def test_decode_matches_reference(body):
    got, want = _both_decode(body)
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError), got
        assert str(got).split(":")[0] == str(want).split(":")[0]
        return
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_leaves_image_models_to_pixels():
    got, want = _both_decode({"seed": 1}, (32, 32, 3))
    assert got is None and want is None


def _tie_values() -> np.ndarray:
    """float32 outputs whose (x + 1)·127.5 is exactly k + 0.5, with the
    neighbours of every code boundary, ±0 and values past ±1."""
    ties = []
    for k in range(255):
        x = np.float32((k + 0.5) / 127.5 - 1.0)
        for d in range(-3, 4):
            y = x
            for _ in range(abs(d)):
                y = np.nextafter(y, np.float32(np.sign(d)), dtype=np.float32)
            ties.append(y)
    ties = np.array(ties, np.float32)
    extra = np.array([-0.0, 0.0, -1.0, 1.0, -1.5, 1.5, -50.0, 50.0],
                     np.float32)
    return np.concatenate([ties, extra])


def test_epilogue_bytes_match_reference_on_ties():
    x = _tie_values()
    exact = ((x + np.float32(1.0)) * np.float32(127.5)) % 1 == 0.5
    assert exact.sum() > 100  # real ties are in the set
    model = _Shape((28, 28, 1))
    model.output_wire = "uint8"
    want = np.asarray(JaxGenerateWorkload().make_epilogue(model)(
        jnp.asarray(x)))
    got = GENERATE.make_epilogue(model)(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    model.output_wire = "float32"
    assert GENERATE.make_epilogue(model) is None


def _variables(name):
    if name in ("dcgan", DCGAN32):
        jm = jgan.DCGANGenerator()
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 100))))
        rng = np.random.RandomState(2)

        def leaf(path, s):
            key = str(getattr(path[-1], "key", path[-1]))
            shp = tuple(s.shape)
            if key == "kernel":
                fan = np.prod(shp[:-1]) if len(shp) == 4 else shp[0]
                a = rng.randn(*shp) / np.sqrt(fan)
            elif key in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shp)
            else:
                a = rng.randn(*shp) * 0.1
            return np.asarray(a, np.float32)

        return jm, jax.tree_util.tree_map_with_path(leaf, shapes)
    jm = jgan.CycleGANGenerator(n_blocks=2)
    return jm, seeded_variables(jm, (32, 32, 3), seed=3)


def _pair(name, infer_dtype, wire="uint8"):
    """(reference serving model, port serving model) of ``name`` on the
    same weights."""
    if name == "dcgan":
        jcfg = jax_get_config("dcgan")
    else:
        jcfg = jax_get_config("cyclegan" if name == SMALL else "dcgan")
        jcfg.image_size = get_config(name).image_size
        jcfg.model = (lambda: jgan.CycleGANGenerator(n_blocks=2)) \
            if name == SMALL else (lambda: jgan.DCGANGenerator())
    jm = jcfg.model()
    _, v = _variables(name)
    state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                              tx=build_optimizer(OptimizerConfig()),
                              batch_stats=v["batch_stats"])
    jsm = JaxServingModel(name, jcfg, jm, state, wire_dtype=wire,
                          infer_dtype=infer_dtype)
    cfg = get_config(name)
    model = cfg.model()
    import_weights(model, v)
    psm = CheckpointServingModel(name, cfg, model, wire_dtype=wire,
                                 infer_dtype=infer_dtype, device="cpu")
    return jsm, psm


def _inputs(sm, n, seed=5):
    rng = np.random.RandomState(seed)
    if str(sm.wire_dtype) == "uint8":
        return rng.randint(0, 256, (n, *sm.input_shape)).astype(np.uint8)
    return rng.randn(n, *sm.input_shape).astype(np.float32)


@pytest.mark.parametrize("name,infer_dtype", [
    (DCGAN32, "float32"), ("dcgan", "float32"), (SMALL, "float32"),
    (SMALL, "int8")])
def test_bucket_matches_reference(name, infer_dtype):
    jsm, psm = _pair(name, infer_dtype)
    assert psm.input_shape == jsm.input_shape
    assert str(psm.wire_dtype) == str(jsm.wire_dtype)
    assert psm.output_wire == jsm.output_wire == "uint8"
    if name != SMALL:
        assert str(psm.wire_dtype) == "float32"  # uint8 asked: overridden
    if infer_dtype == "int8":
        assert psm.quant.act_scale == jsm.quant.act_scale
        convs = [m for m in psm._model.modules()
                 if isinstance(m, ConvTranspose2d)]
        assert convs and all(m.weight.dtype == torch.int8 and
                             m.weight_scale.shape == (m.weight.shape[0],)
                             for m in convs)
    x = _inputs(psm, 4)
    want = np.asarray(jax.device_get(jsm.compile_bucket(4)(x)))
    got = psm.compile_bucket(4)(x).numpy()
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (4, *(psm.input_shape
                                            if name == SMALL
                                            else (28, 28, 1)))
    bf16 = name == "dcgan"
    codes = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert codes.max() <= (2 if bf16 else 1), codes.max()
    if not bf16:
        assert (codes == 0).mean() >= 0.99
    jsm.output_wire = psm.output_wire = "float32"
    ref = np.asarray(jax.device_get(jsm.compile_bucket(4)(x)))
    out = psm.compile_bucket(4)(x).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=(1e-2 if bf16 else 1e-4)
                               * np.abs(ref).max())


@pytest.mark.parametrize("name,row", [(DCGAN32, 28 * 28), (SMALL,
                                                           32 * 32 * 3)])
def test_engine_d2h_is_one_uint8_image(name, row):
    _, psm = _pair(name, "float32")
    x = _inputs(psm, 3)
    with BatchingEngine(psm, buckets=[4], max_wait_ms=50) as eng:
        rows = [f.result(60) for f in [eng.submit(im) for im in x]]
        stats = eng.stats()["pipeline"]
    direct = psm.compile_bucket(4)(np.concatenate(
        [x, np.zeros_like(x[:1])])).numpy()
    for i, r in enumerate(rows):
        assert r.dtype == np.uint8 and r.nbytes == row
        np.testing.assert_array_equal(r, direct[i])
    assert stats["d2h_bytes"] == 4 * row


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _image(reply):
    img = reply["image"]
    return np.frombuffer(base64.b64decode(img["b64"]), img["dtype"]) \
        .reshape(img["shape"])


def test_generate_over_http_and_verb_routing():
    reg = ModelRegistry()
    dc = reg.load_checkpoint(DCGAN32, device="cpu", wire_dtype="uint8")
    cg = reg.load_checkpoint(SMALL, device="cpu", wire_dtype="uint8")
    tiny = reg.load_checkpoint(TINY, device="cpu", wire_dtype="uint8")
    engines = {m.name: BatchingEngine(m, buckets=[1, 2], max_wait_ms=5)
               for m in (dc, cg, tiny)}
    for e in engines.values():
        e.start()
    server = ServeServer(reg, engines, port=0).start_background()
    try:
        port = server.port
        status, a = _post(port, "/v1/generate", {"model": DCGAN32,
                                                 "seed": 3})
        assert status == 200 and a["model"] == DCGAN32
        assert a["image"]["shape"] == [28, 28, 1]
        z = GENERATE.decode({"seed": 3}, dc)
        np.testing.assert_array_equal(
            _image(a), dc.compile_bucket(1)(z[None]).numpy()[0])
        status, b = _post(port, "/v1/generate", {"model": DCGAN32,
                                                 "latent": z.tolist()})
        assert status == 200 and b["image"] == a["image"]
        for bad in ({"seed": "x"}, {"latent": [1.0, 2.0]},
                    {"latent": [float("nan")] * 100}):
            status, r = _post(port, "/v1/generate",
                              dict(bad, model=DCGAN32))
            assert status == 400, (bad, r)
        px = _inputs(cg, 1)[0]
        status, c = _post(port, "/v1/generate", {"model": SMALL,
                                                 "pixels": px.tolist()})
        assert status == 200 and c["image"]["shape"] == [32, 32, 3]
        np.testing.assert_array_equal(
            _image(c), cg.compile_bucket(1)(px[None]).numpy()[0])
        status, r = _post(port, "/v1/generate", {"model": SMALL,
                                                 "seed": 1})
        assert status == 400 and "pixels" in r["error"]
        # the verb routing, both ways
        status, r = _post(port, "/v1/classify", {"model": DCGAN32,
                                                 "seed": 1})
        assert status == 400 and "/v1/generate" in r["error"]
        status, r = _post(port, "/v1/generate", {
            "model": TINY, "pixels": _inputs(tiny, 1)[0].tolist()})
        assert status == 400 and "/v1/classify" in r["error"]
        status, r = _post(port, "/v1/frobnicate", {"seed": 1})
        assert status == 404 and "generate" in r["supported_verbs"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/models", timeout=30) as resp:
            models = json.loads(resp.read())["models"]
        assert models[DCGAN32]["model"]["workload"] == "generate"
        assert models[DCGAN32]["model"]["output_wire"] == "uint8"
    finally:
        server.shutdown()
        for e in engines.values():
            e.stop()


@pytest.mark.parametrize("name", [DCGAN32, SMALL])
def test_load_state_of_gan_weights(name, tmp_path):
    jm, v = _variables(name)
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, v)
    info = {}
    model = load_state(get_config(name), path, log=lambda *_: None,
                       info=info)
    assert info["weights"] == path and info["digest"]
    twin = get_config(name).model()
    import_weights(twin, v)
    for k, t in twin.state_dict().items():
        assert torch.equal(model.state_dict()[k], t), k
    x = np.random.RandomState(1).randn(2, *((100,) if name == DCGAN32
                                            else (32, 32, 3)))
    x = x.astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    with pytest.raises(KeyError):
        load_state(get_config(SMALL if name == DCGAN32 else DCGAN32), path,
                   log=lambda *_: None)
