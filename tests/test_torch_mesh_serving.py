"""The port's ``for_mesh`` views against the reference's on the same
weights: serving over a ``data × model`` grid of local devices.

The JAX side runs on conftest's forced host devices (``jax.devices()``,
8 virtual CPUs), the port's on a grid of ``"cpu"`` (a device may repeat
in a local mesh).  LeNet-5 at full width and a narrow ResNet (one
bottleneck block a stage, two stages, 32²) share their seeded flax
weights through ``convert.py``.  Every cell (2×2, 4×1, 1×4) answers
within rtol/atol 1e-5 of the reference's view with top-1 identical (as
tests/test_mesh_serving.py holds the reference's cells to its single
device engine); a model-axis shard concatenated in the wrong order must
fail that bound.  The rest mirrors tests/test_mesh_serving.py and
tests/test_replicas.py: strict tables, the divisibility error's words,
per-chip bytes, spill and re-admit with no callable rebuilt,
``sharded_buckets``, the sharded mega-batch, int8."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jax.sharding import PartitionSpec as JP

from _torch_port import jax_model, load_port, port_model, seeded_variables
from _torch_serve import images, jax_lenet, lenet_variables, port_lenet
from deep_vision_tpu.core.config import TrainConfig as JaxTrainConfig
from deep_vision_tpu.core.optim import OptimizerConfig, build_optimizer
from deep_vision_tpu.core.state import TrainState
from deep_vision_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deep_vision_tpu.parallel.partition import (
    parse_partition_rules as jax_parse_rules,
)
from deep_vision_tpu.serve.engine import BatchingEngine as JaxEngine
from deep_vision_tpu.serve.engine import sharded_buckets as jax_buckets
from deep_vision_tpu.serve.registry import (
    CheckpointServingModel as JaxServingModel,
)
from deep_vision_tpu_torch.core.config import TrainConfig
from deep_vision_tpu_torch.ops import preprocess
from deep_vision_tpu_torch.parallel.mesh import make_mesh
from deep_vision_tpu_torch.parallel.partition import P, parse_partition_rules
from deep_vision_tpu_torch.serve import mesh_view
from deep_vision_tpu_torch.serve.engine import (
    BatchingEngine,
    map_leaves,
    sharded_buckets,
)
from deep_vision_tpu_torch.serve.models import WeightCache
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)
from deep_vision_tpu_torch.serve.replicas import ReplicatedEngine

pytestmark = [pytest.mark.serve, pytest.mark.mesh]

CELLS = [(2, 2), (4, 1), (1, 4)]
IDS = ["2x2", "4x1", "1x4"]
TOL = 1e-5
#: the reference's disjoint (strict-compatible) LeNet table
STRICT = [(r"Conv_2/kernel$", ("model",), 3),
          (r"Dense_0/kernel$", ("model",), 1),
          (r"(bias|Conv_[01]/kernel|Dense_1/kernel)$", (), 0)]


def _strict(spec_fn):
    return [(pat, spec_fn(*([None] * dim + list(axes))))
            for pat, axes, dim in STRICT]


def _meshes(d, m):
    return (jax_make_mesh({"data": d, "model": m},
                          devices=jax.devices()[:d * m]),
            make_mesh({"data": d, "model": m}, devices=["cpu"] * (d * m)))


@pytest.fixture(scope="module")
def lenet():
    v = lenet_variables(0)
    return jax_lenet(v), port_lenet(v)


def _resnet_pair(infer="float32", wire="uint8", seed=3):
    jm = jax_model((1, 1), "BottleneckBlock", 10)
    variables = seeded_variables(jm, (32, 32, 3), seed=seed)
    jcfg = JaxTrainConfig(name="torch_mesh_tiny", model=lambda: jm,
                          image_size=32, channels=3, num_classes=10)
    state = TrainState.create(apply_fn=jm.apply, params=variables["params"],
                              tx=build_optimizer(OptimizerConfig()),
                              batch_stats=variables["batch_stats"])
    jsm = JaxServingModel("tiny", jcfg, jm, state, wire_dtype=wire,
                          infer_dtype=infer, ingest="xla")
    cfg = TrainConfig(name="torch_mesh_tiny",
                      model=lambda: port_model((1, 1)),
                      image_size=32, channels=3, num_classes=10)
    psm = CheckpointServingModel("tiny", cfg,
                                 load_port(cfg.model(), variables),
                                 wire_dtype=wire, infer_dtype=infer,
                                 device="cpu")
    return jsm, psm


@pytest.fixture(scope="module")
def resnet():
    return _resnet_pair()


def _serve_all(eng, imgs):
    futs = [eng.submit(x) for x in imgs]
    return [np.asarray(f.result(60)) for f in futs]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.array_equal(np.argmax(got, -1), np.argmax(want, -1))


@pytest.mark.parametrize("d,m", CELLS, ids=IDS)
def test_lenet_cells_match_reference_engines(lenet, d, m):
    """Both packages' engines over their mesh views, the same 8 images:
    answers within 1e-5 with top-1 identical, and the stats' mesh."""
    jsm, psm = lenet
    jmesh, pmesh = _meshes(d, m)
    imgs = images(8, seed=11)
    with JaxEngine(jsm.for_mesh(jmesh, min_shard_dim=64), max_batch=4,
                   max_wait_ms=1.0, buckets=jax_buckets(4, d)) as eng:
        want = _serve_all(eng, imgs)
    view = psm.for_mesh(pmesh, min_shard_dim=64)
    with BatchingEngine(view, max_batch=4, max_wait_ms=1.0,
                        buckets=sharded_buckets(4, d)) as eng:
        got = _serve_all(eng, imgs)
        st = eng.stats()
    assert st["mesh_shape"] == {"data": d, "model": m}
    assert st["health"]["mesh_shape"] == {"data": d, "model": m}
    assert st["param_shard_bytes"] == view.param_bytes()
    assert st["param_global_bytes"] == psm.param_bytes()
    _close(np.stack(got), np.stack(want))


@pytest.mark.parametrize("d,m", CELLS, ids=IDS)
def test_resnet_cells_match_reference_and_shards_run(resnet, d, m,
                                                     monkeypatch):
    """A narrow ResNet on the uint8 wire at every cell and bucket 4:
    within 1e-5 of the reference's view, and the convolutions see the
    shards: with a model axis, a column-split conv's kernels have 1/M of
    its output channels and a row-split one's inputs 1/M of its
    channels; each batch reaches the stem conv as D row shards."""
    jsm, psm = resnet
    jmesh, pmesh = _meshes(d, m)
    x = images(4, seed=5, wire="uint8", shape=(32, 32, 3))
    want = np.asarray(jsm.for_mesh(jmesh, min_shard_dim=64)
                      .compile_bucket(4)(x))
    view = psm.for_mesh(pmesh, min_shard_dim=64)
    fn = view.compile_bucket(4)
    seen = []
    conv2d = F.conv2d

    def record(inp, weight, *args, **kwargs):
        seen.append((tuple(inp.shape), tuple(weight.shape)))
        return conv2d(inp, weight, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", record)
    got = fn(x).numpy()
    _close(got, want)
    stems = [s for s in seen if s[1][1:] == (3, 7, 7)]
    assert [(s[0][0], s[1][0]) for s in stems] == [(4 // d, 64 // m)] * (d * m)
    if m > 1:
        modes = {s.mode for s in view._layout.specs.values()}
        assert {"column", "row"} <= modes
        # layer2's 1×1 expand conv (128 → 512) runs as M column shards
        assert seen.count(((4 // d, 128, 4, 4), (512 // m, 128, 1, 1))) \
            == d * m
    else:
        assert all(s.mode == "replicated"
                   for s in view._layout.specs.values())


def test_wrong_shard_order_fails_the_bound(resnet, monkeypatch):
    """The control: the model-axis shards of every split layer joined
    in reverse order answer outside the bound the cells are held to."""
    jsm, psm = resnet
    jmesh, pmesh = _meshes(1, 4)
    x = images(4, seed=5, wire="uint8", shape=(32, 32, 3))
    want = np.asarray(jsm.for_mesh(jmesh, min_shard_dim=64)
                      .compile_bucket(4)(x))
    view = psm.for_mesh(pmesh, min_shard_dim=64)
    fn = view.compile_bucket(4)
    for mod in view._model.modules():
        if isinstance(mod, mesh_view.ShardedLayer):
            mod.shards = torch.nn.ModuleList(list(mod.shards)[::-1])
    got = fn(x).numpy()
    assert not np.allclose(got, want, rtol=TOL, atol=TOL)


def test_strict_rules_through_for_mesh(lenet):
    jsm, psm = lenet
    jmesh, pmesh = _meshes(2, 2)
    jview = jsm.for_mesh(jmesh, partition_rules=_strict(JP), strict=True,
                         min_shard_dim=64)
    view = psm.for_mesh(pmesh, partition_rules=_strict(P), strict=True,
                        min_shard_dim=64)
    assert view.param_bytes() < view.param_global_bytes()
    assert view.param_bytes() == jview.param_bytes()
    x = images(4, seed=2)
    _close(view.compile_bucket(4)(x).numpy(),
           np.asarray(jview.compile_bucket(4)(x)))
    # a table that misses leaves fails loudly at load, in both packages
    words = []
    for sm, mesh, spec in ((jsm, jmesh, JP), (psm, pmesh, P)):
        with pytest.raises(ValueError, match="matches no rule") as e:
            sm.for_mesh(mesh, partition_rules=[
                (r"Dense_0/kernel$", spec(None, "model"))], strict=True)
        words.append(str(e.value))
    assert words[0] == words[1]


def test_divisibility_error_names_both_axes(lenet):
    jsm, psm = lenet
    jmesh, pmesh = _meshes(2, 2)
    words = []
    for view in (jsm.for_mesh(jmesh, min_shard_dim=64),
                 psm.for_mesh(pmesh, min_shard_dim=64)):
        with pytest.raises(ValueError) as e:
            view.compile_bucket(3)
        words.append(str(e.value))
    assert words[0] == words[1]
    assert "2×2 data×model mesh" in words[1]
    assert "nearest usable bucket is 4" in words[1]
    assert "multiples of 2" in words[1]


@pytest.mark.parametrize("d,m", CELLS, ids=IDS)
def test_per_chip_bytes_equal_the_reference(lenet, d, m):
    """One chip's share prices as the reference's ``shard_shape`` does:
    below the replicated bytes whenever ``model`` > 1, equal to them on
    a data-only grid; the logical bytes unchanged."""
    jsm, psm = lenet
    jmesh, pmesh = _meshes(d, m)
    jview = jsm.for_mesh(jmesh, min_shard_dim=64)
    view = psm.for_mesh(pmesh, min_shard_dim=64)
    replicated = psm.param_bytes()
    assert view.mesh_shape() == {"data": d, "model": m}
    assert view.param_bytes() == jview.param_bytes()
    assert view.param_global_bytes() == jview.param_global_bytes() \
        == replicated
    if m > 1:
        assert view.param_bytes() < replicated
    else:
        assert view.param_bytes() == replicated
    assert f"sharded over {d * m} devices" in view.placement_desc()


def test_cache_spill_readmit_sharded_bit_identical(lenet):
    """Evict → spill → re-admit of a model-sharded view: every shard
    goes back to its own device, outputs bit-identical, no callable
    rebuilt, per-chip pricing kept."""
    _, psm = lenet
    view = psm.for_mesh(_meshes(2, 2)[1], min_shard_dim=64)
    homes = [t.device for t in view._tensors()]
    cache = WeightCache(budget_bytes=psm.param_bytes() + 1)
    cache.register(psm)
    cache.register(view)
    img = images(1, seed=3)[0]
    with BatchingEngine(view, max_batch=4, max_wait_ms=1.0,
                        buckets=sharded_buckets(4, 2)) as eng:
        first = np.asarray(eng.infer(img, timeout=60))
        compiles = eng.compiles
        assert cache.pin(psm)  # admits the base, evicting the view
        cache.unpin(psm)
        assert not view._resident
        assert all(t.device.type == "cpu" for t in view._tensors())
        again = np.asarray(eng.infer(img, timeout=60))
        assert np.array_equal(first, again)
        assert eng.compiles == compiles
    assert view._resident
    assert [t.device for t in view._tensors()] == homes
    assert view.param_bytes() < view.param_global_bytes()
    st = cache.stats()
    assert st["evictions"] >= 1 and st["spilled_bytes_total"] > 0


@pytest.mark.parametrize("max_batch,n", [(32, 8), (32, 4), (8, 8), (32, 1),
                                         (4, 2), (5, 2), (3, 4), (64, 3)])
def test_sharded_buckets_equal_the_reference(max_batch, n):
    assert sharded_buckets(max_batch, n) == jax_buckets(max_batch, n)


def test_sharded_megabatch_equals_unsharded_engine(lenet):
    """--shard-batches: one padded batch split over a data-only grid of
    4 answers as the single-device engine does, every row of the grid
    holding the whole model; the ingest runs once a data shard."""
    _, psm = lenet
    view = psm.for_mesh(make_mesh({"data": 4}, devices=["cpu"] * 4))
    assert view.mesh_shape() == {"data": 4}
    assert view.param_bytes() == psm.param_bytes()
    imgs = images(24, seed=7)
    buckets = sharded_buckets(32, 4)
    with BatchingEngine(view, max_batch=32, buckets=buckets,
                        max_wait_ms=20.0, watchdog_interval_s=0) as eng:
        got = _serve_all(eng, imgs)
        st = eng.stats()
    with BatchingEngine(psm, max_batch=32, max_wait_ms=20.0,
                        watchdog_interval_s=0) as eng:
        ref = _serve_all(eng, imgs)
    np.testing.assert_allclose(np.stack(got), np.stack(ref), atol=1e-5)
    assert st["buckets"] == buckets
    assert "sharded over 4 devices" in view.placement_desc()


def test_int8_ingest_runs_once_a_data_shard(monkeypatch):
    """int8 on the uint8 wire through the fallback sharder: within the
    reference's int8 view at 1e-5, top-1 identical, and the fused
    ingest called once a data shard a batch on that row's shard."""
    v = lenet_variables(1)
    jsm, psm = jax_lenet(v, "uint8", "int8"), port_lenet(v, "uint8", "int8")
    jmesh, pmesh = _meshes(2, 2)
    x = images(4, seed=8, wire="uint8")
    want = np.asarray(jsm.for_mesh(jmesh, min_shard_dim=64)
                      .compile_bucket(4)(x))
    view = psm.for_mesh(pmesh, min_shard_dim=64)
    calls = []
    ingest = preprocess.serve_ingest

    def counted(t, *a, **k):
        calls.append(tuple(t.shape))
        return ingest(t, *a, **k)

    monkeypatch.setattr(preprocess, "serve_ingest", counted)
    fn = view.compile_bucket(4)
    _close(fn(x).numpy(), want)
    assert calls == [(2, 32, 32, 1)] * 2
    # the int8 codes split with their scales: column shards hold 1/M
    specs = view._layout.specs
    assert specs["features.8.weight"].mode == "column"
    assert specs["features.8.weight_scale"].mode == "shard"
    # per-chip bytes below the whole model's; the reference also holds
    # a 0-d identity scale a float leaf, which the port has no tensor for
    assert view.param_bytes() < view.param_global_bytes()
    n_scalar = sum(1 for k in psm._model.state_dict()
                   if k.endswith(".bias"))
    assert jsm.for_mesh(jmesh, min_shard_dim=64).param_bytes() \
        == view.param_bytes() + 4 * n_scalar


@pytest.mark.parametrize("rules", ["classifier", "Dense_1/kernel=-,model;.*=",
                                   "params/Dense_0/kernel=-,model;.*="])
def test_int8_under_rule_tables_as_the_reference(rules):
    """A kernel rule also matches the reference's ``param_scales/...``
    path, whose 1-D scale it cannot lay out: both packages raise the
    same words; a table anchored on ``params/`` serves."""
    v = lenet_variables(1)
    jsm, psm = jax_lenet(v, "uint8", "int8"), port_lenet(v, "uint8", "int8")
    jmesh, pmesh = _meshes(2, 2)
    outs = []
    for sm, mesh, parse in ((jsm, jmesh, jax_parse_rules),
                            (psm, pmesh, parse_partition_rules)):
        try:
            outs.append(np.asarray(sm.for_mesh(
                mesh, partition_rules=parse(rules), min_shard_dim=64)
                .compile_bucket(4)(images(4, seed=9, wire="uint8"))))
        except ValueError as e:
            outs.append(str(e).replace(", axis_types=(Auto, Auto)", "")
                        .replace(", memory_kind=device", ""))
    if rules.startswith("params/"):
        _close(outs[1], outs[0])
    else:
        assert isinstance(outs[0], str) and outs[1] == outs[0]
        assert "is only valid for values of rank at least 2" in outs[1]


@pytest.mark.parametrize("rules", [
    "Conv_0/bias=model;.*=",               # a 1-D leaf
    "Conv_2/kernel=-,-,model,-;.*=",        # input features of a conv
    "Conv_1/kernel=-,-,-,model;Dense_0/kernel=data,model;.*=",
    "Conv_2/kernel=-,model,-,-;.*=",        # a spatial kernel dim
    "Dense_1/kernel=-,model;.*=",          # 10 % 2: the reference's words
    "Dense_0/kernel=-,-,model",            # longer than the rank
    "Dense_0/kernel=-,foo",                # an axis the mesh lacks
])
def test_other_placements_and_refusals_as_the_reference(lenet, rules):
    """Every placement a rule can write serves within 1e-5 of the
    reference (gathered at use where it is not a feature split), and
    every spec the reference's device_put refuses raises its words."""
    jsm, psm = lenet
    jmesh, pmesh = _meshes(2, 2)
    x = images(4, seed=4)
    outs = []
    for sm, mesh, parse in ((jsm, jmesh, jax_parse_rules),
                            (psm, pmesh, parse_partition_rules)):
        try:
            view = sm.for_mesh(mesh, partition_rules=parse(rules))
            outs.append((np.asarray(view.compile_bucket(4)(x)),
                         view.param_bytes()))
        except ValueError as e:
            outs.append(str(e).replace(", axis_types=(Auto, Auto)", "")
                        .replace(", memory_kind=device", ""))
    if isinstance(outs[0], str):
        assert outs[1] == outs[0]
    else:
        _close(outs[1][0], outs[0][0])
        assert outs[1][1] == outs[0][1]


def test_replicated_engine_reports_no_mesh(lenet):
    _, psm = lenet
    with ReplicatedEngine(psm, devices=[torch.device("cpu")] * 2,
                          max_batch=4) as eng:
        st = eng.stats()
        health = eng.health_report()
    assert st["mesh_shape"] is None and health["mesh_shape"] is None
    assert st["param_global_bytes"] == psm.param_bytes()


def test_bf16_view_matches_its_single_device_model():
    """bfloat16 compute: the 2×2 view against the same model unsharded
    (the split adds only summation order), within the bf16 bound of
    tests/test_torch_serve.py, top-1 equal on most rows."""
    _, psm = _resnet_pair(infer="bfloat16")
    x = images(8, seed=6, wire="uint8", shape=(32, 32, 3))
    ref = psm.compile_bucket(8)(x).numpy()
    got = psm.for_mesh(_meshes(2, 2)[1], min_shard_dim=64) \
        .compile_bucket(8)(x).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())
    assert int((got.argmax(-1) == ref.argmax(-1)).sum()) >= 6


@pytest.mark.parametrize("decode", ["device", "host"])
def test_detect_view_matches_its_single_device_model(decode):
    """A detection model's outputs (the device decode's dict, or the
    dense heads' tuple) gathered in row order from a 2×2 view: equal to
    the unsharded model's within 1e-4 of their scale."""
    sm = ModelRegistry().load_checkpoint("yolov3_toy", device="cpu",
                                         detect_decode=decode)
    x = images(4, seed=12, shape=sm.input_shape)
    ref = map_leaves(lambda t: t.numpy(), sm.compile_bucket(4)(x))
    view = sm.for_mesh(_meshes(2, 2)[1], min_shard_dim=16)
    assert any(s.mode in ("column", "row")
               for s in view._layout.specs.values())
    got = map_leaves(lambda t: t.numpy(), view.compile_bucket(4)(x))
    flat_ref, flat_got = [], []
    map_leaves(flat_ref.append, ref)
    map_leaves(flat_got.append, got)
    assert len(flat_got) == len(flat_ref)
    for g, r in zip(flat_got, flat_ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        if g.dtype.kind == "f":
            np.testing.assert_allclose(
                g, r, rtol=0, atol=1e-4 * max(1.0, float(np.abs(r).max())))
