"""``parallel/partition.py`` against the reference's rule engine.

The rule engine case for case as tests/test_mesh_serving.py holds the
reference's (first match wins, strict exactly-one-match with the same
``ValueError`` words, the built-in tables non-strict, the first-divisible
fallback and its indivisible trailing dim, the ``--partition-rules``
syntax), each case run through both packages.  Then, for every family
``cli.serve`` serves (at toy sizes), a port model's ``leaf_paths`` — its
tensors under the flax path its converter gives them, in flax layout —
equal the reference's variables tree leaf for leaf, and
``param_partition_spec`` gives the reference's spec for every leaf at
``min_shard_dim`` 64 and 1024 with a model axis of 2 and of 4, under the
fallback sharder and both built-in tables."""

import functools

import jax
import numpy as np
import pytest

import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import _torch_zoo as tz
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu.core.restore import serving_input_shape
from deep_vision_tpu.parallel import partition as jpart
from deep_vision_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.parallel import partition as ppart
from deep_vision_tpu_torch.parallel.mesh import make_mesh

pytestmark = [pytest.mark.serve, pytest.mark.mesh]

#: served families: config names of both packages, and zoo models at
#: their test sizes (tests/_torch_zoo.py)
CONFIGS = ["lenet5", "resnet50", "resnet34", "yolov3_toy", "centernet_toy",
           "hourglass_toy", "dcgan", "cyclegan"]
ZOO = ["alexnet1", "vgg16", "inception1", "inception3", "mobilenet1",
       "shufflenet1", "resnet50v2"]


def _both(fn_name, *args, **kwargs):
    """(reference result or error words, port result or error words)."""
    out = []
    for mod in (jpart, ppart):
        try:
            out.append(getattr(mod, fn_name)(*args, **kwargs))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def _flat(tree, prefix=()):
    """Nested dict → {path: leaf}; PartitionSpecs are leaves."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v) \
                if isinstance(v, tuple) else v
    return out


# -- the rule engine -------------------------------------------------------


def test_match_rules_first_wins_and_unmatched_replicates():
    params = {"params": {"head": {"kernel": np.zeros((8, 4)),
                                  "bias": np.zeros((4,))},
                         "step": np.zeros(())}}
    want, got = _both("match_partition_rules",
                      [(r"head/kernel$", JP(None, "model")),
                       (r"head/.*", JP("model"))], params)
    assert _flat(got) == _flat(want)
    assert got["params"]["head"]["kernel"] == ppart.P(None, "model")
    assert got["params"]["head"]["bias"] == ppart.P("model")
    assert got["params"]["step"] == ppart.P()


@pytest.mark.parametrize("rules", [
    [(r"kernel$", ("model", 1))],
    [(r"kernel$", ("model", 1)), (r".*", ())],
    [(r"kernel$", ("model", 1)), (r"bias$", ())],
], ids=["unmatched", "overlap", "disjoint"])
def test_strict_words_equal_the_reference(rules):
    params = {"head": {"kernel": np.zeros((8, 4)), "bias": np.zeros((4,))}}
    table = [(pat, JP(*([None] * spec[1] + [spec[0]])) if spec else JP())
             for pat, spec in rules]
    want, got = _both("match_partition_rules", table, params, strict=True)
    if isinstance(want, tuple):
        assert got == want
        assert "matches no rule" in got[1] or "matches 2 rules" in got[1]
    else:
        assert _flat(got) == _flat(want)


def test_builtin_tables_are_the_reference_tables():
    for name, table in jpart.RULE_TABLES.items():
        assert [(p, tuple(s)) for p, s in table] == \
            [(p, tuple(s)) for p, s in ppart.RULE_TABLES[name]]
    params = {"params": {"head": {"kernel": np.zeros((128, 1000))}}}
    want, got = _both("match_partition_rules",
                      jpart.RULE_TABLES["classifier"], params)
    assert got["params"]["head"]["kernel"] == ppart.P(None, "model")
    want, got = _both("match_partition_rules",
                      jpart.RULE_TABLES["classifier"], params, strict=True)
    assert got == want and "matches 2 rules" in got[1]


@pytest.mark.parametrize("task", [None, "gan", "generation", "cyclegan",
                                  "dcgan", "classification", "classify",
                                  "detection", "pose"])
def test_rules_for_equals_the_reference(task):
    want, got = jpart.rules_for(task), ppart.rules_for(task)
    assert (got is None) == (want is None)
    if want is not None:
        assert [(p, tuple(s)) for p, s in got] == \
            [(p, tuple(s)) for p, s in want]


@pytest.mark.parametrize("shape,n,min_dim", [
    ((2048, 1002), 4, 512), ((2048, 1024), 4, 512), ((100, 100), 4, 512),
    ((2048, 1024), 1, 1024), ((3, 3, 512, 2048), 2, 1024),
    ((1, 1, 2048, 512), 2, 1024), ((2048,), 2, 64), ((7, 7, 3, 64), 4, 64),
    ((1, 1, 256, 1000), 3, 64)])
def test_first_divisible_spec_equals_the_reference(shape, n, min_dim):
    want, got = _both("first_divisible_spec", shape, n, min_shard_dim=min_dim)
    assert got == tuple(want)


@pytest.mark.parametrize("spec", [
    "classifier", "gan", "head/kernel=-,model;.*=",
    "head/kernel=-,model;conv.*/kernel=-,-,-,model;.*=",
    " a=model ; b= ; c=None,-,model ", "no-equals-sign-here", ";;"])
def test_parse_partition_rules_equals_the_reference(spec):
    want, got = _both("parse_partition_rules", spec)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert [(p, tuple(s)) for p, s in got] == \
            [(p, tuple(s)) for p, s in want]


def test_leaf_paths_of_a_dict_equal_the_reference():
    tree = {"params": {"Dense_1": {"bias": np.zeros(3)},
                       "Conv_0": {"kernel": np.zeros((1, 1, 1, 2))}},
            "batch_stats": {"b": np.zeros(2)}}
    assert [n for n, _ in ppart.leaf_paths(tree)] == \
        [n for n, _ in jpart.leaf_paths(tree)]


# -- every served family -----------------------------------------------------


@functools.cache
def _family(name):
    """(reference variables' shapes {path: shape}, port model)."""
    if name in ZOO:
        jax_factory, port_factory, size, ch = tz.MODELS[name]
        jm, port = jax_factory(), port_factory(size)
        shape = (size, size, ch)
    else:
        cfg = jax_get_config(name)
        jm, port = cfg.model(), get_config(name).model()
        shape = serving_input_shape(cfg, jm)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape)),
        train=False))
    ref = {n: tuple(s.shape) for n, s in jpart.leaf_paths(dict(shapes))}
    return ref, port


@pytest.mark.parametrize("name", CONFIGS + ZOO)
def test_leaf_paths_equal_the_reference(name):
    """Names and flax-layout shapes, leaf for leaf, in jax's order."""
    ref, port = _family(name)
    got = [(n, leaf.shape) for n, leaf in ppart.leaf_paths(port)]
    assert got == list(ref.items())
    # each path names a tensor of the port, whose dims map back
    sd = port.state_dict()
    for n, leaf in ppart.leaf_paths(port):
        t = sd[leaf.key]
        assert tuple(t.shape[d] for d in leaf.dims) == leaf.shape


class _Shaped:
    """A stand-in with a ``shape`` for the reference's leaves."""

    def __init__(self, shape):
        self.shape = shape


def _nested(flat):
    out: dict = {}
    for path, shape in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _Shaped(shape)
    return out


@pytest.mark.parametrize("name", CONFIGS + ZOO)
@pytest.mark.parametrize("table", [None, "classifier", "gan"])
def test_specs_equal_the_reference(name, table):
    """The spec of every leaf at min_shard_dim 64 and 1024, model axis 2
    and 4: the same leaves laid the same way in both packages."""
    ref, port = _family(name)
    tree = _nested(ref)
    leaves = ppart.leaf_paths(port)
    for m in (2, 4):
        jmesh = jax_make_mesh({"data": 1, "model": m},
                              devices=jax.devices()[:m])
        pmesh = make_mesh({"data": 1, "model": m}, devices=["cpu"] * m)
        for min_dim in (64, 1024):
            rules = None if table is None else ppart.RULE_TABLES[table]
            want = _flat(jpart.param_partition_spec(
                tree, jmesh, min_dim,
                rules=None if table is None else jpart.RULE_TABLES[table]))
            got = ppart.param_partition_spec(port, pmesh, min_dim,
                                             rules=rules)
            assert [n for n, _ in leaves] == list(want)
            assert {n: got[n] for n in want} == \
                {n: tuple(s) for n, s in want.items()}, (m, min_dim)


def test_int8_leaves_add_the_reference_scales():
    """An int8 model's codes keep their paths and its per-channel
    scales are the reference's ``param_scales/<path>/kernel``; the
    reference's 0-d identity scales of float leaves have no tensor."""
    from _torch_serve import jax_lenet, lenet_variables, port_lenet

    v = lenet_variables(0)
    jsm, psm = jax_lenet(v, "uint8", "int8"), port_lenet(v, "uint8", "int8")
    want = {n: (tuple(a.shape), str(a.dtype))
            for n, a in jpart.leaf_paths(jsm._variables) if np.ndim(a)}
    got = {n: (leaf.shape, str(leaf.dtype).replace("torch.", ""))
           for n, leaf in ppart.leaf_paths(psm._model)}
    assert got == want
