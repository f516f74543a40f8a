"""The port's hourglass modules, CenterNet and its decode against the
JAX reference (deep_vision_tpu/models/hourglass.py, models/centernet.py,
tasks/centernet.py), on the same seeded flax weights (non-zero BatchNorm
scales, positive running variances) and the same numpy inputs.

Forwards run in eval mode (running statistics) in float32 and agree
within 1e-4·max|ref|; the converters round-trip exactly; the decode
agrees in its classes and scores, and its boxes within 1e-5, including
on a heatmap of plateaus where an unstable top-k order would pick other
peaks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import seeded_variables
from deep_vision_tpu.models import centernet as jax_centernet
from deep_vision_tpu.models import hourglass as jax_hourglass
from deep_vision_tpu.tasks import centernet as jax_cn_task
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.models.centernet import (
    HEAT_BIAS,
    CenterNet,
    same_pad,
)
from deep_vision_tpu_torch.models.common import BatchNorm2d
from deep_vision_tpu_torch.models.hourglass import (
    HourglassModule,
    PreActBottleneck,
    up2,
)
from deep_vision_tpu_torch.tasks.centernet import decode_detections

BOUND = 1e-4


def _nhwc(seed, n, size, ch):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, size, size, ch)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=BOUND * np.abs(ref).max())


@pytest.mark.parametrize("in_ch,filters", [(8, 16), (16, 16)])
def test_preact_bottleneck_matches_flax(in_ch, filters):
    jm = jax_hourglass.PreActBottleneck(filters, jnp.float32)
    v = seeded_variables(jm, (8, 8, in_ch), seed=1)
    x = _nhwc(0, 2, 8, in_ch)
    ref = jm.apply(v, x, train=False)
    pm = PreActBottleneck(in_ch, filters).eval()
    pm.load_state_dict({k: torch.from_numpy(a) for k, a in
                        convert.preact_from_flax(v, in_ch, filters).items()},
                       strict=True)
    assert (pm.shortcut is None) == (in_ch == filters)
    with torch.no_grad():
        got = pm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, ref)


def test_up2_is_jax_nearest_resize():
    x = _nhwc(3, 2, 5, 3)
    ref = jax.image.resize(x, (2, 10, 10, 3), "nearest")
    got = up2(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("order,filters,in_ch", [
    (1, 8, 8), (2, (8, 12, 16), 8), (3, (16, 16, 24, 24), 12)])
def test_hourglass_module_matches_flax(order, filters, in_ch):
    jm = jax_hourglass.HourglassModule(order, filters, 1, jnp.float32)
    size = 2 ** order * 2
    v = seeded_variables(jm, (size, size, in_ch), seed=2)
    x = _nhwc(1, 2, size, in_ch)
    ref = jm.apply(v, x, train=False)
    pm = HourglassModule(in_ch, order, filters).eval()
    sd = convert.hourglass_from_flax(v, in_ch, order, filters)
    pm.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, ref)
    back = convert.flatten_tree(
        convert.hourglass_to_flax(pm.state_dict(), in_ch, order, filters))
    want = convert.flatten_tree(v)
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)


CENTERNETS = {
    # the centernet_toy config: one order-3 stack at 64² → 16²
    "toy": dict(num_classes=3, num_stack=1, order=3,
                filters=(16, 16, 24, 24), size=64),
    # two stacks: re-injection between them
    "two_stacks": dict(num_classes=4, num_stack=2, order=3,
                       filters=(16, 16, 24, 24), size=64),
    # an odd input: flax "SAME" pads (3, 3) on the 7×7/2 stem there
    "odd_input": dict(num_classes=2, num_stack=1, order=2,
                      filters=(8, 8, 16), size=34),
}


def _pair(name, seed=4):
    kw = dict(CENTERNETS[name])
    size = kw.pop("size")
    jm = jax_centernet.CenterNet(dtype=jnp.float32, **kw)
    v = seeded_variables(jm, (size, size, 3), seed=seed)
    pm = CenterNet(**kw).eval()
    convert.load_centernet(pm, v)
    return jm, v, pm, size


@pytest.mark.parametrize("name", sorted(CENTERNETS))
def test_centernet_matches_flax(name):
    jm, v, pm, size = _pair(name)
    x = np.random.RandomState(5).rand(2, size, size, 3).astype(np.float32)
    ref = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert len(got) == len(ref) == pm.num_stack
    for r_stack, g_stack in zip(ref, got):
        for r, g in zip(r_stack, g_stack):
            assert g.dtype == torch.float32
            _close(g.numpy(), r)


def test_toy_config_is_the_reference_toy():
    cfg = get_config("centernet_toy")
    m = cfg.model()
    assert (m.num_classes, m.num_stack, m.order, m.filters) == \
        (3, 1, 3, (16, 16, 24, 24))
    assert cfg.task == "centernet" and cfg.image_size == 64
    full = get_config("centernet")
    assert (full.image_size, full.num_classes, full.batch_size) == \
        (256, 80, 32)


def test_same_pad_is_flax_same():
    assert same_pad(256, 7, 2) == (2, 3)
    assert same_pad(64, 7, 2) == (2, 3)
    assert same_pad(33, 7, 2) == (3, 3)
    assert same_pad(16, 3, 1) == (1, 1)


def test_converter_round_trip_and_strictness():
    _, v, pm, _ = _pair("two_stacks")
    kw = CENTERNETS["two_stacks"]
    back = convert.flatten_tree(convert.centernet_to_flax(
        pm.state_dict(), kw["num_stack"], kw["order"], kw["filters"]))
    want = convert.flatten_tree(v)
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)
    # the last stack has no re-injection conv, the first one does
    assert "params/Conv_2/kernel" in want
    assert "params/Conv_4/kernel" not in want
    extra = convert.unflatten_tree(dict(want, **{
        "params/Conv_9/kernel": np.zeros((1, 1, 16, 16), np.float32)}))
    with pytest.raises(KeyError, match="Conv_9"):
        convert.load_centernet(CenterNet(4, 2, 3, (16, 16, 24, 24)), extra)
    missing = convert.unflatten_tree(
        {k: a for k, a in want.items() if "DetectionHead_5" not in k})
    with pytest.raises(KeyError, match="DetectionHead_5"):
        convert.load_centernet(CenterNet(4, 2, 3, (16, 16, 24, 24)),
                               missing)


def test_reset_parameters_is_the_reference_init():
    m = CenterNet(3, 2, 2, (8, 8, 16))
    a = m.reset_parameters(torch.Generator().manual_seed(0)).state_dict()
    b = CenterNet(3, 2, 2, (8, 8, 16)).reset_parameters(
        torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for stack in m.stacks:
        assert torch.all(stack.heat.out.bias == HEAT_BIAS)
        assert torch.all(stack.wh.out.bias == 0.0)
    for mod in m.modules():
        if isinstance(mod, BatchNorm2d):
            assert torch.all(mod.weight == 1.0)
            assert torch.all(mod.running_var == 1.0)
    # He normal over fan-out for the stem (4 outputs of 7×7):
    # std sqrt(2 / (4·7·7)) ≈ 0.101
    std = float(m.stem_conv.weight.detach().std())
    assert 0.08 < std < 0.12


def _heads(seed, b=2, g=16, c=3, tie=False):
    rng = np.random.RandomState(seed)
    heat = rng.normal(-1.0, 1.5, (b, g, g, c))
    if tie:
        # a few logit levels in plateaus of 2×2 cells: equal neighbours
        # all survive peak suppression, so top-k meets runs of ties
        levels = rng.randint(0, 3, (b, g // 2, g // 2, c)).astype(float)
        heat = np.repeat(np.repeat(levels, 2, 1), 2, 2) - 1.0
    wh = rng.uniform(0.5, 6.0, (b, g, g, 2))
    off = rng.uniform(0.0, 1.0, (b, g, g, 2))
    return [a.astype(np.float32) for a in (heat, wh, off)]


@pytest.mark.parametrize("tie,k", [(False, 40), (True, 40), (True, 100)])
def test_decode_matches_reference(tie, k):
    heat, wh, off = _heads(7, tie=tie)
    r_boxes, r_scores, r_cls = (np.asarray(a) for a in
                                jax_cn_task.decode_detections(
                                    jnp.asarray(heat), jnp.asarray(wh),
                                    jnp.asarray(off), k=k))
    g_boxes, g_scores, g_cls = decode_detections(
        torch.from_numpy(heat), torch.from_numpy(wh), torch.from_numpy(off),
        k=k)
    np.testing.assert_array_equal(g_cls.numpy(), r_cls)
    np.testing.assert_allclose(g_scores.numpy(), r_scores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_boxes.numpy(), r_boxes, rtol=0, atol=1e-5)
    if tie:
        # the case really is tied: many kept scores repeat
        assert len(np.unique(r_scores[0])) < k // 4
