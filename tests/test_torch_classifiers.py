"""The port's classifier zoo (deep_vision_tpu_torch/models/lenet.py,
alexnet.py, vgg.py, inception.py, mobilenet.py, shufflenet.py and
ResNet-50 V2 in resnet.py) against the JAX reference's models, and the
converters between them (deep_vision_tpu_torch/convert.py).

Every model runs at its full width, 10 classes, at a small input size
with a last feature map above 1×1 where a dense layer flattens it (so a
wrong flatten permutation fails), from seeded flax weights with non-zero
BatchNorm scales (``_torch_port.seeded_variables``).

Tolerances:
- eval mode: logits within 1e-5·max|ref| (float32; the two packages sum
  convolutions and the LRN window in different orders; measured at most
  3e-6·max, AlexNet's LRN);
- train mode, with the masks every flax Dropout applied replayed into
  the port (``_torch_zoo``; seeded numpy masks, since the flax forwards
  are jitted): every head's logits and every updated BatchNorm
  statistic within 1e-4·max|ref| (training BatchNorm at batch 2 over
  small maps amplifies the rounding differences through the depth);
- ``local_response_norm`` within 1e-6 relative; ``channel_shuffle``,
  the converters' round trips and the int8 codes and scales exactly
  (the reference-layout importers and ``load_state``:
  tests/test_torch_classifiers_convert.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_zoo as tz
from deep_vision_tpu.models import common as j_common
from deep_vision_tpu.models import shufflenet as j_shufflenet
from deep_vision_tpu.serve.quant import quantize_params as jax_quantize
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models import shufflenet
from deep_vision_tpu_torch.models.common import local_response_norm
from deep_vision_tpu_torch.serve.quant import quantize_params

NAMES = sorted(tz.MODELS)


def _flat(tree):
    return convert.flatten_tree(jax.device_get(tree))


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:5]
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_eval_matches_flax(name):
    x = tz.inputs(name)
    ref = tz.flax_eval(name, tz.variables(name), x)
    model = tz.port(name).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())




@pytest.mark.parametrize("channels,size", [(96, 96), (7, 4), (192, 192),
                                           (6, 5)])
def test_local_response_norm_matches_reference(channels, size):
    """The window (size//2 before, (size−1)//2 after) at odd and even
    sizes, and the reference models' full-channel windows."""
    x = np.random.RandomState(channels).randn(2, channels, 5, 4) \
        .astype(np.float32) * 3
    ref = np.asarray(j_common.local_response_norm(
        jnp.asarray(x.transpose(0, 2, 3, 1)), size))
    got = local_response_norm(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("groups", [2, 3, 4])
def test_channel_shuffle_is_the_reference_permutation(groups):
    c = groups * 5
    x = np.arange(2 * c * 3 * 2, dtype=np.float32).reshape(2, c, 3, 2)
    got = shufflenet.channel_shuffle(torch.from_numpy(x), groups).numpy()
    ref = np.asarray(j_shufflenet.channel_shuffle(
        jnp.asarray(x.transpose(0, 2, 3, 1)), groups)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, ref)
    # a permutation of the channels, the same at every pixel
    perm = got[0, :, 0, 0].astype(int) // 6
    assert sorted(perm) == list(range(c)) and perm[1] == 5
    np.testing.assert_array_equal(got, x[:, perm])


@pytest.mark.parametrize("name", NAMES)
def test_converters_strict_both_ways(name):
    """flax → port → flax is the identity; the port's state_dict keys
    are the converter's; a missing or an extra flax leaf raises."""
    variables = tz.variables(name)
    model = tz.port(name)
    sd = convert.classifier_from_flax(variables, model)
    assert set(sd) == set(model.state_dict())
    _assert_trees_equal(convert.classifier_to_flax(
        {k: v.numpy() for k, v in model.state_dict().items()}, model),
        {"params": variables["params"],
         "batch_stats": variables.get("batch_stats", {})})
    flat = _flat(variables)
    missing = dict(flat)
    missing.pop(sorted(missing)[len(missing) // 2])
    with pytest.raises(KeyError):
        convert.classifier_from_flax(convert.unflatten_tree(missing), model)
    extra = dict(flat)
    extra["params/Extra_0/kernel"] = np.zeros((1, 1), np.float32)
    with pytest.raises(KeyError, match="no module"):
        convert.classifier_from_flax(convert.unflatten_tree(extra), model)


@pytest.mark.parametrize("name", ["mobilenet1", "shufflenet1"])
def test_int8_codes_of_grouped_convs_match_reference(name):
    """Per-output-channel int8 of depthwise (O, 1, 3, 3) and grouped
    (O, I/g, 1, 1) weights: the port's codes and scales equal the JAX
    ``quantize_params`` of the flax kernels (kH, kW, I/g, O)."""
    variables = tz.variables(name)
    model = tz.port(name)
    q, s = quantize_params(model.state_dict())
    jq, js = jax.device_get(jax_quantize(variables["params"]))
    codes = convert.classifier_from_flax(
        {"params": jq, "batch_stats": variables["batch_stats"]}, model)
    grouped = 0
    for kind, t, path, *_ in convert.classifier_leaves(model):
        if kind == "bn":
            continue
        key = f"{t}.weight"
        assert q[key].dtype == np.int8
        np.testing.assert_array_equal(q[key], codes[key], err_msg=key)
        scale = js
        for p in (*path, "kernel"):
            scale = scale[p]
        np.testing.assert_array_equal(s[key], scale, err_msg=key)
        grouped += int(model.get_submodule(t).groups > 1) \
            if kind != "dense" else 0
    assert grouped >= 13
