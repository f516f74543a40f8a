"""The port's ResNet (deep_vision_tpu_torch/models/resnet.py) and weight
converter (convert.py) against the JAX reference.

- Round trip: a seeded flax tree → ``convert.flax_to_torch`` → the JAX
  package's own ``import_torch_resnet`` → the same tree, exactly.
- Forward: the same seeded weights and inputs through a JAX ``ResNet``
  and the port.  At float32 the logits agree within 1e-4·max|ref|; at
  bfloat16 within 3e-2·max|ref| (both frameworks round bf16, but at
  different places: cuDNN/oneDNN versus XLA accumulation order), with
  top-1 equal on most rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    images,
    jax_model,
    load_port,
    port_model,
    seeded_variables,
)
from deep_vision_tpu.models.pretrained import import_torch_resnet
from deep_vision_tpu.models.resnet import ResNet34, ResNet50
from deep_vision_tpu.ops.preprocess import serve_normalize
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models import resnet as port_resnet


@pytest.mark.parametrize("arch,ctor", [("resnet50", ResNet50),
                                       ("resnet34", ResNet34)])
def test_weight_round_trip_through_reference_importer(arch, ctor):
    variables = seeded_variables(ctor(num_classes=1000), (224, 224, 3))
    sd = convert.flax_to_torch(variables, arch)
    back = import_torch_resnet(sd, arch)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # the port's own inverse agrees too
    mine = convert.import_torch_resnet(sd, arch)
    for path, leaf in jax.tree_util.tree_leaves_with_path(mine):
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("arch,ctor", [("resnet50", port_resnet.ResNet50),
                                       ("resnet34", port_resnet.ResNet34)])
def test_state_dict_keys_match_converter(arch, ctor):
    """The port's modules carry exactly torchvision's key layout."""
    model = ctor(num_classes=1000)
    variables = seeded_variables(
        {"resnet50": ResNet50, "resnet34": ResNet34}[arch](num_classes=1000),
        (224, 224, 3))
    sd = convert.flax_to_torch(variables, arch)
    assert sorted(model.state_dict()) == sorted(sd)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == sd[k].shape, k


def test_npz_weights_round_trip(tmp_path):
    model = jax_model((1, 1))
    variables = seeded_variables(model, (32, 32, 3), seed=4)
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, variables)
    back = convert.load_npz(path)
    for p, leaf in jax.tree_util.tree_leaves_with_path(variables):
        node = back
        for k in p:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def _forward_pair(stage_sizes, block, dtype, n=8, seed=0):
    jm = jax_model(stage_sizes, block, 10, dtype)
    variables = seeded_variables(jm, (32, 32, 3), seed=seed)
    x = np.array(serve_normalize(jnp.asarray(images(n, 32, seed)),
                                 "imagenet"))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    pm = load_port(port_model(stage_sizes, block, 10, dtype), variables)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    return ref, got.numpy()


@pytest.mark.parametrize("stage_sizes,block", [
    ((1, 1), "BottleneckBlock"), ((1, 1), "BasicBlock"),
    ((2, 1), "BottleneckBlock")])
def test_forward_parity_f32(stage_sizes, block):
    ref, got = _forward_pair(stage_sizes, block, jnp.float32)
    bound = 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=bound)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("stage_sizes,block", [
    ((1, 1), "BottleneckBlock"), ((1, 1), "BasicBlock")])
def test_forward_parity_bf16(stage_sizes, block):
    ref, got = _forward_pair(stage_sizes, block, jnp.bfloat16, n=16)
    bound = 3e-2 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=bound)
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    assert agree >= 0.75 * len(ref), f"top-1 agrees on {agree}/{len(ref)}"


def test_reset_parameters_follows_reference_init():
    """He fan-out convs, unit BN with the last BN scale of each block
    zeroed, zero fc bias — and the same seed gives the same weights."""
    a = port_model((1, 1)).reset_parameters(torch.Generator().manual_seed(3))
    b = port_model((1, 1)).reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    block = a.layer1[0]
    assert torch.count_nonzero(block.bn3.weight) == 0
    assert torch.all(block.bn1.weight == 1)
    assert torch.count_nonzero(a.fc.bias) == 0
    conv = block.conv2.weight.detach()
    want = np.sqrt(2.0 / (conv.shape[0] * conv.shape[2] * conv.shape[3]))
    assert abs(float(conv.std()) - want) < 0.1 * want
