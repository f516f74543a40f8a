"""The classifier zoo's weight layouts: the port's ``state_dict`` is the
reference's PyTorch layout where the JAX package imports one
(``deep_vision_tpu/models/pretrained.py``: LeNet-5, AlexNet, VGG,
MobileNet V1, Inception V1), checked by a round trip through those
importers at sizes where the NCHW/NHWC flatten permutation matters, and
``core/restore.load_state`` loads a ``.npz`` of every family, exactly,
and refuses one of another family.
"""

import numpy as np
import pytest

import jax

import _torch_port as tp
import _torch_zoo as tz
from deep_vision_tpu.models.pretrained import (
    import_torch_alexnet,
    import_torch_inception_v1,
    import_torch_lenet5,
    import_torch_mobilenet_v1,
    import_torch_sequential,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.core.config import get_config
from deep_vision_tpu_torch.core.restore import load_state


def _assert_trees_equal(got, want):
    g = convert.flatten_tree(jax.device_get(got))
    w = convert.flatten_tree(jax.device_get(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:5]
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)


def _importer_case(name, size):
    """(port model, flax variables) of ``name`` at ``size``."""
    jax_factory, factory, _, ch = tz.MODELS[name]
    variables = tp.seeded_variables(jax_factory(), (size, size, ch), seed=8)
    model = factory(size)
    convert.load_classifier(model, variables)
    return model, variables


@pytest.mark.parametrize("name,size,importer", [
    ("lenet5", 32, import_torch_lenet5),
    ("alexnet1", 224, import_torch_alexnet),
    ("alexnet2", 224, import_torch_alexnet),
    ("vgg16", 64, lambda sd: import_torch_sequential(sd, (2, 2))),
    ("vgg19", 64, lambda sd: import_torch_sequential(sd, (2, 2))),
    ("mobilenet1", 64, import_torch_mobilenet_v1),
    ("inception1", 224, import_torch_inception_v1),
])
def test_state_dict_is_the_reference_pytorch_layout(name, size, importer):
    """The port's state_dict is the layout the JAX package imports from
    the reference's PyTorch checkpoints: its importer gives back the
    very flax variables the port was loaded from.  AlexNet (6×6×256)
    and Inception V1's aux heads (4×4×128) at 224², VGG at 64² (2×2×512,
    through the generic sequential importer that ``import_torch_vgg``
    calls with its 224² (7, 7)): the flatten permutation is exercised;
    LeNet-5 flattens 1×1×120 by design."""
    model, variables = _importer_case(name, size)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _assert_trees_equal(importer(sd), {
        "params": variables["params"],
        "batch_stats": variables.get("batch_stats", {})})


#: a config of each family and the image size its test model takes
LOAD_CASES = {"lenet5_nano": 32, "lenet5": 32, "lenet5_big": 32,
              "alexnet1": 127, "vgg16": 64, "inception1": 128,
              "inception3": 139, "mobilenet1": 64, "shufflenet1": 64,
              "resnet50v2": 64}


def _config_npz(tmp_path, name, size):
    """A config's model at ``size`` and a ``.npz`` of seeded flax
    variables of its reference counterpart (1000 classes)."""
    from deep_vision_tpu.core.config import get_config as jax_get_config

    cfg = get_config(name)
    cfg.image_size = size
    jcfg = jax_get_config(name)
    variables = tp.seeded_variables(jcfg.model(), (size, size, cfg.channels),
                                    seed=9)
    path = str(tmp_path / f"{name}.npz")
    convert.save_npz(path, variables)
    return cfg, variables, path


@pytest.mark.parametrize("name", sorted(LOAD_CASES))
def test_load_state_of_every_family(tmp_path, name):
    cfg, variables, path = _config_npz(tmp_path, name, LOAD_CASES[name])
    info = {}
    model = load_state(cfg, path, log=lambda *_: None, info=info)
    assert info["weights"] == path and not model.training
    want = convert.classifier_from_flax(variables, model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("source,target", [
    ("alexnet1", "vgg16"), ("alexnet1", "alexnet2"),
    ("alexnet1", "resnet50v2"), ("resnet50v2", "resnet50"),
    ("inception1", "inception3"), ("lenet5", "lenet5_big"),
    ("mobilenet1", "shufflenet1")])
def test_load_state_refuses_another_family(tmp_path, source, target):
    """A ``.npz`` of one family never loads as another: the strict
    importers raise."""
    _, _, path = _config_npz(tmp_path, source, LOAD_CASES.get(source, 64))
    cfg = get_config(target)
    cfg.image_size = LOAD_CASES.get(target, 64)
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        load_state(cfg, path, log=lambda *_: None)
