"""The port's classifier zoo in training mode against the JAX
reference: every model's training forward (deep_vision_tpu_torch/models/
lenet.py, alexnet.py, vgg.py, inception.py, mobilenet.py, shufflenet.py,
ResNet-50 V2) from the same seeded weights (non-zero BatchNorm scales),
with every flax Dropout's mask replayed into the port's Dropouts
(``_torch_zoo``: seeded numpy masks inside the jitted flax forward,
permuted where a Dropout reads a flattened map).  Inception returns its
tuple of heads.

Tolerances: every head's logits and every updated BatchNorm statistic
within 1e-4·max|ref| (training BatchNorm at batch 2 over small maps
amplifies the two packages' float32 rounding through the depth);
Inception V3 at 299², whose aux head needs the 17×17 map, within
1e-3·max|ref|: its 94 training BatchNorms at batch 2 amplify rounding
so that the reference's own logits move 1.1e-4 (aux 2.6e-4) of their
max under a 1e-6 relative perturbation of the input (measured; the port
was 3.4e-4 from it).
"""

import numpy as np
import pytest
import torch

import _torch_port as tp
import _torch_zoo as tz
from deep_vision_tpu_torch import convert

NAMES = sorted(tz.MODELS)


@pytest.mark.parametrize("name", [n for n in NAMES if n != "inception3"])
def test_train_matches_flax_with_replayed_masks(name):
    """Training-mode forward: the outputs (a tuple for Inception), and
    the BatchNorm statistics the step leaves behind."""
    x = tz.inputs(name, seed=2)
    variables = tz.variables(name)
    masks = tz.FlaxMasks(seed=3)
    ref, new_vars = tz.flax_train(tz.MODELS[name][0](), variables, x, masks)
    model = tz.port(name).train()
    handles, calls = tz.replay_masks(model, masks.masks)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for h in handles:
        h.remove()
    assert len(calls) == len(masks.masks)
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    if "batch_stats" in new_vars:
        want = convert.classifier_from_flax(
            {"params": variables["params"], **new_vars}, model)
        sd = model.state_dict()
        for k, w in want.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), w, rtol=0,
                                           atol=1e-4 * np.abs(w).max(),
                                           err_msg=k)


def test_inception3_train_outputs_at_299():
    """Inception V3's aux head needs the 17×17 map of a 299² input: in
    training mode both heads, (logits, aux), match flax (seeded numpy
    dropout masks on both sides), and eval returns the logits alone."""
    from deep_vision_tpu.models.inception import InceptionV3 as JaxV3
    from deep_vision_tpu_torch.models.inception import InceptionV3

    jm = JaxV3(num_classes=tz.CLASSES)
    variables = tp.seeded_variables(jm, (299, 299, 3), seed=4)
    x = np.random.RandomState(5).randn(2, 299, 299, 3).astype(np.float32)
    masks = tz.FlaxMasks(seed=7)
    (ref, ref_aux), _ = tz.flax_train(jm, variables, x, masks)
    model = InceptionV3(tz.CLASSES)
    convert.load_classifier(model, variables)
    model.train()
    handles, calls = tz.replay_masks(model, masks.masks)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x))
    for h in handles:
        h.remove()
    assert len(calls) == len(masks.masks) == 1
    for g, r in ((got, ref), (aux, ref_aux)):
        r = np.asarray(r)
        assert g.shape == r.shape == (2, tz.CLASSES)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-3 * np.abs(r).max())
    model.eval()
    with torch.no_grad():
        assert isinstance(model(torch.from_numpy(x[:1])), torch.Tensor)
