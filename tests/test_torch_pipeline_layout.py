"""The pipelined layout of both stacked families on the CPU, against the
reference's layout maps (``deep_vision_tpu/models/hourglass.py`` and
``centernet.py`` ``merge_``/``split_*_variables``, through its
``PipelinedModel.import_``/``export_monolithic_variables``) on the same
seeded weights: the port's split of the monolithic ``state_dict`` equals
the reference's split imported through ``convert.pipelined_from_flax``,
the port's merge equals the reference's merge, both round trips are the
identity, ``convert``'s pipelined importer is strict both ways, and the
pipelined init draws what the monolithic init draws.  No reference
program is compiled here."""

import numpy as np
import pytest
import torch

import jax

import _torch_pipe as tpp
from deep_vision_tpu.parallel.pipelined import (
    PipelinedModel as JaxPipelinedModel,
)
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.parallel.pipelined import (
    PipelinedModel,
    is_pipelined_state,
    monolithic_state_dict,
)

STACKS = 2


def _monolithic_from_flax(family: str, tree) -> dict:
    _, mono = tpp.FAMILIES[family](STACKS)
    if family == "hourglass":
        return convert.stacked_hourglass_from_flax(
            tree, STACKS, tpp.HEAT, 8, 1, 1)
    return convert.centernet_from_flax(tree, STACKS, mono.order,
                                       mono.filters)


def _port(family: str) -> PipelinedModel:
    return tpp.port_pipelined(family, STACKS, tpp.port_mesh(1, 2))


def _equal(a: dict, b: dict) -> None:
    assert list(a) == list(b) or set(a) == set(b), \
        (sorted(set(a) ^ set(b)))[:5]
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _np(sd: dict) -> dict:
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in sd.items()}


@pytest.mark.parametrize("family", ["hourglass", "centernet"])
def test_the_port_s_maps_equal_the_reference_s(family):
    conv, mv = tpp.variables(family, STACKS)
    pm = _port(family)
    # the port's merge of the reference's split is the monolithic tree
    mono_sd = _monolithic_from_flax(family, mv)
    _equal(_np(pm.export_monolithic_variables()), mono_sd)
    # the reference's merge, imported, is the port's merge
    jmono, _ = tpp.FAMILIES[family](STACKS)
    jpm = JaxPipelinedModel.for_model(jmono, tpp.jax_mesh(1, 1))
    merged = jpm.export_monolithic_variables(conv["params"],
                                             conv["batch_stats"])
    _equal(_monolithic_from_flax(family, merged), mono_sd)
    # the port's split of the monolithic state_dict is the reference's
    # split (the last stage's re-injection from the model's own tensors)
    want = convert.pipelined_from_flax(conv, pm)
    pm.import_monolithic_variables(
        {k: torch.from_numpy(v) for k, v in mono_sd.items()})
    _equal(tpp.numpy_sd(pm), want)
    # a served checkpoint merges the same way
    _, mono = tpp.FAMILIES[family](STACKS)
    assert is_pipelined_state(want) and not is_pipelined_state(mono_sd)
    _equal(_np(monolithic_state_dict(mono, want)), mono_sd)


@pytest.mark.parametrize("family", ["hourglass", "centernet"])
def test_round_trips_are_the_identity(family):
    pm = _port(family)
    sd = pm.state_dict()
    merged = pm.export_monolithic_variables()
    last = [k for k in sd if k.startswith(f"stages.{STACKS - 1}.reinject")]
    assert last and set(sd) - {"stages." + k[len("stacks."):]
                               for k in merged
                               if k.startswith("stacks.")} \
        - {k for k in sd if k.startswith("stem.")} == set(last)
    split = pm.family.split(merged, sd)
    _equal(_np(split), _np(sd))
    _equal(_np(pm.family.merge(split)), _np(merged))
    # a monolithic state_dict short of a tensor does not split
    short = dict(merged)
    short.pop(next(k for k in short if k.startswith("stacks.0.")))
    with pytest.raises(KeyError, match="do not match"):
        pm.family.split(short, sd)


@pytest.mark.parametrize("family", ["hourglass", "centernet"])
def test_the_pipelined_importer_is_strict_both_ways(family):
    conv, _ = tpp.variables(family, STACKS)
    pm = _port(family)
    back = convert.pipelined_to_flax(pm.state_dict(), pm)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           {"params": conv["params"],
                            "batch_stats": conv["batch_stats"]})
    assert convert.to_flax(pm).keys() == back.keys()
    extra = jax.tree_util.tree_map(np.array, conv)
    extra["params"]["stem"]["Conv_9"] = {"kernel": np.zeros((1,)),
                                         "bias": np.zeros((1,))}
    with pytest.raises(KeyError, match="no module"):
        convert.pipelined_from_flax(extra, pm)
    short = jax.tree_util.tree_map(lambda a: np.asarray(a)[:1], conv)
    short["params"]["stem"] = conv["params"]["stem"]
    short["batch_stats"]["stem"] = conv["batch_stats"]["stem"]
    with pytest.raises(ValueError, match="leading stage axis of 2"):
        convert.pipelined_from_flax(short, pm)
    with pytest.raises(KeyError, match="'stem' and 'stages'"):
        convert.pipelined_from_flax(
            {"params": {**conv["params"], "other": {}},
             "batch_stats": conv["batch_stats"]}, pm)


@pytest.mark.parametrize("family", ["hourglass", "centernet"])
def test_the_pipelined_init_draws_the_monolithic_init(family):
    _, mono = tpp.FAMILIES[family](STACKS)
    mono.reset_parameters(torch.Generator().manual_seed(5))
    pm = PipelinedModel.for_model(mono, tpp.port_mesh(1, 2))
    pm.reset_parameters(torch.Generator().manual_seed(5))
    _equal(_np(pm.export_monolithic_variables()), _np(mono.state_dict()))
    assert pm.num_microbatches == 2  # the pipe size by default


def test_a_family_without_stages_is_refused_with_the_reference_words():
    from deep_vision_tpu.models.yolo import YoloV3 as JaxYolo
    from deep_vision_tpu_torch.models.yolo import YoloV3

    with pytest.raises(TypeError) as want:
        JaxPipelinedModel.for_model(JaxYolo(num_classes=3),
                                    tpp.jax_mesh(1, 2))
    with pytest.raises(TypeError) as got:
        PipelinedModel.for_model(YoloV3(num_classes=3, width=0.125),
                                 tpp.port_mesh(1, 2))
    w, g = str(want.value), str(got.value)
    assert g.rsplit("got ", 1)[0] == w.rsplit("got ", 1)[0]
    assert g.endswith("got YoloV3")
    # the reference's constructor checks
    _, mono = tpp.hourglass(3)
    with pytest.raises(ValueError, match="num_stages=3 not divisible by "
                                         "pipe axis size 2"):
        PipelinedModel.for_model(mono, tpp.port_mesh(1, 2))
    with pytest.raises(TypeError, match="needs a CenterNet"):
        PipelinedModel.from_centernet(mono, tpp.port_mesh(1, 2))
