"""Weights between the reference's flax variables and the port's modules.

``flax_to_torch`` maps a flax ResNet variables tree of numpy arrays
(``{"params": ..., "batch_stats": ...}``, flax auto-names ``Conv_0``,
``BatchNorm_0``, ``BottleneckBlock_k``, ``Dense_0``) to the port's
torchvision-layout ``state_dict``; ``import_torch_resnet`` is the
inverse, a copy of ``deep_vision_tpu/models/pretrained.py``
``import_torch_resnet`` extended to any stage sizes.

Layout mapping (flax ↔ torch):
- conv kernel ``(kH, kW, I, O)`` ↔ weight ``(O, I, kH, kW)``
- Dense kernel ``(I, O)`` ↔ fc weight ``(O, I)``
- BatchNorm ``scale``/``bias`` (params) ↔ ``weight``/``bias``;
  ``mean``/``var`` (batch_stats) ↔ ``running_mean``/``running_var``
- torchvision block ``layer{s}.{i}`` ↔ ``{Basic,Bottleneck}Block_k``
  with k counting blocks across stages in call order.

Weight files (``--weights``) are ``.npz`` archives of the flax tree with
keys joined by ``/`` (``params/Conv_0/kernel``).

``yolo_from_flax`` / ``yolo_to_flax`` do the same for YOLOv3
(``models/yolo.py``): flax's auto-names (``Darknet53_0/DarknetConv_k``,
``DarknetResidual_k``, ``YoloConvBlock_k``, ``YoloHead_k``, each
DarknetConv holding ``Conv_0`` and ``BatchNorm_0``) ↔ the port's
``backbone.stem``, ``backbone.stages.{k}.{i}``, ``block13``/``head13``/
``lateral26``/…; the heads' 1×1 ``Conv_0`` carries a bias.

``centernet_from_flax`` / ``centernet_to_flax`` / ``load_centernet`` do
the same for CenterNet (``models/centernet.py``),
``stacked_hourglass_from_flax`` / ``stacked_hourglass_to_flax`` /
``load_stacked_hourglass`` for the pose model (``models/hourglass.py
StackedHourglass``), and
``hourglass_from_flax`` / ``hourglass_to_flax`` and ``preact_from_flax``
/ ``preact_to_flax`` for a bare ``HourglassModule`` or
``PreActBottleneck``; these check both sides strictly: a flax leaf that
no module takes raises, as a missing one does.

``gan_from_flax`` / ``gan_to_flax`` / ``load_gan`` do the same for the
four GAN networks (``models/gan.py``).

``classifier_from_flax`` / ``classifier_to_flax`` / ``load_classifier``
do the same for the classifier zoo (LeNet-5 and its tiers, AlexNet, VGG,
Inception V1/V3, MobileNet V1, ShuffleNet V1, ResNet-50 V2), walking the
port model's own modules.  Where the JAX package imports the reference's
PyTorch checkpoints (``pretrained.py import_torch_*``: LeNet-5, AlexNet,
VGG, MobileNet V1, Inception V1) the port's ``state_dict`` is that
layout, so a dense layer that reads a flattened map is permuted between
flax's NHWC flatten and the port's NCHW one.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

STAGE_SIZES = {
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet152": (3, 8, 36, 3),
}
BLOCK_NAME = {
    "resnet34": "BasicBlock",
    "resnet50": "BottleneckBlock",
    "resnet152": "BottleneckBlock",
}
CONVS_PER_BLOCK = {"BasicBlock": 2, "BottleneckBlock": 3}


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict → ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def unflatten_tree(flat: Mapping) -> dict:
    """``{"a/b/c": leaf}`` → nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_npz(path: str) -> dict:
    """A ``--weights`` archive → the nested flax variables tree."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def save_npz(path: str, variables: Mapping) -> None:
    np.savez(path, **{k: _np(v) for k, v in
                      flatten_tree(variables).items()})


def _arch(arch, stage_sizes, block):
    if stage_sizes is None or block is None:
        if arch not in STAGE_SIZES:
            raise ValueError(f"unknown arch '{arch}'; have "
                             f"{sorted(STAGE_SIZES)}")
        stage_sizes = STAGE_SIZES[arch] if stage_sizes is None \
            else stage_sizes
        block = BLOCK_NAME[arch] if block is None else block
    if block not in CONVS_PER_BLOCK:
        raise ValueError(f"unknown block '{block}'; have "
                         f"{sorted(CONVS_PER_BLOCK)}")
    return tuple(stage_sizes), block


def _blocks(stage_sizes: Sequence[int], block: str):
    """(torch prefix, flax block name) for every block, in call order."""
    k = 0
    for stage, num_blocks in enumerate(stage_sizes, start=1):
        for i in range(num_blocks):
            yield f"layer{stage}.{i}", f"{block}_{k}"
            k += 1


def flax_to_torch(variables: Mapping, arch: str = "resnet50",
                  stage_sizes: Sequence[int] | None = None,
                  block: str | None = None) -> dict:
    """flax ResNet variables → torchvision-layout ``state_dict`` (numpy).

    Raises ``KeyError`` naming the missing flax path when the tree does
    not match the architecture."""
    stage_sizes, block = _arch(arch, stage_sizes, block)
    params, stats = variables["params"], variables.get("batch_stats", {})
    n_convs = CONVS_PER_BLOCK[block]
    sd: dict = {}

    def conv(torch_key, p):
        sd[f"{torch_key}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)

    def bn(torch_prefix, p, s):
        sd[f"{torch_prefix}.weight"] = _np(p["scale"])
        sd[f"{torch_prefix}.bias"] = _np(p["bias"])
        sd[f"{torch_prefix}.running_mean"] = _np(s["mean"])
        sd[f"{torch_prefix}.running_var"] = _np(s["var"])
        sd[f"{torch_prefix}.num_batches_tracked"] = np.array(0, np.int64)

    conv("conv1", params["Conv_0"])
    bn("bn1", params["BatchNorm_0"], stats["BatchNorm_0"])
    for t, name in _blocks(stage_sizes, block):
        p, s = params[name], stats[name]
        for j in range(n_convs):
            conv(f"{t}.conv{j + 1}", p[f"Conv_{j}"])
            bn(f"{t}.bn{j + 1}", p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
        if f"Conv_{n_convs}" in p:
            conv(f"{t}.downsample.0", p[f"Conv_{n_convs}"])
            bn(f"{t}.downsample.1", p[f"BatchNorm_{n_convs}"],
               s[f"BatchNorm_{n_convs}"])
    sd["fc.weight"] = _np(params["Dense_0"]["kernel"]).T
    sd["fc.bias"] = _np(params["Dense_0"]["bias"])
    return {k: np.array(v, order="C") for k, v in sd.items()}


def import_torch_resnet(state_dict: Mapping, arch: str = "resnet50",
                        include_fc: bool = True,
                        stage_sizes: Sequence[int] | None = None,
                        block: str | None = None) -> dict:
    """torchvision-style ``state_dict`` → ``{"params", "batch_stats"}``
    flax variables.  ``include_fc=False`` drops the classifier head."""
    stage_sizes, block = _arch(arch, stage_sizes, block)
    sd = state_dict
    n_convs = CONVS_PER_BLOCK[block]

    def conv(torch_key):
        return {"kernel": _np(sd[f"{torch_key}.weight"]).transpose(2, 3, 1, 0)}

    def bn(torch_prefix, flax_parent, stats_parent, flax_name):
        flax_parent[flax_name] = {"scale": _np(sd[f"{torch_prefix}.weight"]),
                                  "bias": _np(sd[f"{torch_prefix}.bias"])}
        stats_parent[flax_name] = {
            "mean": _np(sd[f"{torch_prefix}.running_mean"]),
            "var": _np(sd[f"{torch_prefix}.running_var"])}

    params: dict = {"Conv_0": conv("conv1")}
    stats: dict = {}
    bn("bn1", params, stats, "BatchNorm_0")
    for t, name in _blocks(stage_sizes, block):
        p: dict = {}
        s: dict = {}
        for j in range(n_convs):
            p[f"Conv_{j}"] = conv(f"{t}.conv{j + 1}")
            bn(f"{t}.bn{j + 1}", p, s, f"BatchNorm_{j}")
        if f"{t}.downsample.0.weight" in sd:
            p[f"Conv_{n_convs}"] = conv(f"{t}.downsample.0")
            bn(f"{t}.downsample.1", p, s, f"BatchNorm_{n_convs}")
        params[name] = p
        stats[name] = s
    if include_fc:
        params["Dense_0"] = {"kernel": _np(sd["fc.weight"]).T,
                             "bias": _np(sd["fc.bias"])}
    return {"params": params, "batch_stats": stats}


def load_into(model, variables: Mapping) -> None:
    """Copy flax ``variables`` into a port ResNet (strict key match)."""
    import torch

    block = model.block_cls.__name__
    sd = flax_to_torch(variables, stage_sizes=model.stage_sizes, block=block)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


# ---------------------------------------------------------------------------
# YOLOv3 (models/yolo.py)
# ---------------------------------------------------------------------------

#: the port's neck/head modules and the flax names of the same modules
#: under ``YoloV3`` (created in this order by the reference's forward)
YOLO_NECK = (("block13", "YoloConvBlock_0"), ("head13", "YoloHead_0"),
             ("lateral26", "DarknetConv_0"), ("block26", "YoloConvBlock_1"),
             ("head26", "YoloHead_1"), ("lateral52", "DarknetConv_1"),
             ("block52", "YoloConvBlock_2"), ("head52", "YoloHead_2"))


def _yolo_darknet_convs(blocks: Sequence[int]):
    """(torch prefix, flax path) of every DarknetConv of a YoloV3, in the
    reference's call order.  Flax counts ``DarknetConv_k`` and
    ``DarknetResidual_k`` separately within each parent module."""
    bb = "Darknet53_0"
    yield "backbone.stem", (bb, "DarknetConv_0")
    r = 0
    for k, n in enumerate(blocks):
        yield f"backbone.stages.{k}.0", (bb, f"DarknetConv_{k + 1}")
        for i in range(n):
            res = (bb, f"DarknetResidual_{r}")
            yield f"backbone.stages.{k}.{i + 1}.conv1", \
                (*res, "DarknetConv_0")
            yield f"backbone.stages.{k}.{i + 1}.conv2", \
                (*res, "DarknetConv_1")
            r += 1
    for t, f in YOLO_NECK:
        if t.startswith("block"):
            for i in range(5):
                yield f"{t}.convs.{i}", (f, f"DarknetConv_{i}")
        elif t.startswith("head"):
            yield f"{t}.conv", (f, "DarknetConv_0")
        else:
            yield t, (f,)


def _get(tree: Mapping, path: Sequence[str]):
    for p in path:
        tree = tree[p]
    return tree


def _put(tree: dict, path: Sequence[str], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def yolo_from_flax(variables: Mapping,
                   blocks: Sequence[int] = (1, 2, 8, 8, 4)) -> dict:
    """flax YoloV3 variables (``{"params", "batch_stats"}``, numpy) → the
    port's ``state_dict`` (numpy): conv kernels HWIO → OIHW, BatchNorm
    scale/bias/mean/var → weight/bias/running_mean/running_var, the
    heads' 1×1 conv kernel and bias.  Raises ``KeyError`` naming the
    missing flax key when the tree does not match ``blocks``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    for t, path in _yolo_darknet_convs(tuple(blocks)):
        p, s = _get(params, path), _get(stats, path)
        sd[f"{t}.conv.weight"] = _np(p["Conv_0"]["kernel"]).transpose(
            3, 2, 0, 1)
        sd[f"{t}.bn.weight"] = _np(p["BatchNorm_0"]["scale"])
        sd[f"{t}.bn.bias"] = _np(p["BatchNorm_0"]["bias"])
        sd[f"{t}.bn.running_mean"] = _np(s["BatchNorm_0"]["mean"])
        sd[f"{t}.bn.running_var"] = _np(s["BatchNorm_0"]["var"])
        sd[f"{t}.bn.num_batches_tracked"] = np.array(0, np.int64)
    for t, f in YOLO_NECK:
        if t.startswith("head"):
            out = params[f]["Conv_0"]
            sd[f"{t}.out.weight"] = _np(out["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{t}.out.bias"] = _np(out["bias"])
    return {k: np.array(v, order="C") for k, v in sd.items()}


def yolo_to_flax(state_dict: Mapping,
                 blocks: Sequence[int] = (1, 2, 8, 8, 4)) -> dict:
    """The port's YoloV3 ``state_dict`` → flax ``{"params",
    "batch_stats"}`` (numpy): the inverse of :func:`yolo_from_flax`."""
    sd = state_dict
    params: dict = {}
    stats: dict = {}
    for t, path in _yolo_darknet_convs(tuple(blocks)):
        _put(params, (*path, "Conv_0", "kernel"),
             _np(sd[f"{t}.conv.weight"]).transpose(2, 3, 1, 0))
        _put(params, (*path, "BatchNorm_0"),
             {"scale": _np(sd[f"{t}.bn.weight"]),
              "bias": _np(sd[f"{t}.bn.bias"])})
        _put(stats, (*path, "BatchNorm_0"),
             {"mean": _np(sd[f"{t}.bn.running_mean"]),
              "var": _np(sd[f"{t}.bn.running_var"])})
    for t, f in YOLO_NECK:
        if t.startswith("head"):
            _put(params, (f, "Conv_0"),
                 {"kernel": _np(sd[f"{t}.out.weight"]).transpose(2, 3, 1, 0),
                  "bias": _np(sd[f"{t}.out.bias"])})
    return {"params": params, "batch_stats": stats}


def load_yolo(model, variables: Mapping) -> None:
    """Copy flax YoloV3 ``variables`` into a port ``YoloV3`` (strict)."""
    import torch

    sd = yolo_from_flax(variables, model.blocks)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


# ---------------------------------------------------------------------------
# Hourglass modules and CenterNet (models/hourglass.py, models/centernet.py)
# ---------------------------------------------------------------------------
# Every conv of these models has a bias.  Flax names submodules by class
# and call order: a PreActBottleneck holds ``Conv_0`` (the 1×1 shortcut,
# first, where the channel count changes), then the three convs, and
# ``BatchNorm_0..2``; a HourglassModule counts ``PreActBottleneck_k``
# over up1, low1, low2 (order 1 only) and low3, and holds the next order
# as ``HourglassModule_0``.  The walkers below yield ``(kind, torch
# prefix, flax path)`` for every conv and BatchNorm, in that order.


def _at(t: str, name: str) -> str:
    return f"{t}.{name}" if t else name


def _preact_leaves(t: str, f: tuple, shortcut: bool):
    k = 0
    if shortcut:
        yield "conv", _at(t, "shortcut"), (*f, "Conv_0")
        k = 1
    for j in range(3):
        yield "conv", _at(t, f"conv{j + 1}"), (*f, f"Conv_{j + k}")
    for j in range(3):
        yield "bn", _at(t, f"bn{j + 1}"), (*f, f"BatchNorm_{j}")


def _hourglass_leaves(t: str, f: tuple, in_ch: int, order: int, filters,
                      num_residual: int = 1):
    from deep_vision_tpu_torch.models.hourglass import filters_at

    fa, fb = filters_at(filters, 0), filters_at(filters, 1)
    counter = [0]

    def chain(name, n, cin, cout):
        for j in range(n):
            c = cin if j == 0 else cout
            yield from _preact_leaves(
                _at(t, f"{name}.{j}"),
                (*f, f"PreActBottleneck_{counter[0]}"), c != cout)
            counter[0] += 1

    yield from chain("up1", num_residual + 1, in_ch, fa)
    yield from chain("low1", num_residual, in_ch, fb)
    low1_out = fb if num_residual else in_ch
    if order > 1:
        sub = filters if isinstance(filters, int) else list(filters[1:])
        yield from _hourglass_leaves(_at(t, "sub"),
                                     (*f, "HourglassModule_0"), low1_out,
                                     order - 1, sub, num_residual)
        low2_out = filters_at(sub, 0)
    else:
        yield from chain("low2", num_residual, low1_out, fb)
        low2_out = fb if num_residual else low1_out
    yield from chain("low3", num_residual, low2_out, fa)


def _centernet_leaves(num_stack: int, order: int, filters):
    base = filters[0]
    yield "conv", "stem_conv", ("Conv_0",)
    yield "bn", "stem_bn", ("BatchNorm_0",)
    yield from _preact_leaves("stem_block", ("PreActBottleneck_0",),
                              base // 2 != base)
    for s in range(num_stack):
        t = f"stacks.{s}"
        yield from _hourglass_leaves(f"{t}.hourglass",
                                     (f"HourglassModule_{s}",), base, order,
                                     list(filters))
        yield "conv", f"{t}.conv", (f"Conv_{1 + 2 * s}",)
        yield "bn", f"{t}.bn", (f"BatchNorm_{1 + s}",)
        for j, head in enumerate(("heat", "wh", "offset")):
            d = (f"DetectionHead_{3 * s + j}",)
            yield "conv", f"{t}.{head}.conv", (*d, "Conv_0")
            yield "conv", f"{t}.{head}.out", (*d, "Conv_1")
        if s < num_stack - 1:
            yield "conv", f"{t}.reinject", (f"Conv_{2 + 2 * s}",)


def _stacked_hourglass_leaves(num_stack: int, num_heatmap: int,
                              filters: int, num_residual: int, order: int):
    yield "conv", "stem_conv", ("Conv_0",)
    yield "bn", "stem_bn", ("BatchNorm_0",)
    for j, (cin, cout) in enumerate(((64, 128), (128, 128),
                                     (128, filters))):
        yield from _preact_leaves(f"stem_block{j + 1}",
                                  (f"PreActBottleneck_{j}",), cin != cout)
    for s in range(num_stack):
        t = f"stacks.{s}"
        yield from _hourglass_leaves(f"{t}.hourglass",
                                     (f"HourglassModule_{s}",), filters,
                                     order, filters, num_residual)
        for j in range(num_residual):
            yield from _preact_leaves(
                f"{t}.residual.{j}",
                (f"PreActBottleneck_{3 + s * num_residual + j}",), False)
        base = 1 + 4 * s
        yield "conv", f"{t}.linear", (f"Conv_{base}",)
        yield "bn", f"{t}.bn", (f"BatchNorm_{1 + s}",)
        yield "conv", f"{t}.heat", (f"Conv_{base + 1}",)
        if s < num_stack - 1:
            yield "conv", f"{t}.reinject_features", (f"Conv_{base + 2}",)
            yield "conv", f"{t}.reinject_heat", (f"Conv_{base + 3}",)


# The pipeline split (parallel/pipelined.py): the reference's pipelined
# model keeps its stem's tree as the monolithic stem's (``Conv_0``,
# ``BatchNorm_0``, ``PreActBottleneck_k``) and one stage's tree, every
# leaf stacked on a leading stage axis, as a HourglassStack or
# CenterNetStack names it (the stack's own ``Conv_k`` counting from 0,
# re-injection included).

def hourglass_stem_leaves(t: str, filters: int):
    yield "conv", f"{t}.conv", ("Conv_0",)
    yield "bn", f"{t}.bn", ("BatchNorm_0",)
    for j, (cin, cout) in enumerate(((64, 128), (128, 128),
                                     (128, filters))):
        yield from _preact_leaves(f"{t}.block{j + 1}",
                                  (f"PreActBottleneck_{j}",), cin != cout)


def hourglass_stage_leaves(t: str, num_heatmap: int, filters: int,
                           num_residual: int, order: int):
    yield from _hourglass_leaves(f"{t}.hourglass", ("HourglassModule_0",),
                                 filters, order, filters, num_residual)
    for j in range(num_residual):
        yield from _preact_leaves(f"{t}.residual.{j}",
                                  (f"PreActBottleneck_{j}",), False)
    yield "conv", f"{t}.linear", ("Conv_0",)
    yield "bn", f"{t}.bn", ("BatchNorm_0",)
    yield "conv", f"{t}.heat", ("Conv_1",)
    yield "conv", f"{t}.reinject_features", ("Conv_2",)
    yield "conv", f"{t}.reinject_heat", ("Conv_3",)


def centernet_stem_leaves(t: str, filters):
    base = filters[0]
    yield "conv", f"{t}.conv", ("Conv_0",)
    yield "bn", f"{t}.bn", ("BatchNorm_0",)
    yield from _preact_leaves(f"{t}.block", ("PreActBottleneck_0",),
                              base // 2 != base)


def centernet_stage_leaves(t: str, num_classes: int, order: int, filters):
    del num_classes  # the heads' widths come from the tensors
    base = filters[0]
    yield from _hourglass_leaves(f"{t}.hourglass", ("HourglassModule_0",),
                                 base, order, list(filters))
    yield "conv", f"{t}.conv", ("Conv_0",)
    yield "bn", f"{t}.bn", ("BatchNorm_0",)
    for j, head in enumerate(("heat", "wh", "offset")):
        yield "conv", f"{t}.{head}.conv", (f"DetectionHead_{j}", "Conv_0")
        yield "conv", f"{t}.{head}.out", (f"DetectionHead_{j}", "Conv_1")
    yield "conv", f"{t}.reinject", ("Conv_1",)


def _pipelined_walkers(model):
    """(stem leaves, stage leaves of stage ``s``) of a PipelinedModel,
    from its family's walkers (``parallel/pipelined.families``)."""
    fam, arch = model.family, model.arch
    return (fam.flax_stem("stem", arch["filters"]),
            lambda s: fam.flax_stage(f"stages.{s}", **arch))


def pipelined_from_flax(variables: Mapping, model) -> dict:
    """The reference's pipelined flax tree (``params``/``batch_stats``
    → ``{"stem", "stages"}``, each stage leaf stacked on a leading axis
    of ``model.num_stages``) → the port's ``PipelinedModel``
    ``state_dict`` (numpy).  Strict: a missing leaf, a leaf no module
    takes, another top-level key or another stage count raises."""
    from deep_vision_tpu_torch.parallel.pipeline import unstack_stages

    params, stats = variables["params"], variables.get("batch_stats", {})
    for tree in (params, stats):
        if tree and set(tree) != {"stem", "stages"}:
            raise KeyError(f"a pipelined tree holds 'stem' and 'stages', "
                           f"not {sorted(tree)}")
    S = model.num_stages

    def stages(tree) -> list:
        flat = {k: np.asarray(a) for k, a in flatten_tree(tree).items()}
        for a in flat.values():
            if a.shape[:1] != (S,):
                raise ValueError(f"stage leaf of shape {a.shape}: expected "
                                 f"a leading stage axis of {S}")
        if not flat:
            return [{}] * S
        return [unflatten_tree(d) for d in unstack_stages(flat)]

    stem_leaves, stage_leaves = _pipelined_walkers(model)
    sd = _from_flax(stem_leaves, {"params": params["stem"],
                                  "batch_stats": stats.get("stem", {})})
    for s, (p, b) in enumerate(zip(stages(params["stages"]),
                                   stages(stats.get("stages", {})))):
        sd.update(_from_flax(stage_leaves(s),
                             {"params": p, "batch_stats": b}))
    return sd


def pipelined_to_flax(state_dict: Mapping, model) -> dict:
    """The inverse of :func:`pipelined_from_flax`."""
    from deep_vision_tpu_torch.parallel.pipeline import stack_stages

    stem_leaves, stage_leaves = _pipelined_walkers(model)
    stem = _to_flax(stem_leaves, state_dict)
    stages = [_to_flax(stage_leaves(s), state_dict)
              for s in range(model.num_stages)]
    return {col: {"stem": stem[col],
                  "stages": unflatten_tree(stack_stages(
                      [flatten_tree(st[col]) for st in stages]))}
            for col in ("params", "batch_stats")}


def load_pipelined(model, variables: Mapping) -> None:
    """Copy the reference's pipelined flax ``variables`` into a port
    ``PipelinedModel`` (strict both ways)."""
    import torch

    sd = pipelined_from_flax(variables, model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


def _flax_dense(w, chw) -> np.ndarray:
    """A port dense weight ``(O, I)`` → flax kernel ``(I, O)``; with
    ``chw = (C, H, W)`` the layer reads an NCHW flatten in the port and
    an NHWC one in flax, so the input axis is permuted (the JAX
    package's ``pretrained._linear``)."""
    w = _np(w)
    if chw is not None and chw[1] * chw[2] > 1:
        c, h, wd = chw
        return w.reshape(w.shape[0], c, h, wd).transpose(2, 3, 1, 0) \
            .reshape(h * wd * c, -1)
    return w.T


def _torch_dense(kernel, chw) -> np.ndarray:
    """The inverse of :func:`_flax_dense`."""
    k = _np(kernel)
    if chw is not None and chw[1] * chw[2] > 1:
        c, h, wd = chw
        return k.reshape(h, wd, c, -1).transpose(3, 2, 0, 1) \
            .reshape(k.shape[1], c * h * wd)
    return k.T


#: the flax leaves of each kind of walked module: "conv" (with a bias),
#: "convk" (kernel only; a flax ``ConvTranspose`` is one too, its port
#: weight in the same out-first layout), "dense" (kernel and bias; a
#: fourth tuple item is the (C, H, W) of the NCHW map it flattens, or
#: None), "densek" (kernel only) and "bn"
_KIND_LEAVES = {"conv": (("params", "kernel"), ("params", "bias")),
                "convk": (("params", "kernel"),),
                "dense": (("params", "kernel"), ("params", "bias")),
                "densek": (("params", "kernel"),),
                "bn": (("params", "scale"), ("params", "bias"),
                       ("batch_stats", "mean"), ("batch_stats", "var"))}


def _from_flax(leaves, variables: Mapping) -> dict:
    """flax variables → ``state_dict`` (numpy) over ``leaves``; a flax
    leaf that no module takes raises ``KeyError``, as a missing one
    does."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    used = set()
    for kind, t, path, *chw in leaves:
        p = _get(params, path)
        if kind in ("conv", "convk"):
            sd[f"{t}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
            if kind == "conv":
                sd[f"{t}.bias"] = _np(p["bias"])
        elif kind in ("dense", "densek"):
            sd[f"{t}.weight"] = _torch_dense(p["kernel"],
                                             chw[0] if chw else None)
            if kind == "dense":
                sd[f"{t}.bias"] = _np(p["bias"])
        else:
            s = _get(stats, path)
            sd[f"{t}.weight"] = _np(p["scale"])
            sd[f"{t}.bias"] = _np(p["bias"])
            sd[f"{t}.running_mean"] = _np(s["mean"])
            sd[f"{t}.running_var"] = _np(s["var"])
            sd[f"{t}.num_batches_tracked"] = np.array(0, np.int64)
        used.update((col, *path, leaf) for col, leaf in _KIND_LEAVES[kind])
    extra = sorted(k for col in ("params", "batch_stats")
                   for k in flatten_tree(variables.get(col, {}), col)
                   if tuple(k.split("/")) not in used)
    if extra:
        raise KeyError(f"flax leaves with no module: {extra[:5]}"
                       f"{' ...' if len(extra) > 5 else ''}")
    return {k: np.array(v, order="C") for k, v in sd.items()}


def _to_flax(leaves, state_dict: Mapping) -> dict:
    """The inverse of :func:`_from_flax`."""
    sd = state_dict
    params: dict = {}
    stats: dict = {}
    for kind, t, path, *chw in leaves:
        if kind in ("conv", "convk"):
            leaf = {"kernel": _np(sd[f"{t}.weight"]).transpose(2, 3, 1, 0)}
            if kind == "conv":
                leaf["bias"] = _np(sd[f"{t}.bias"])
            _put(params, path, leaf)
        elif kind in ("dense", "densek"):
            leaf = {"kernel": _flax_dense(sd[f"{t}.weight"],
                                          chw[0] if chw else None)}
            if kind == "dense":
                leaf["bias"] = _np(sd[f"{t}.bias"])
            _put(params, path, leaf)
        else:
            _put(params, path, {"scale": _np(sd[f"{t}.weight"]),
                                "bias": _np(sd[f"{t}.bias"])})
            _put(stats, path, {"mean": _np(sd[f"{t}.running_mean"]),
                               "var": _np(sd[f"{t}.running_var"])})
    return {"params": params, "batch_stats": stats}


def preact_from_flax(variables: Mapping, in_ch: int, filters: int) -> dict:
    """flax ``PreActBottleneck`` variables (its own tree at the root) →
    the port's ``PreActBottleneck`` ``state_dict`` (numpy)."""
    return _from_flax(_preact_leaves("", (), in_ch != filters), variables)


def preact_to_flax(state_dict: Mapping, in_ch: int, filters: int) -> dict:
    """The inverse of :func:`preact_from_flax`."""
    return _to_flax(_preact_leaves("", (), in_ch != filters), state_dict)


def hourglass_from_flax(variables: Mapping, in_ch: int, order: int,
                        filters, num_residual: int = 1) -> dict:
    """flax ``HourglassModule`` variables (its own tree at the root) →
    the port's ``HourglassModule`` ``state_dict`` (numpy)."""
    return _from_flax(_hourglass_leaves("", (), in_ch, order, filters,
                                        num_residual), variables)


def hourglass_to_flax(state_dict: Mapping, in_ch: int, order: int,
                      filters, num_residual: int = 1) -> dict:
    """The inverse of :func:`hourglass_from_flax`."""
    return _to_flax(_hourglass_leaves("", (), in_ch, order, filters,
                                      num_residual), state_dict)


def centernet_from_flax(variables: Mapping, num_stack: int = 2,
                        order: int = 5,
                        filters: Sequence[int] = (256, 256, 384, 384, 384,
                                                  512)) -> dict:
    """flax CenterNet variables → the port's ``state_dict`` (numpy).
    Raises ``KeyError`` naming a missing flax key, or the flax leaves
    that no module takes, when the tree does not match."""
    return _from_flax(_centernet_leaves(num_stack, order, tuple(filters)),
                      variables)


def centernet_to_flax(state_dict: Mapping, num_stack: int = 2,
                      order: int = 5,
                      filters: Sequence[int] = (256, 256, 384, 384, 384,
                                                512)) -> dict:
    """The port's CenterNet ``state_dict`` → flax ``{"params",
    "batch_stats"}`` (numpy): the inverse of :func:`centernet_from_flax`."""
    return _to_flax(_centernet_leaves(num_stack, order, tuple(filters)),
                    state_dict)


def load_centernet(model, variables: Mapping) -> None:
    """Copy flax CenterNet ``variables`` into a port ``CenterNet``
    (strict both ways)."""
    import torch

    sd = centernet_from_flax(variables, model.num_stack, model.order,
                             model.filters)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


def stacked_hourglass_from_flax(variables: Mapping, num_stack: int = 4,
                                num_heatmap: int = 16, filters: int = 256,
                                num_residual: int = 1, order: int = 4
                                ) -> dict:
    """flax ``StackedHourglass`` variables → the port's ``state_dict``
    (numpy).  Raises ``KeyError`` naming a missing flax key, or the flax
    leaves that no module takes, when the tree does not match."""
    return _from_flax(_stacked_hourglass_leaves(
        num_stack, num_heatmap, filters, num_residual, order), variables)


def stacked_hourglass_to_flax(state_dict: Mapping, num_stack: int = 4,
                              num_heatmap: int = 16, filters: int = 256,
                              num_residual: int = 1, order: int = 4) -> dict:
    """The inverse of :func:`stacked_hourglass_from_flax`."""
    return _to_flax(_stacked_hourglass_leaves(
        num_stack, num_heatmap, filters, num_residual, order), state_dict)


def load_stacked_hourglass(model, variables: Mapping) -> None:
    """Copy flax ``StackedHourglass`` ``variables`` into a port
    ``StackedHourglass`` (strict both ways)."""
    import torch

    sd = stacked_hourglass_from_flax(variables, model.num_stack,
                                     model.num_heatmap, model.filters,
                                     model.num_residual, model.order)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


# ---------------------------------------------------------------------------
# The classifier zoo (models/lenet.py, alexnet.py, vgg.py, inception.py,
# mobilenet.py, shufflenet.py, and ResNet-50 V2 in resnet.py)
# ---------------------------------------------------------------------------
# Flax names submodules by class and construction order; in
# ``conv(c3)(conv(c3r)(x))`` the outer conv is constructed before its
# argument runs, so each nested branch's outer conv takes the lower index.
# The walkers below yield ``(kind, torch prefix, flax path[, chw])`` for
# a port model, read off its modules.


def _convbn_leaves(t: str, f: tuple):
    yield "convk", f"{t}.conv", (*f, "Conv_0")
    yield "bn", f"{t}.bn", (*f, "BatchNorm_0")


def _basic_conv_leaves(module, t: str, f: tuple):
    """Inception's BasicConv: V1 a biased conv, V3 conv + BatchNorm."""
    if module.bn is None:
        yield "conv", f"{t}.conv", (*f, "Conv_0")
    else:
        yield from _convbn_leaves(t, f)


def _sequential_leaves(model):
    from deep_vision_tpu_torch.models.common import Conv2d, Linear

    last_out = None
    j = 0
    for i, m in enumerate(model.features):
        if isinstance(m, Conv2d):
            yield "conv", f"features.{i}", (f"Conv_{j}",)
            last_out, j = m.out_channels, j + 1
    j = 0
    for i, m in enumerate(model.classifier):
        if isinstance(m, Linear):
            chw = (last_out, *model.flatten_hw) if j == 0 else None
            yield "dense", f"classifier.{i}", (f"Dense_{j}",), chw
            j += 1


#: each V1 module branch and its flax index (construction order)
INCEPTION_V1_BRANCHES = (
    ("branch1_conv1x1", 0), ("branch2_conv3x3", 1), ("branch2_conv1x1", 2),
    ("branch3_conv5x5", 3), ("branch3_conv1x1", 4), ("branch4_conv1x1", 5))
INCEPTION_V1_MODULES = ("inception_3a", "inception_3b", "inception_4a",
                        "inception_4b", "inception_4c", "inception_4d",
                        "inception_4e", "inception_5a", "inception_5b")


def _inception_v1_leaves(model):
    for j, name in enumerate(("conv7x7", "conv1x1", "conv3x3")):
        yield "conv", f"{name}.conv", (f"BasicConv_{j}", "Conv_0")
    for m, mod in enumerate(INCEPTION_V1_MODULES):
        for attr, j in INCEPTION_V1_BRANCHES:
            yield "conv", f"{mod}.{attr}.conv", \
                (f"InceptionModule_{m}", f"BasicConv_{j}", "Conv_0")
    if model.aux_heads:
        for a, aux in enumerate(("aux1", "aux2")):
            f = f"AuxClassifier_{a}"
            head = getattr(model, aux)
            yield "conv", f"{aux}.features.1.conv", \
                (f, "BasicConv_0", "Conv_0")
            yield "dense", f"{aux}.classifier.0", (f, "Dense_0"), \
                (128, *head.flatten_hw)
            yield "dense", f"{aux}.classifier.3", (f, "Dense_1")
    yield "dense", "linear", ("Dense_0",)


#: each V3 block's branches in flax construction order, by class
INCEPTION_V3_BRANCHES = {
    "InceptionA": ("branch1x1", "branch5x5_2", "branch5x5_1",
                   "branch3x3dbl_3", "branch3x3dbl_2", "branch3x3dbl_1",
                   "branch_pool"),
    "ReductionA": ("branch3x3", "branch3x3dbl_3", "branch3x3dbl_2",
                   "branch3x3dbl_1"),
    "InceptionB": ("branch1x1", "branch7x7_3", "branch7x7_2", "branch7x7_1",
                   "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                   "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"),
    "ReductionB": ("branch3x3_2", "branch3x3_1", "branch7x7x3_1",
                   "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"),
    "InceptionC": ("branch1x1", "branch3x3_1", "branch3x3_2a",
                   "branch3x3_2b", "branch3x3dbl_2", "branch3x3dbl_1",
                   "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"),
}
INCEPTION_V3_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
                     "Conv2d_3b_1x1", "Conv2d_4a_3x3")
INCEPTION_V3_BLOCKS = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                       "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                       "Mixed_7a", "Mixed_7b", "Mixed_7c")


def _inception_v3_leaves(model):
    for j, name in enumerate(INCEPTION_V3_STEM):
        yield from _convbn_leaves(name, (f"BasicConv_{j}",))
    seen: dict = {}
    for name in INCEPTION_V3_BLOCKS:
        block = getattr(model, name)
        cls = type(block).__name__
        f = f"{cls}_{seen.get(cls, 0)}"
        seen[cls] = seen.get(cls, 0) + 1
        for j, attr in enumerate(INCEPTION_V3_BRANCHES[cls]):
            yield from _convbn_leaves(f"{name}.{attr}",
                                      (f, f"BasicConv_{j}"))
    dense = 0
    if model.aux_heads:
        yield from _convbn_leaves("AuxLogits.conv0", ("BasicConv_5",))
        yield from _convbn_leaves("AuxLogits.conv1", ("BasicConv_6",))
        yield "dense", "AuxLogits.fc", ("Dense_0",)
        dense = 1
    yield "dense", "fc", (f"Dense_{dense}",)


def _mobilenet_leaves(model):
    yield "convk", "features.0", ("ConvBN_0", "Conv_0")
    yield "bn", "features.1", ("ConvBN_0", "BatchNorm_0")
    for k in range(len(model.features) - 3):
        f = f"DepthwiseSeparable_{k}"
        yield from _convbn_leaves(f"features.{k + 3}.dw", (f, "ConvBN_0"))
        yield from _convbn_leaves(f"features.{k + 3}.pw", (f, "ConvBN_1"))
    yield "dense", "linear", ("Dense_0",)


def _shufflenet_leaves(model):
    yield from _convbn_leaves("stem", ("ConvBN_0",))
    k = 0
    for s, stage in enumerate(model.stages):
        for i in range(len(stage)):
            for j, part in enumerate(("gconv1", "dwconv", "gconv2")):
                yield from _convbn_leaves(f"stages.{s}.{i}.{part}",
                                          (f"ShuffleUnit_{k}", f"ConvBN_{j}"))
            k += 1
    yield "dense", "fc", ("Dense_0",)


def _preact_resnet_leaves(model):
    yield "convk", "conv1", ("Conv_0",)
    k = 0
    for s, stage in enumerate(model.stages(), start=1):
        for i, block in enumerate(stage):
            f = f"{type(block).__name__}_{k}"
            shift = 0
            if block.downsample is not None:
                yield "convk", f"layer{s}.{i}.downsample", (f, "Conv_0")
                shift = 1
            for j in range(3):
                yield "convk", f"layer{s}.{i}.conv{j + 1}", \
                    (f, f"Conv_{j + shift}")
                yield "bn", f"layer{s}.{i}.bn{j + 1}", (f, f"BatchNorm_{j}")
            k += 1
    yield "bn", "post_bn", ("BatchNorm_0",)
    yield "dense", "fc", ("Dense_0",)


def classifier_leaves(model):
    """The walker of ``model``'s family (the zoo beyond ResNet V1)."""
    from deep_vision_tpu_torch.models.common import SequentialClassifier
    from deep_vision_tpu_torch.models.inception import (
        InceptionV1,
        InceptionV3,
    )
    from deep_vision_tpu_torch.models.mobilenet import MobileNetV1
    from deep_vision_tpu_torch.models.resnet import ResNet
    from deep_vision_tpu_torch.models.shufflenet import ShuffleNetV1

    walkers = ((SequentialClassifier, _sequential_leaves),
               (InceptionV1, _inception_v1_leaves),
               (InceptionV3, _inception_v3_leaves),
               (MobileNetV1, _mobilenet_leaves),
               (ShuffleNetV1, _shufflenet_leaves))
    if isinstance(model, ResNet) and model.preact:
        return list(_preact_resnet_leaves(model))
    for cls, walk in walkers:
        if isinstance(model, cls):
            return list(walk(model))
    raise TypeError(f"no classifier layout for {type(model).__name__}")


def classifier_from_flax(variables: Mapping, model) -> dict:
    """flax variables of the reference's counterpart of ``model`` (LeNet-5
    and its tiers, AlexNet, VGG, Inception V1/V3, MobileNet V1,
    ShuffleNet V1, ResNet-50 V2) → ``model``'s ``state_dict`` (numpy);
    strict both ways.  Dense layers that read a flattened map are
    permuted from flax's NHWC flatten to the port's NCHW one."""
    return _from_flax(classifier_leaves(model), variables)


def classifier_to_flax(state_dict: Mapping, model) -> dict:
    """The inverse of :func:`classifier_from_flax`."""
    return _to_flax(classifier_leaves(model), state_dict)


def load_classifier(model, variables: Mapping) -> None:
    """Copy flax ``variables`` into a zoo ``model`` (strict both ways)."""
    import torch

    sd = classifier_from_flax(variables, model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


# ---------------------------------------------------------------------------
# The GAN family (models/gan.py)
# ---------------------------------------------------------------------------
# The port's modules reshape and flatten in the reference's NHWC order
# (DCGAN's Dense → (7, 7, 256) and its discriminator's (7, 7, 128) →
# Dense), so no kernel is permuted; a flax ``ConvTranspose`` kernel
# (kH, kW, I, O) maps like a conv kernel to the port's (O, I, kH, kW).


def _dcgan_generator_leaves(model):
    yield "densek", "fc", ("Dense_0",)
    yield "bn", "fc_bn", ("BatchNorm_0",)
    for j in range(3):
        yield "convk", f"deconv{j + 1}", (f"ConvTranspose_{j}",)
        if j < 2:
            yield "bn", f"bn{j + 1}", (f"BatchNorm_{j + 1}",)


def _dcgan_discriminator_leaves(model):
    yield "conv", "conv1", ("Conv_0",)
    yield "conv", "conv2", ("Conv_1",)
    yield "dense", "fc", ("Dense_0",)


def _cyclegan_generator_leaves(model):
    for j, (conv, bn) in enumerate((("conv_in", "bn_in"),
                                    ("down1", "bn_down1"),
                                    ("down2", "bn_down2"))):
        yield "convk", conv, (f"Conv_{j}",)
        yield "bn", bn, (f"BatchNorm_{j}",)
    for k in range(model.n_blocks):
        f = f"ResNetBlock_{k}"
        for j in range(2):
            yield "convk", f"blocks.{k}.conv{j + 1}", (f, f"Conv_{j}")
            yield "bn", f"blocks.{k}.bn{j + 1}", (f, f"BatchNorm_{j}")
    for j in range(2):
        yield "convk", f"up{j + 1}", (f"ConvTranspose_{j}",)
        yield "bn", f"bn_up{j + 1}", (f"BatchNorm_{3 + j}",)
    yield "conv", "conv_out", ("Conv_3",)


def _patchgan_leaves(model):
    yield "conv", "conv1", ("Conv_0",)
    for j in range(3):
        yield "convk", f"conv{j + 2}", (f"Conv_{j + 1}",)
        yield "bn", f"bn{j + 2}", (f"BatchNorm_{j}",)
    yield "conv", "conv_out", ("Conv_4",)


def gan_leaves(model):
    """The walker of ``model``'s GAN network."""
    from deep_vision_tpu_torch.models import gan

    walkers = ((gan.DCGANGenerator, _dcgan_generator_leaves),
               (gan.DCGANDiscriminator, _dcgan_discriminator_leaves),
               (gan.CycleGANGenerator, _cyclegan_generator_leaves),
               (gan.PatchGANDiscriminator, _patchgan_leaves))
    for cls, walk in walkers:
        if isinstance(model, cls):
            return list(walk(model))
    raise TypeError(f"no GAN layout for {type(model).__name__}")


def gan_from_flax(variables: Mapping, model) -> dict:
    """flax variables of the reference's ``DCGANGenerator``,
    ``DCGANDiscriminator``, ``CycleGANGenerator`` or
    ``PatchGANDiscriminator`` → ``model``'s ``state_dict`` (numpy);
    strict both ways."""
    return _from_flax(gan_leaves(model), variables)


def gan_to_flax(state_dict: Mapping, model) -> dict:
    """The inverse of :func:`gan_from_flax`."""
    return _to_flax(gan_leaves(model), state_dict)


def load_gan(model, variables: Mapping) -> None:
    """Copy flax ``variables`` into a GAN ``model`` (strict both ways)."""
    import torch

    sd = gan_from_flax(variables, model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


# ---------------------------------------------------------------------------
# Any family: the flax tree and the flax path of each tensor
# ---------------------------------------------------------------------------


def to_flax(model, state_dict: Mapping | None = None) -> dict:
    """``model``'s weights (or ``state_dict`` in its layout) as the flax
    ``{"params", "batch_stats"}`` tree (numpy) of its family, through
    that family's strict ``*_to_flax`` converter: the inverse of
    ``core.restore.import_weights``."""
    from deep_vision_tpu_torch.models.centernet import CenterNet
    from deep_vision_tpu_torch.models.common import Classifier
    from deep_vision_tpu_torch.models.gan import GANModel
    from deep_vision_tpu_torch.models.hourglass import StackedHourglass
    from deep_vision_tpu_torch.models.resnet import ResNet
    from deep_vision_tpu_torch.models.yolo import YoloV3
    from deep_vision_tpu_torch.parallel.pipelined import PipelinedModel

    sd = model.state_dict() if state_dict is None else state_dict
    if isinstance(model, PipelinedModel):
        return pipelined_to_flax(sd, model)
    if isinstance(model, ResNet) and not model.preact:
        return import_torch_resnet(sd, stage_sizes=model.stage_sizes,
                                   block=model.block_cls.__name__)
    if isinstance(model, Classifier):
        return classifier_to_flax(sd, model)
    if isinstance(model, YoloV3):
        return yolo_to_flax(sd, model.blocks)
    if isinstance(model, CenterNet):
        return centernet_to_flax(sd, model.num_stack, model.order,
                                 model.filters)
    if isinstance(model, StackedHourglass):
        return stacked_hourglass_to_flax(sd, model.num_stack,
                                         model.num_heatmap, model.filters,
                                         model.num_residual, model.order)
    if isinstance(model, GANModel):
        return gan_to_flax(sd, model)
    raise TypeError(f"no flax layout for {type(model).__name__}")


def flax_leaf_map(model) -> dict:
    """``state_dict`` key → flax path (``params/Dense_0/kernel``) of every
    tensor of ``model`` that the reference's tree holds, read off the
    family's converter (:func:`to_flax`) run on tagged tensors: tensor
    ``i`` becomes the constant ``i`` (a zero-stride view, so a full-width
    model costs nothing), and each flax leaf names the one tensor it was
    made from.  An int8 model's ``weight_scale`` is the reference's
    ``param_scales/<path>/kernel``; ``num_batches_tracked`` has no
    counterpart.  A converter that mixes tensors raises."""
    sd = model.state_dict()
    # the map depends on the tensors' names and shapes only: kept on the
    # model for the next call while they stay the same
    sig = tuple((k, tuple(t.shape)) for k, t in sd.items())
    memo = model.__dict__.get("_flax_leaf_map")
    if memo is not None and memo[0] == sig:
        return dict(memo[1])
    keys = [k for k, t in sd.items()
            if not k.endswith((".weight_scale", ".num_batches_tracked"))]
    tags = {k: np.broadcast_to(np.float32(i), tuple(sd[k].shape))
            for i, k in enumerate(keys)}
    out: dict = {}
    for path, leaf in flatten_tree(to_flax(model, tags)).items():
        leaf = np.asarray(leaf)
        i = int(leaf.flat[0]) if leaf.size else -1
        if leaf.size == 0 or leaf.min() != leaf.max() or \
                not 0 <= i < len(keys) or keys[i] in out:
            raise ValueError(f"flax leaf '{path}' is not one tensor of "
                             f"{type(model).__name__}")
        out[keys[i]] = path
    for k in sd:
        if k.endswith(".weight_scale"):
            w = k[:-len("_scale")]
            if w in out and out[w].startswith("params/"):
                out[k] = "param_scales/" + out[w][len("params/"):]
    model.__dict__["_flax_leaf_map"] = (sig, dict(out))
    return out
