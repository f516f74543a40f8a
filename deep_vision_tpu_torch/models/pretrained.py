"""Pretrained-weight import: torch-format checkpoints → the port's models,
for every architecture the reference publishes an accuracy number for.

Port of ``deep_vision_tpu/models/pretrained.py``.  The reference maps a
torch ``state_dict`` (torchvision-style ResNet: ``conv1/bn1/
layer{1..4}.{i}.conv{j}/bn{j}/downsample/fc``, and the reference's own
sequential and module layouts for AlexNet, VGG, LeNet-5, MobileNet V1
and Inception V1) into flax variables.  The port's ``state_dict`` *is*
those layouts, so an importer here selects the same checkpoint entries
the reference's importer reads and names the model entry each one
fills; no tensor is transposed or permuted.  A sequential network's
layers are matched in order, so torchvision's AlexNet and VGG numbering
imports as the reference's does.

Semantics kept from the reference:

- ``load_state_dict``: ``torch.load(weights_only=True)``, the
  ``{"state_dict": ...}`` wrapper unwrapped and ``module.`` prefixes
  stripped;
- entries the importers never read are ignored (torchvision's
  ``num_batches_tracked`` among them), and a model entry the checkpoint
  does not fill keeps its fresh init;
- an entry the importer reads but the checkpoint lacks raises
  ``KeyError``, as one the model lacks does; a shape mismatch raises
  ``ValueError``;
- ``import_pretrained`` keeps the class head only when its shape fits,
  and otherwise imports again without it (``head_kept`` False).
"""

from __future__ import annotations

from typing import Mapping

import torch

STAGE_SIZES = {
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet152": (3, 8, 36, 3),
}
CONVS_PER_BLOCK = {"resnet34": 2, "resnet50": 3, "resnet152": 3}
_BN = ("weight", "bias", "running_mean", "running_var")


def _take(sd: Mapping, out: dict, key: str, model_key: str | None = None
          ) -> None:
    """``out[model_key] = sd[key]`` (``KeyError`` naming ``key`` when the
    checkpoint lacks it)."""
    out[model_key or key] = sd[key]


def _bn(sd: Mapping, out: dict, prefix: str, model_prefix: str | None = None
        ) -> None:
    for leaf in _BN:
        _take(sd, out, f"{prefix}.{leaf}",
              f"{model_prefix or prefix}.{leaf}")


def import_torch_resnet(state_dict: Mapping, arch: str = "resnet50",
                        include_fc: bool = True) -> dict:
    """torchvision-style ResNet ``state_dict`` → the entries of the
    port's ``models/resnet.ResNet`` it fills (the same keys).
    ``include_fc=False`` leaves the classifier head out."""
    if arch not in STAGE_SIZES:
        raise ValueError(f"unknown arch '{arch}'; have {sorted(STAGE_SIZES)}")
    sd, out = state_dict, {}
    _take(sd, out, "conv1.weight")
    _bn(sd, out, "bn1")
    for stage, num_blocks in enumerate(STAGE_SIZES[arch], start=1):
        for i in range(num_blocks):
            t = f"layer{stage}.{i}"
            for j in range(1, CONVS_PER_BLOCK[arch] + 1):
                _take(sd, out, f"{t}.conv{j}.weight")
                _bn(sd, out, f"{t}.bn{j}")
            if f"{t}.downsample.0.weight" in sd:
                _take(sd, out, f"{t}.downsample.0.weight")
                _bn(sd, out, f"{t}.downsample.1")
    if include_fc:
        _take(sd, out, "fc.weight")
        _take(sd, out, "fc.bias")
    return out


def _seq_indices(sd: Mapping, prefix: str, ndim: int) -> list:
    """Sorted module indices under ``prefix.N.weight`` with ``ndim``-D
    weights (4 = conv, 2 = linear), whatever modules sit between them."""
    out = []
    for k, v in sd.items():
        parts = k.split(".")
        if (len(parts) == 3 and parts[0] == prefix and parts[2] == "weight"
                and parts[1].isdigit() and v.ndim == ndim):
            out.append(int(parts[1]))
    return sorted(out)


def import_torch_sequential(state_dict: Mapping, model_sd: Mapping,
                            include_fc: bool = True,
                            features: str = "features",
                            classifier: str = "classifier") -> dict:
    """The plain-sequential CNNs (``features`` convs + ``classifier``
    linears: AlexNet V1/V2, VGG-16/19, LeNet-5, and torchvision's
    AlexNet/VGG, numbered differently): the checkpoint's j-th conv and
    linear fill the model's j-th (``model_sd`` names them; one the model
    lacks raises ``KeyError``).  The port flattens NCHW, as torch does,
    so the first linear needs no permutation.  ``include_fc=False``
    leaves the last linear (the class head) out."""
    sd = state_dict
    conv_idx = _seq_indices(sd, features, 4)
    fc_idx = _seq_indices(sd, classifier, 2)
    if not conv_idx or not fc_idx:
        raise ValueError(
            f"no '{features}.N.weight' convs / '{classifier}.N.weight' "
            "linears found — not a sequential-CNN checkpoint")
    if any(k.startswith(f"{features}.") and k.endswith(".running_mean")
           for k in sd):
        # a BN variant (e.g. torchvision vgg16_bn) would import its convs
        # and silently drop every BN; refuse instead
        raise ValueError(
            "checkpoint carries BatchNorm stats — the zoo's sequential "
            "models (AlexNet/VGG/LeNet) are BN-free; use the plain "
            "(non-_bn) checkpoint variant")
    if not include_fc:
        fc_idx = fc_idx[:-1]
    out: dict = {}
    for prefix, idx, ndim in ((features, conv_idx, 4),
                              (classifier, fc_idx, 2)):
        slots = _seq_indices(model_sd, prefix, ndim)
        for j, i in enumerate(idx):
            if j >= len(slots):
                raise KeyError(f"checkpoint key '{prefix}.{i}.weight' "
                               f"not in model (it has {len(slots)})")
            _take(sd, out, f"{prefix}.{i}.weight",
                  f"{prefix}.{slots[j]}.weight")
            if f"{prefix}.{i}.bias" in sd or prefix == classifier:
                _take(sd, out, f"{prefix}.{i}.bias",
                      f"{prefix}.{slots[j]}.bias")
    return out


def import_torch_alexnet(state_dict: Mapping, model_sd: Mapping,
                         include_fc: bool = True) -> dict:
    """AlexNet V1/V2 (one Sequential layout, widths differ)."""
    n = len(_seq_indices(state_dict, "features", 4))
    if n != 5:
        raise ValueError(f"AlexNet has 5 convs; checkpoint has {n}")
    return import_torch_sequential(state_dict, model_sd, include_fc)


def import_torch_vgg(state_dict: Mapping, model_sd: Mapping,
                     include_fc: bool = True) -> dict:
    """VGG-16/19."""
    n = len(_seq_indices(state_dict, "features", 4))
    if n not in (13, 16):
        raise ValueError(f"VGG-16/19 has 13/16 convs; checkpoint has {n}")
    return import_torch_sequential(state_dict, model_sd, include_fc)


def import_torch_lenet5(state_dict: Mapping, model_sd: Mapping,
                        include_fc: bool = True) -> dict:
    """LeNet-5."""
    n = len(_seq_indices(state_dict, "features", 4))
    if n != 3:
        raise ValueError(f"LeNet-5 has 3 convs; checkpoint has {n}")
    return import_torch_sequential(state_dict, model_sd, include_fc)


def import_torch_mobilenet_v1(state_dict: Mapping, model_sd: Mapping,
                              include_fc: bool = True) -> dict:
    """The reference's MobileNet V1 layout (``features.0/1`` stem conv
    and BN, ``features.3..15`` depthwise-separable blocks each
    ``{dw,pw}.{conv,bn}``, ``linear``)."""
    sd, out = state_dict, {}
    if "features.0.weight" not in sd or "features.3.dw.conv.weight" not in sd:
        raise ValueError("not a reference-layout MobileNet V1 checkpoint "
                         "(expects features.0 stem + features.N.dw/pw blocks)")
    _take(sd, out, "features.0.weight")
    _bn(sd, out, "features.1")
    for k in range(13):
        for part in ("dw", "pw"):
            t = f"features.{k + 3}.{part}"
            _take(sd, out, f"{t}.conv.weight")
            _bn(sd, out, f"{t}.bn")
    if include_fc:
        _take(sd, out, "linear.weight")
        _take(sd, out, "linear.bias")
    return out


_INCEPTION_BRANCHES = ("branch1_conv1x1", "branch2_conv3x3", "branch2_conv1x1",
                       "branch3_conv5x5", "branch3_conv1x1", "branch4_conv1x1")
_INCEPTION_MODULES = ("inception_3a", "inception_3b", "inception_4a",
                      "inception_4b", "inception_4c", "inception_4d",
                      "inception_4e", "inception_5a", "inception_5b")


def import_torch_inception_v1(state_dict: Mapping, model_sd: Mapping,
                              include_fc: bool = True) -> dict:
    """The reference's Inception V1 / GoogLeNet layout (``conv7x7/
    conv1x1/conv3x3``, ``inception_Nx`` modules of ``branchK_convJxJ``
    BasicConv2d branches, ``aux1/aux2``, ``linear``).
    ``include_fc=False`` leaves out the class head and both aux heads'
    last linear."""
    sd, out = state_dict, {}
    if "conv7x7.conv.weight" not in sd:
        raise ValueError("not a reference-layout Inception V1 checkpoint "
                         "(expects conv7x7.conv.weight)")

    def basic(key):
        _take(sd, out, f"{key}.conv.weight")
        _take(sd, out, f"{key}.conv.bias")

    for key in ("conv7x7", "conv1x1", "conv3x3"):
        basic(key)
    for mod in _INCEPTION_MODULES:
        for branch in _INCEPTION_BRANCHES:
            basic(f"{mod}.{branch}")
    for aux in ("aux1", "aux2"):
        basic(f"{aux}.features.1")
        _take(sd, out, f"{aux}.classifier.0.weight")
        _take(sd, out, f"{aux}.classifier.0.bias")
        if include_fc:
            _take(sd, out, f"{aux}.classifier.3.weight")
            _take(sd, out, f"{aux}.classifier.3.bias")
    if include_fc:
        _take(sd, out, "linear.weight")
        _take(sd, out, "linear.bias")
    return out


def _resnet(arch):
    return lambda sd, model_sd, fc: import_torch_resnet(sd, arch, fc)


#: config-registry name → importer ``(checkpoint, model state_dict,
#: include_fc) → {model key: tensor}``
ARCH_IMPORTERS = {
    "resnet34": _resnet("resnet34"),
    "resnet50": _resnet("resnet50"),
    "resnet152": _resnet("resnet152"),
    "alexnet1": import_torch_alexnet,
    "alexnet2": import_torch_alexnet,
    "vgg16": import_torch_vgg,
    "vgg19": import_torch_vgg,
    "lenet5": import_torch_lenet5,
    "mobilenet1": import_torch_mobilenet_v1,
    "inception1": import_torch_inception_v1,
}


def load_state_dict(path: str) -> dict:
    """A ``.pth``/``.pt`` state_dict from disk: bare, or in the common
    ``{"state_dict": ...}`` wrapper, with ``module.`` prefixes (from
    DataParallel) stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("module."): v for k, v in obj.items()}


def _check_arch(arch: str) -> None:
    if arch not in ARCH_IMPORTERS:
        raise ValueError(
            f"no torch importer for '{arch}'; have {sorted(ARCH_IMPORTERS)}")


def load_torch_checkpoint(path: str, arch: str, model_sd: Mapping,
                          include_fc: bool = True) -> dict:
    """Load from disk and select: ``{model key: tensor}`` for a model
    whose ``state_dict`` is ``model_sd``."""
    _check_arch(arch)
    return ARCH_IMPORTERS[arch](load_state_dict(path), model_sd, include_fc)


def import_pretrained(path: str, arch: str, fresh: Mapping) -> tuple:
    """Load once, select, merge onto the fresh ``state_dict`` ``fresh``.
    Keeps the checkpoint's class head when it fits the model; on a head
    shape mismatch imports again without it (fine-tuning on another
    label space).  Returns ``(merged state_dict, head_kept)``."""
    _check_arch(arch)
    sd = load_state_dict(path)
    try:
        return merge_pretrained(
            fresh, ARCH_IMPORTERS[arch](sd, fresh, True)), True
    except ValueError:
        # a backbone mismatch raises again here: only the head recovers
        return merge_pretrained(
            fresh, ARCH_IMPORTERS[arch](sd, fresh, False)), False


def merge_pretrained(fresh: Mapping, imported: Mapping) -> dict:
    """A copy of ``fresh`` with every imported entry in place (cast to
    the model's dtype), checked entry by entry: a key the model lacks
    raises ``KeyError``, another shape ``ValueError``."""
    out = dict(fresh)
    for key, value in imported.items():
        if key not in fresh:
            raise KeyError(f"checkpoint key '{key}' not in model")
        want = fresh[key]
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(
                f"shape mismatch: checkpoint {tuple(value.shape)} vs model "
                f"{tuple(want.shape)}")
        out[key] = value.detach().to(device=want.device, dtype=want.dtype)
    return out
