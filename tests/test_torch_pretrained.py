"""Pretrained import (``models/pretrained.py``) against the reference's.

For every architecture of the reference's ``ARCH_IMPORTERS`` a
torch-format checkpoint is written from seeded weights, in the three
forms ``load_state_dict`` accepts (bare, ``{"state_dict": ...}``,
``module.``-prefixed), with torchvision's ``num_batches_tracked``
entries among them.  The reference imports it onto flax variables
converted from a fresh port model, the result is loaded back into a
port model through ``convert``, and the port's own import onto the same
fresh model must give that ``state_dict`` exactly.  Then the head rules,
the refusals and ``cli.train --pretrained``.
"""

import pytest
import torch

import _torch_port as tp
import _torch_zoo as tz
from deep_vision_tpu.models import pretrained as ref
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models import pretrained as port

#: the ResNets of ARCH_IMPORTERS: (stage sizes, block) at full depth
RESNETS = {"resnet34": ((3, 4, 6, 3), "BasicBlock"),
           "resnet50": ((3, 4, 6, 3), "BottleneckBlock"),
           "resnet152": ((3, 8, 36, 3), "BottleneckBlock")}


def _model(arch, classes=tz.CLASSES):
    """The port's model of ``arch`` at PR 7's test size."""
    from deep_vision_tpu_torch.models import alexnet, inception, lenet
    from deep_vision_tpu_torch.models import mobilenet, vgg

    if arch in RESNETS:
        stages, block = RESNETS[arch]
        return tp.port_model(stages, block, classes)
    # Inception V1 at 224², where the aux heads flatten the 4×4×128 map
    # the reference's importer is fixed at (no other importer takes it)
    size = 224 if arch == "inception1" else tz.MODELS[arch][2]
    sized = {"alexnet1": alexnet.AlexNetV1, "alexnet2": alexnet.AlexNetV2,
             "vgg16": vgg.VGG16, "vgg19": vgg.VGG19,
             "inception1": inception.InceptionV1}
    if arch in sized:
        return sized[arch](classes, image_size=size)
    if arch == "mobilenet1":
        return mobilenet.MobileNetV1(num_classes=classes)
    return lenet.LeNet5(num_classes=classes)


def _to_flax(arch, model):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if arch in RESNETS:
        stages, block = RESNETS[arch]
        return convert.import_torch_resnet(sd, stage_sizes=stages,
                                           block=block)
    return convert.classifier_to_flax(sd, model)


def _from_flax(arch, variables):
    model = _model(arch)
    tree = {"params": variables["params"],
            "batch_stats": variables.get("batch_stats", {})}
    if arch in RESNETS:
        convert.load_into(model, tree)
    else:
        convert.load_classifier(model, tree)
    return model.state_dict()


def _seeded(model, seed):
    """Every floating entry of ``model``'s state_dict seeded (variances
    positive); the BN counters set to 7, which no importer reads."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.full_like(v, 7)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
    return sd


def _write(path, sd, form):
    if form == "wrapped":
        torch.save({"state_dict": sd, "epoch": 3}, path)
    elif form == "module":
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    else:
        torch.save(sd, path)


def _assert_sd_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for k in want:
        assert torch.equal(got[k], want[k]), k


ARCHS = sorted(ref.ARCH_IMPORTERS)


def test_the_port_covers_every_reference_arch():
    assert sorted(port.ARCH_IMPORTERS) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_import_equals_the_reference(arch, tmp_path, monkeypatch):
    """Every form of one seeded checkpoint imports to the reference's
    weights exactly, the head kept; the untouched entries (the BN
    counters) keep the fresh init."""
    if arch.startswith("vgg"):
        # the reference's VGG importer is fixed at 224² (a 7×7×512
        # flatten); PR 7's test size is 64² (2×2×512), imported through
        # the reference's own sequential importer at that flatten
        monkeypatch.setitem(
            ref.ARCH_IMPORTERS, arch,
            lambda sd, fc: ref.import_torch_sequential(sd, (2, 2), fc))
    if arch.startswith("alexnet"):
        # likewise AlexNet's 6×6 flatten against PR 7's 127² (3×3)
        monkeypatch.setitem(
            ref.ARCH_IMPORTERS, arch,
            lambda sd, fc: ref.import_torch_sequential(sd, (3, 3), fc))
    fresh = _model(arch)
    fresh_sd = fresh.state_dict()
    ckpt = _seeded(_model(arch), seed=11)
    paths = {}
    for form in ("bare", "wrapped", "module"):
        paths[form] = str(tmp_path / f"{form}.pth")
        _write(paths[form], ckpt, form)
    merged, kept = ref.import_pretrained(paths["bare"], arch,
                                         _to_flax(arch, fresh))
    assert kept
    want = _from_flax(arch, merged)
    for form, path in paths.items():
        got, head_kept = port.import_pretrained(path, arch, fresh_sd)
        assert head_kept, form
        _assert_sd_equal(got, want)
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(v, fresh_sd[k]) and int(v) != 7
        else:
            assert torch.equal(v, ckpt[k]), k


@pytest.mark.parametrize("arch", ["lenet5", "resnet34", "mobilenet1",
                                  "inception1"])
def test_head_fresh_at_another_class_count(arch, tmp_path):
    """A checkpoint of another class count imports headless in both
    packages: the same merged weights, the head equal to the fresh
    init."""
    other = _model(arch, classes=7)
    path = str(tmp_path / "c.pth")
    _write(path, _seeded(other, seed=5), "wrapped")
    fresh = _model(arch)
    fresh_sd = fresh.state_dict()
    merged, kept = ref.import_pretrained(path, arch, _to_flax(arch, fresh))
    got, head_kept = port.import_pretrained(path, arch, fresh_sd)
    assert not kept and not head_kept
    _assert_sd_equal(got, _from_flax(arch, merged))
    heads = [k for k in got if got[k].shape != other.state_dict()[k].shape]
    assert heads
    for k in heads:
        assert torch.equal(got[k], fresh_sd[k]), k


def test_torchvision_sequential_numbering_imports_in_order(tmp_path,
                                                         monkeypatch):
    """A checkpoint numbered as torchvision numbers AlexNet (features.0,
    3, 6, 8, 10; classifier.1, 4, 6) fills the port's layers in order,
    as the reference's importer reads it."""
    monkeypatch.setitem(
        ref.ARCH_IMPORTERS, "alexnet1",
        lambda sd, fc: ref.import_torch_sequential(sd, (3, 3), fc))
    fresh = _model("alexnet1")
    fresh_sd = fresh.state_dict()
    src = _seeded(fresh, seed=3)
    convs = port._seq_indices(src, "features", 4)
    fcs = port._seq_indices(src, "classifier", 2)
    renum = {}
    for prefix, old, new in (("features", convs, (0, 3, 6, 8, 10)),
                             ("classifier", fcs, (1, 4, 6))):
        for o, n in zip(old, new):
            for leaf in ("weight", "bias"):
                renum[f"{prefix}.{n}.{leaf}"] = src[f"{prefix}.{o}.{leaf}"]
    path = str(tmp_path / "tv.pth")
    _write(path, renum, "bare")
    got, kept = port.import_pretrained(path, "alexnet1", fresh_sd)
    merged, ref_kept = ref.import_pretrained(path, "alexnet1",
                                             _to_flax("alexnet1", fresh))
    assert kept and ref_kept
    _assert_sd_equal(got, src)
    _assert_sd_equal(got, _from_flax("alexnet1", merged))


def test_refusals_match_the_reference(tmp_path):
    fresh = _model("lenet5")
    fresh_sd = fresh.state_dict()
    ckpt = _seeded(fresh, seed=2)
    # a backbone shape mismatch raises in both, even without the head
    bad = dict(ckpt)
    bad["features.0.weight"] = torch.zeros(6, 1, 3, 3)
    path = str(tmp_path / "bad.pth")
    _write(path, bad, "bare")
    with pytest.raises(ValueError, match="shape mismatch"):
        ref.import_pretrained(path, "lenet5", _to_flax("lenet5", fresh))
    with pytest.raises(ValueError, match="shape mismatch"):
        port.import_pretrained(path, "lenet5", fresh_sd)
    # an entry the importer reads but the checkpoint lacks: KeyError
    head_bias = sorted(k for k in ckpt if k.startswith("classifier.")
                       and k.endswith(".bias"))[-1]
    short = {k: v for k, v in ckpt.items() if k != head_bias}
    _write(path, short, "bare")
    with pytest.raises(KeyError):
        ref.import_pretrained(path, "lenet5", _to_flax("lenet5", fresh))
    with pytest.raises(KeyError):
        port.import_pretrained(path, "lenet5", fresh_sd)
    # a checkpoint key the model lacks: KeyError
    with pytest.raises(KeyError, match="not in model"):
        port.merge_pretrained(fresh_sd, {"nope.weight": torch.zeros(1)})
    # a BN variant of a sequential checkpoint, the wrong conv count
    bn = dict(ckpt, **{"features.1.running_mean": torch.zeros(6)})
    _write(path, bn, "bare")
    for mod in (ref, port):
        with pytest.raises(ValueError, match="BatchNorm"):
            mod.load_torch_checkpoint(path, "lenet5", *(
                () if mod is ref else (fresh_sd,)))
    _write(path, ckpt, "bare")
    for mod in (ref, port):
        with pytest.raises(ValueError, match="AlexNet has 5 convs"):
            mod.load_torch_checkpoint(path, "alexnet1", *(
                () if mod is ref else (fresh_sd,)))
        with pytest.raises(ValueError, match="no torch importer"):
            mod.import_pretrained(path, "yolov3_coco", {})


def test_cli_train_pretrained_starts_from_the_checkpoint(tmp_path, capsys,
                                                         monkeypatch):
    """``cli.train -m lenet5 --pretrained P --synthetic --device cpu``:
    the state before the first step is the checkpoint (head kept)."""
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.trainer import Trainer

    ckpt = _seeded(_model("lenet5"), seed=9)
    path = str(tmp_path / "lenet.pth")
    _write(path, ckpt, "module")
    seen = {}
    original = Trainer.train_step

    def spy(self, state, batch):
        if not seen:
            seen.update({k: v.detach().clone()
                         for k, v in state.model.state_dict().items()})
        return original(self, state, batch)

    monkeypatch.setattr(Trainer, "train_step", spy)
    assert cli.main(["-m", "lenet5", "--pretrained", path, "--synthetic",
                     "--synthetic-size", "64", "--batch-size", "32",
                     "--epochs", "1", "--workdir", str(tmp_path / "w"),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[pretrained] loaded lenet5 weights from {path} (head kept)" \
        in out
    _assert_sd_equal(seen, ckpt)


def test_cli_train_pretrained_refuses_other_archs(tmp_path):
    from deep_vision_tpu_torch.cli import train as cli

    with pytest.raises(SystemExit, match="--pretrained supports"):
        cli.main(["-m", "lenet5_nano", "--pretrained", "x.pth",
                  "--synthetic", "--synthetic-size", "32", "--epochs", "1",
                  "--workdir", str(tmp_path), "--device", "cpu"])
