"""Weights → a serving-ready model, shared by every inference surface.

Port of ``deep_vision_tpu/core/restore.py`` (``params_digest``,
``serving_input_shape``, ``load_state``).  Orbax checkpoints are not read
here: the port loads a ``--weights`` ``.npz`` archive of the reference's
flax variables tree (``convert.py``, through the importer of the model's
family), or, with no weights, builds a seeded random init and says so
with a warning, as the reference does when no checkpoint exists.
"""

from __future__ import annotations

import hashlib

import torch


def params_digest(model: torch.nn.Module) -> str:
    """Cheap byte hash of a model's ``state_dict`` (shapes, dtypes and
    bytes through one blake2b): answers "are these the same weights?"."""
    h = hashlib.blake2b(digest_size=8)
    for key, t in model.state_dict().items():
        a = t.detach().cpu().contiguous()
        h.update(key.encode())
        h.update(str(tuple(a.shape)).encode())
        h.update(str(a.dtype).encode())
        h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def serving_input_shape(cfg, model=None) -> tuple:
    """Per-example input shape for ``cfg``: NHWC ``(H, W, C)``, but
    ``(latent_dim,)`` for the latent-in DCGAN generator (``gan_dcgan``),
    whose Dense kernel is sized by its latent and not by an image.  Pass
    ``model`` when one is already built."""
    if getattr(cfg, "task", "") == "gan_dcgan":
        if model is None:
            model = cfg.model()
        return (int(getattr(model, "latent_dim", 100)),)
    return (cfg.image_size, cfg.image_size, cfg.channels)


def import_weights(model, variables) -> None:
    """Copy a flax variables tree into ``model`` with the importer of
    its family: ResNet V1, the classifier zoo (LeNet-5 and its tiers,
    AlexNet, VGG, Inception V1/V3, MobileNet V1, ShuffleNet V1, ResNet-50
    V2), YOLOv3, CenterNet, StackedHourglass, or a GAN network (the
    DCGAN and CycleGAN generators and discriminators); any other class
    raises and names it.  Every importer is strict: a tree of another family
    raises ``KeyError``."""
    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.models.centernet import CenterNet
    from deep_vision_tpu_torch.models.common import Classifier
    from deep_vision_tpu_torch.models.gan import GANModel
    from deep_vision_tpu_torch.models.hourglass import StackedHourglass
    from deep_vision_tpu_torch.models.resnet import ResNet
    from deep_vision_tpu_torch.models.yolo import YoloV3

    if isinstance(model, ResNet) and model.preact:
        convert.load_classifier(model, variables)
        return
    importers = ((ResNet, convert.load_into),
                 (Classifier, convert.load_classifier),
                 (YoloV3, convert.load_yolo),
                 (CenterNet, convert.load_centernet),
                 (StackedHourglass, convert.load_stacked_hourglass),
                 (GANModel, convert.load_gan))
    for cls, load in importers:
        if isinstance(model, cls):
            load(model, variables)
            return
    raise TypeError(f"no weight importer for {type(model).__name__}; "
                    f"have {[cls.__name__ for cls, _ in importers]}")


def load_state(cfg, weights: str | None = None, *, log=print,
               info: dict | None = None):
    """Build ``cfg``'s model on the CPU in eval mode with its weights.

    ``weights`` is a ``.npz`` of the flax variables tree; None gives a
    random init from ``torch.Generator().manual_seed(cfg.seed)`` with a
    warning.  ``info`` (optional dict) receives ``weights`` (the path or
    None) and ``digest`` (:func:`params_digest`)."""
    from deep_vision_tpu_torch import convert

    if info is None:
        info = {}
    model = cfg.model()
    if weights:
        import_weights(model, convert.load_npz(weights))
        log(f"[restore] loaded weights from {weights}")
    else:
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        log(f"[restore] WARNING: no weights given, using random init "
            f"(seed {cfg.seed})")
    model.eval()
    info.update({"weights": weights or None, "digest": params_digest(model)})
    return model
