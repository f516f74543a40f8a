"""Weights → a serving-ready model, shared by every inference surface.

Port of ``deep_vision_tpu/core/restore.py`` (``params_digest``,
``serving_input_shape``, ``checkpoint_fingerprint``, ``load_state``).
Weights come from one of three places:

  * a training workdir (``workdir=``): the port's own checkpoints
    (``core/checkpoint.py``, ``<workdir>/checkpoints[_best]/<step>/
    checkpoint.pt``), the newest complete step first, falling back past a
    step whose file fails to load, as the reference falls back past a
    corrupt Orbax step.  Orbax checkpoints of the JAX package are not
    read;
  * a ``--weights`` ``.npz`` archive of the reference's flax variables
    tree (``convert.py``, through the importer of the model's family);
  * neither: a seeded random init, with a warning, as the reference does
    when no checkpoint exists.

A checkpoint that holds a params EMA (``cli.train --ema-decay``) serves
the EMA parameters with the raw BatchNorm buffers, the copy eval scored,
as the reference does; ``info["ema"]`` says which copy served.  The
serving plane's reload and the deploy watcher's gate restore through
this path, so they gate and serve that copy too.
"""

from __future__ import annotations

import hashlib
import os

import torch

from deep_vision_tpu_torch.core.checkpoint import FILENAME

#: checkpoint sources in the order a workdir is searched (the reference's)
CHECKPOINT_DIRS = ("checkpoints_best", "checkpoints")
#: which network of an adversarial checkpoint (``save_tree``) is served:
#: DCGAN's generator, CycleGAN's A→B generator
GENERATOR_NAMES = ("generator", "gen_a2b")
#: ``info["ema"]``: which copy of a workdir's weights serves
EMA_WEIGHTS = "EMA weights"
RAW_WEIGHTS = "none: the checkpoint holds no params EMA; the trained " \
    "weights serve"


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


def _complete_step_dir(path: str) -> bool:
    """A step directory counts once its checkpoint file is in it: a save
    writes a ``.<step>-*`` temporary directory and renames it into
    place, so a save in progress never shows a numeric name."""
    return os.path.isfile(os.path.join(path, FILENAME))


def _durable_steps(d: str) -> list[tuple[int, float]]:
    """``(step, step dir mtime)`` of every complete step under ``d``."""
    out = []
    try:
        with os.scandir(d) as it:
            entries = list(it)
    except OSError:
        return out
    for ent in entries:
        if not ent.name.isdigit():
            continue
        try:
            if not ent.is_dir(follow_symlinks=False) \
                    or not _complete_step_dir(ent.path):
                continue
            out.append((int(ent.name), ent.stat().st_mtime))
        except OSError:
            continue  # torn down mid-scan: not durable
    return sorted(out)


def checkpoint_fingerprint(workdir: str) -> dict:
    """Filesystem-only "new step published?" probe: the newest complete
    step under ``checkpoints_best``/``checkpoints`` (the order
    :func:`load_state` searches), its directory and the step directory's
    mtime; no checkpoint bytes are read.  ``{"step": None, "dir": None,
    "mtime": None}`` for a workdir with no complete checkpoint."""
    for sub in CHECKPOINT_DIRS:
        d = os.path.join(workdir, sub)
        steps = _durable_steps(d) if os.path.isdir(d) else []
        if steps:
            step, mtime = steps[-1]
            return {"step": step, "dir": d, "mtime": mtime}
    return {"step": None, "dir": None, "mtime": None}


def checkpoint_weights(payload: dict) -> dict:
    """The served network's ``state_dict`` from a checkpoint payload: a
    trainer's ``{"state"}`` (its EMA parameters over the raw buffers
    where it holds an EMA, :func:`checkpoint_has_ema`), or an
    adversarial trainer's ``{"states"}`` (its generator,
    ``GENERATOR_NAMES``)."""
    if "state" in payload:
        state = payload["state"]
        return {**state["model"], **(state.get("ema") or {})}
    states = payload.get("states") or {}
    for name in GENERATOR_NAMES:
        if name in states:
            return states[name]["model"]
    raise KeyError(f"checkpoint holds no servable network (keys "
                   f"{sorted(payload)}, networks {sorted(states)})")


def checkpoint_has_ema(payload: dict) -> bool:
    """Whether the payload's served weights are a params EMA."""
    return bool((payload.get("state") or {}).get("ema"))


def _restore_workdir(cfg, workdir: str, log, tag: str, info: dict):
    """The newest restorable step under ``workdir``, or None."""
    for sub in CHECKPOINT_DIRS:
        d = os.path.join(workdir, sub)
        if not os.path.isdir(d):
            continue
        steps = [s for s, _ in reversed(_durable_steps(d))]
        for step in steps:
            step_dir = os.path.join(d, str(step))
            try:
                payload = torch.load(os.path.join(step_dir, FILENAME),
                                     map_location="cpu", weights_only=True)
                model = cfg.model()
                model.load_state_dict(checkpoint_weights(payload),
                                      strict=True)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — a corrupt or partial step
                log(f"[{tag}] WARNING: checkpoint step {step} under {d} "
                    f"failed to restore ({type(e).__name__}: {e}); "
                    f"falling back to the previous retained step")
                continue
            fallback = step != steps[0]
            ema = checkpoint_has_ema(payload)
            info.update({"step": step, "dir": d, "fallback": fallback,
                         "mtime": os.path.getmtime(step_dir),
                         "ema": EMA_WEIGHTS if ema else RAW_WEIGHTS})
            log(f"[{tag}] restored from {d} step {step}"
                + (f" ({EMA_WEIGHTS})" if ema else "")
                + (" [FALLBACK: newer step was corrupt]" if fallback
                   else ""))
            return model
        if steps:
            log(f"[{tag}] WARNING: every retained checkpoint under {d} "
                f"failed to restore; trying the next source")
    return None


def load_state(cfg, weights: str | None = None, *, workdir: str | None = None,
               log=print, tag: str = "restore", info: dict | None = None):
    """Build ``cfg``'s model on the CPU in eval mode with its weights.

    ``weights`` is a ``.npz`` of the flax variables tree; ``workdir`` a
    training workdir of the port (see the module docstring); with
    neither, or a workdir with no restorable checkpoint, a random init
    from ``torch.Generator().manual_seed(cfg.seed)`` with a warning.
    ``info`` (optional dict) receives ``weights`` (the npz path or None),
    ``step`` (the step restored, None otherwise), ``dir``, ``fallback``
    (True when a step older than the newest was restored), ``mtime`` (the
    step directory's), ``ema`` (:data:`EMA_WEIGHTS` when the EMA copy
    serves, else :data:`RAW_WEIGHTS`) and ``digest``
    (:func:`params_digest`)."""
    from deep_vision_tpu_torch import convert

    if info is None:
        info = {}
    info.update({"weights": weights or None, "step": None, "dir": None,
                 "fallback": False, "mtime": None, "ema": RAW_WEIGHTS})
    model = None
    if weights:
        model = cfg.model()
        import_weights(model, convert.load_npz(weights))
        log(f"[{tag}] loaded weights from {weights}")
    elif workdir:
        model = _restore_workdir(cfg, workdir, log, tag, info)
    if model is None:
        model = cfg.model()
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        what = "restorable checkpoint" if workdir else "weights given"
        log(f"[{tag}] WARNING: no {what}, using random init "
            f"(seed {cfg.seed})")
    model.eval()
    info["digest"] = params_digest(model)
    return model
