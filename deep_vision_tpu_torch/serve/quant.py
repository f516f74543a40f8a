"""Post-training int8 quantization for the serving tier.

Port of ``deep_vision_tpu/serve/quant.py``.  Scheme: symmetric
per-output-channel int8 for every conv/fc weight (absmax over every axis
but the output channel: dim 0 in torch layout, the trailing axis in the
reference's flax layout), a symmetric per-tensor scale for the ingest
activations, and simulated-integer execution: the weights stay
int8-resident on the device and each forward dequantizes them
(``models/common.resident_weight``) with float32 results.  No float copy
of a quantized weight is kept, so ``param_bytes()`` reports the int8
footprint.

What stays float: 1-D leaves (biases, BatchNorm scale/shift and running
statistics).  Quantization runs in numpy on the host, so the int8 codes
and scales are bit-identical to the reference's.

Calibration runs a held-out batch (or a deterministic synthetic one)
through the model with forward hooks that record each module's output
absmax, keyed by the port's module names, plus the post-normalize input
absmax that prices the ingest scale.  Same batches, same scales.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from deep_vision_tpu_torch.models.common import dequantize


@dataclasses.dataclass(frozen=True)
class Calibration:
    """What calibration measured (host floats, JSON-safe).

    ``act_scale`` quantizes normalized activations at ingest
    (``q = round(x/act_scale)``); ``ranges`` maps each module's name to
    its output absmax over the calibration batches."""

    act_scale: float
    act_absmax: float
    ranges: dict
    batches: int
    batch_size: int
    source: str

    def describe(self) -> dict:
        return {"act_scale": self.act_scale,
                "act_absmax": self.act_absmax,
                "activation_ranges": len(self.ranges),
                "calib_batches": self.batches,
                "calib_batch_size": self.batch_size,
                "calib_source": self.source}


def quantize_tensor(w) -> tuple:
    """One weight → (stored, scale).

    Float tensors of rank ≥ 2 become int8 with a float32 ``(out,)`` scale
    per dim-0 channel; everything else passes through with a 0-d
    identity scale.  All-zero channels get scale 1.0 (exact zeros).

    A channel holding a NaN or an infinity gets codes 0 and a NaN scale,
    so its outputs are NaN as the float model's would be, and output
    validation and the canary see them.  The reference gives such a
    channel scale 1.0 and finite codes, which hides the bad weight."""
    a = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) \
        else np.asarray(w)
    if a.ndim >= 2 and a.dtype.kind == "f":
        a32 = a.astype(np.float32)
        absmax = np.max(np.abs(a32), axis=tuple(range(1, a.ndim)))
        finite = np.isfinite(absmax)
        scale = np.where(absmax > 0.0, absmax / 127.0, 1.0)
        scale = np.where(finite, scale, 1.0).astype(np.float32)
        bshape = (-1,) + (1,) * (a.ndim - 1)
        q = np.clip(np.rint(a32 / scale.reshape(bshape)), -127.0, 127.0)
        q = np.where(finite.reshape(bshape), q, 0.0)
        scale[~finite] = np.nan
        return q.astype(np.int8), scale
    return a, np.asarray(1.0, np.float32)


def quantize_params(state_dict) -> tuple:
    """``state_dict`` → (quantized dict, scale dict), same keys (numpy)."""
    q, s = {}, {}
    for k, v in state_dict.items():
        q[k], s[k] = quantize_tensor(v)
    return q, s


def dequantize_params(qparams, scales, dtype=torch.float32) -> dict:
    """Inverse of :func:`quantize_params` on tensors: int8 entries expand
    to ``dtype``, the others pass through."""
    out = {}
    for k, w in qparams.items():
        w = torch.as_tensor(w)
        out[k] = dequantize(w, torch.as_tensor(scales[k])).to(dtype) \
            if w.dtype == torch.int8 else w
    return out


def quantize_model_(model: torch.nn.Module) -> torch.nn.Module:
    """Swap every conv/fc weight of ``model`` for its int8 code (buffer
    ``weight``) and float32 scale (buffer ``weight_scale``), in place on
    the model's device.  The float weight is dropped."""
    for module in model.modules():
        w = module._parameters.get("weight")
        if w is None or w.dim() < 2:
            continue
        q, scale = quantize_tensor(w)
        dev = w.device
        del module._parameters["weight"]
        module.register_buffer("weight", torch.from_numpy(q).to(dev))
        module.register_buffer("weight_scale",
                               torch.from_numpy(scale).to(dev))
    return model


def synthetic_calibration_batches(input_shape, n_batches: int = 2,
                                  batch_size: int = 8) -> list:
    """Deterministic uint8 calibration data (``RandomState(0)`` each call,
    the same bytes the reference draws)."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (batch_size, *input_shape), dtype=np.uint8)
            for _ in range(n_batches)]


def load_calibration_dir(calib_dir: str, input_shape, n_batches: int = 2,
                         batch_size: int = 8) -> list:
    """Held-out calibration data: ``*.npy``/``*.npz`` files of uint8 HWC
    images or NHWC batches under ``calib_dir``, in sorted order, re-batched
    (the npz key ``image``/``images`` if present, else the first)."""
    paths = sorted(glob.glob(os.path.join(calib_dir, "*.npy"))
                   + glob.glob(os.path.join(calib_dir, "*.npz")))
    if not paths:
        raise FileNotFoundError(
            f"no *.npy/*.npz calibration files under {calib_dir}")
    imgs = []
    want = tuple(input_shape)
    for p in paths:
        a = np.load(p)
        if isinstance(a, np.lib.npyio.NpzFile):
            with a as z:
                keys = list(z.files)
                if not keys:
                    raise ValueError(f"{p}: empty npz archive")
                key = next((k for k in ("image", "images") if k in keys),
                           keys[0])
                a = z[key]
        if a.ndim == len(want):
            a = a[None]
        if a.ndim != len(want) + 1 or tuple(a.shape[1:]) != want:
            raise ValueError(f"{p}: expected uint8 images of shape {want} "
                             f"(or batches thereof), got {a.shape}")
        imgs.append(np.asarray(a, np.uint8))
        if sum(len(i) for i in imgs) >= n_batches * batch_size:
            break
    flat = np.concatenate(imgs)[:n_batches * batch_size]
    if len(flat) < batch_size:
        raise ValueError(f"{calib_dir} holds {len(flat)} calibration images; "
                         f"need at least one batch of {batch_size}")
    return [flat[i:i + batch_size]
            for i in range(0, len(flat) - batch_size + 1, batch_size)]


@torch.inference_mode()
def calibrate(model: torch.nn.Module, batches, kind: str,
              device=None) -> Calibration:
    """Forward ``batches`` (uint8 NHWC) through ``model`` → Calibration.

    Each batch is normalized exactly like the serving wire
    (``ops/preprocess.serve_normalize``); the input absmax over all
    batches prices the ingest scale, and a forward hook on every named
    module records its floating output absmax."""
    from deep_vision_tpu_torch.ops.preprocess import serve_normalize

    if not batches:
        raise ValueError("calibration needs at least one batch")
    device = torch.device("cpu") if device is None else torch.device(device)
    ranges: dict[str, float] = {}

    def hook(name):
        def fn(_module, _inputs, out):
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                ranges[name] = max(ranges.get(name, 0.0),
                                   float(out.abs().max()))
        return fn

    handles = [m.register_forward_hook(hook(name))
               for name, m in model.named_modules() if name]
    act_absmax = 0.0
    try:
        for b in batches:
            x = serve_normalize(torch.from_numpy(np.asarray(b, np.uint8))
                                .to(device), kind)
            act_absmax = max(act_absmax, float(x.abs().max()))
            model(x)
    finally:
        for h in handles:
            h.remove()
    act_absmax = act_absmax if act_absmax > 0.0 else 1.0
    return Calibration(act_scale=act_absmax / 127.0, act_absmax=act_absmax,
                       ranges=dict(sorted(ranges.items())),
                       batches=len(batches),
                       batch_size=int(np.asarray(batches[0]).shape[0]),
                       source="")


def quantize_for_serving(model: torch.nn.Module, *, kind: str, input_shape,
                         calib_batches: int = 2,
                         calib_dir: str | None = None, batch_size: int = 8,
                         device=None) -> Calibration:
    """The registry's int8 load path: calibrate on ``calib_dir``'s
    held-out images (else deterministic synthetic batches) with the float
    weights, then quantize ``model`` in place."""
    if calib_dir:
        batches = load_calibration_dir(calib_dir, input_shape,
                                       n_batches=calib_batches,
                                       batch_size=batch_size)
        source = calib_dir
    else:
        batches = synthetic_calibration_batches(
            input_shape, n_batches=calib_batches, batch_size=batch_size)
        source = "synthetic"
    calib = calibrate(model, batches, kind, device=device)
    quantize_model_(model)
    return dataclasses.replace(calib, source=source)
