"""Model registry: name → ServingModel with per-bucket forward callables.

Port of ``deep_vision_tpu/serve/registry.py`` (``ServingModel``,
``CheckpointServingModel``, ``ModelRegistry.load_checkpoint/get``).  The
engine asks ``compile_bucket(b)`` for a callable that takes a padded
batch of exactly ``b`` inputs; the model decides how it runs.

Execution contract (what the engine relies on):

  * a callable takes a tensor already on the model's device (the engine
    stages and copies it there on its own stream) or host numpy (direct
    callers), in the model's WIRE dtype;
  * it runs on the caller's current CUDA stream and returns the float32
    outputs on the device without synchronising — a tensor (classify
    logits), a nested tuple of tensors (dense detection heads), or the
    workload epilogue's dict (device-decoded detections, whose
    ``classes`` are int32, or keypoints); the engine copies each leaf to
    the host once per batch;
  * it runs eagerly (CUDA graphs per bucket come in a later slice).

Wire and compute dtypes: a uint8 wire ships raw 0–255 pixels and the
callable normalizes them on the device; a float32 wire ships
host-normalized pixels.  ``infer_dtype`` "bfloat16" casts the float
parameters once at load and computes in bf16; "int8" calibrates and
quantizes the weights at load (``serve/quant.py``) and, on the uint8
wire, runs the ``serve_ingest`` kernel as the prologue.  Floating
outputs are float32 whatever the compute dtype.  The workload's epilogue
(``serve/workloads.py``: the detect decode, the pose decode, generate's
uint8 encode) runs after that cast, on the device, inside the same
callable.  The workload also sets a model's input: a latent-in
generator (DCGAN) takes ``(latent_dim,)`` float32 whatever wire was
asked.
"""

from __future__ import annotations

import numpy as np
import torch

from deep_vision_tpu_torch.core.device import resolve_device
from deep_vision_tpu_torch.ops.boxes import SOFT_MODES
from deep_vision_tpu_torch.serve.engine import map_leaves
from deep_vision_tpu_torch.serve.workloads import workload_for_task

#: wire formats: what dtype the client ships and the engine stages
WIRE_DTYPES = {"float32": torch.float32, "uint8": torch.uint8}
#: compute dtypes (outputs are always float32)
INFER_DTYPES = ("float32", "bfloat16", "int8")
DETECT_DECODES = ("device", "host")


class ServingModel:
    """One deployable model: metadata + per-bucket forwards on ``device``."""

    def __init__(self, name: str, *, task: str, input_shape: tuple,
                 num_classes: int, wire_dtype: str = "float32",
                 infer_dtype: str = "float32", device=None):
        if str(wire_dtype) not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype '{wire_dtype}' unsupported "
                             f"(have {tuple(WIRE_DTYPES)})")
        if str(infer_dtype) not in INFER_DTYPES:
            raise ValueError(f"infer_dtype '{infer_dtype}' unsupported "
                             f"(have {INFER_DTYPES})")
        self.device = resolve_device(device)
        self.name = name
        self.task = task
        self.input_shape = tuple(input_shape)
        self.num_classes = num_classes
        self.workload = workload_for_task(task)
        #: the engine stages and copies exactly this dtype (numpy for
        #: request decoding, torch for staging and the callables)
        self.wire_dtype = np.dtype(str(wire_dtype))
        self.wire_torch_dtype = WIRE_DTYPES[str(wire_dtype)]
        self.infer_dtype = str(infer_dtype)
        #: the dtype the epilogue hands the D2H copy when it is not the
        #: forward's float32 (generate: uint8)
        self.output_wire: str | None = None
        #: where the weights came from (None = seeded random init) and
        #: their byte digest (core/restore.py)
        self.weights: str | None = None
        self.params_digest: str | None = None
        self._model: torch.nn.Module | None = None
        # detection decode knobs (serve/workloads.py DetectWorkload),
        # read when a bucket callable is built: "device" runs decode →
        # score floor → top-k → class-wise NMS inside the callable, so
        # a batch leaves the device as K rows an image; "host" keeps
        # the dense outputs and decodes per request in respond().  The
        # score threshold is the FLOOR; request thresholds above it
        # trim in respond().  soft_nms "off" is the reference's hard
        # NMS; max_per_class > 0 caps each class's kept boxes.
        self.detect_decode: str = "device"
        self.detect_topk: int = 100
        self.detect_score_threshold: float = 0.05
        self.detect_iou_threshold: float = 0.5
        self.detect_soft_nms: str = "off"
        self.detect_soft_sigma: float = 0.5
        self.detect_max_per_class: int = 0

    def compile_bucket(self, batch: int, epilogue: bool = True):
        raise NotImplementedError

    def param_bytes(self) -> int:
        """Bytes of the resident weights and buffers: for int8 models the
        int8 codes plus float32 scales, biases and BN statistics."""
        if self._model is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in self._model.state_dict().values()))

    def describe(self) -> dict:
        d = {}
        if self.workload.verb == "detect":
            d["detect"] = {"decode": self.detect_decode,
                           "top_k": self.detect_topk,
                           "score_threshold": self.detect_score_threshold,
                           "iou_threshold": self.detect_iou_threshold,
                           "soft_nms": self.detect_soft_nms,
                           "soft_sigma": self.detect_soft_sigma,
                           "max_per_class": self.detect_max_per_class}
        return {"name": self.name, "task": self.task,
                "workload": self.workload.verb, **d,
                "input_shape": list(self.input_shape),
                "num_classes": self.num_classes,
                "wire_dtype": str(self.wire_dtype),
                "output_wire": self.output_wire,
                "infer_dtype": self.infer_dtype,
                "device": str(self.device),
                "weights": self.weights,
                "params_digest": self.params_digest}


class CheckpointServingModel(ServingModel):
    """An ``nn.Module`` with its weights, served per batch bucket."""

    def __init__(self, name: str, cfg, model: torch.nn.Module,
                 wire_dtype: str = "float32", infer_dtype: str = "float32",
                 calib_batches: int = 2, calib_dir: str | None = None,
                 device=None):
        from deep_vision_tpu_torch.ops.preprocess import serve_preprocess_kind

        # the workload owns the input codec: a latent-in generator takes
        # a (latent_dim,) float32 vector whatever wire was asked
        wl = workload_for_task(cfg.task)
        super().__init__(name, task=cfg.task,
                         input_shape=wl.serving_input_shape(cfg, model),
                         num_classes=cfg.num_classes,
                         wire_dtype=wl.wire_dtype_for(cfg, str(wire_dtype)),
                         infer_dtype=infer_dtype, device=device)
        self.output_wire = wl.output_wire(cfg)
        self.preprocess_kind = serve_preprocess_kind(cfg.task, cfg.channels)
        #: int8 calibration (None outside int8)
        self.quant = None
        model = model.eval().to(self.device)
        if self.infer_dtype == "bfloat16":
            # bf16 compute, and the float PARAMETERS cast once here (the
            # reference casts params; BN running statistics stay float32)
            model.set_compute_dtype(torch.bfloat16)
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
        if self.infer_dtype == "int8":
            from deep_vision_tpu_torch.serve.quant import quantize_for_serving

            self.quant = quantize_for_serving(
                model, kind=self.preprocess_kind,
                input_shape=self.input_shape,
                calib_batches=int(calib_batches), calib_dir=calib_dir,
                device=self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self._model = model

    def describe(self) -> dict:
        d = super().describe()
        if self.quant is not None:
            d["quant"] = dict(self.quant.describe(),
                              param_bytes=self.param_bytes(),
                              ingest="serve_ingest")
        return d

    def compile_bucket(self, batch: int, epilogue: bool = True):
        """The callable of bucket ``batch``; ``epilogue=False`` leaves
        the workload's epilogue out (the profiler times it apart)."""
        from deep_vision_tpu_torch.ops.preprocess import (
            make_int8_ingest,
            make_serve_preprocess,
        )

        wire = self.wire_torch_dtype
        compute = torch.bfloat16 if self.infer_dtype == "bfloat16" \
            else torch.float32
        model = self._model
        if self.infer_dtype == "int8":
            act_scale = float(self.quant.act_scale)
            pre_q = make_int8_ingest(self.preprocess_kind, wire, act_scale)

            def forward(x):
                # int8 activations dequantize into the first conv's
                # input; the weights dequantize inside each layer
                xf = pre_q(x).to(torch.float32) * act_scale
                return model(xf)
        else:
            pre = make_serve_preprocess(self.preprocess_kind, wire, compute)

            def forward(x):
                return model(pre(x))

        post = self.workload.make_epilogue(self) if epilogue else None

        def finish(out):
            out = map_leaves(lambda t: t.to(torch.float32)
                             if t.is_floating_point() else t, out)
            return out if post is None else post(out)

        shape = (batch, *self.input_shape)
        device = self.device
        wire_np = self.wire_dtype

        def call(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x, wire_np))
            if tuple(x.shape) != shape or x.dtype != wire:
                raise ValueError(f"bucket {batch} of '{self.name}' takes "
                                 f"{wire} {list(shape)}, got {x.dtype} "
                                 f"{list(x.shape)}")
            with torch.inference_mode():
                return finish(forward(x.to(device, non_blocking=True)))

        return call


class ModelRegistry:
    def __init__(self):
        self._models: dict[str, ServingModel] = {}

    def add(self, model: ServingModel) -> ServingModel:
        self._models[model.name] = model
        return model

    def load_checkpoint(self, config_name: str, weights: str | None = None,
                        name: str | None = None,
                        wire_dtype: str = "float32",
                        infer_dtype: str = "float32",
                        calib_batches: int = 2,
                        calib_dir: str | None = None,
                        device=None,
                        detect_decode: str = "device",
                        detect_topk: int = 100,
                        detect_score_threshold: float = 0.05,
                        detect_iou_threshold: float = 0.5,
                        detect_soft_nms: str = "off",
                        detect_soft_sigma: float = 0.5,
                        detect_max_per_class: int = 0) -> ServingModel:
        """Build ``config_name``'s model with ``weights`` (a flax-layout
        ``.npz``; None = seeded random init) and serve it on ``device``
        (default cuda).  ``wire_dtype``/``infer_dtype`` as in the module
        docstring; int8 calibrates on ``calib_batches`` batches from
        ``calib_dir`` (deterministic synthetic data when None).

        ``detect_*`` configure a detection model's decode
        (``ServingModel``'s attributes of the same names): ``"device"``
        decodes inside the bucket callables down to ``detect_topk`` rows
        an image, ``"host"`` per request; ``detect_soft_nms``
        ("gaussian"/"linear") switches NMS to Soft-NMS decay with
        ``detect_soft_sigma``, and ``detect_max_per_class`` > 0 caps
        each class's kept boxes.  Other models ignore them."""
        from deep_vision_tpu_torch.core.config import get_config
        from deep_vision_tpu_torch.core.restore import load_state

        if str(detect_decode) not in DETECT_DECODES:
            raise ValueError(f"detect_decode '{detect_decode}' "
                             f"unsupported (have {DETECT_DECODES})")
        if str(detect_soft_nms) not in SOFT_MODES:
            raise ValueError(f"detect_soft_nms '{detect_soft_nms}' "
                             f"unsupported (have {SOFT_MODES})")
        device = resolve_device(device)  # fail before any model work
        cfg = get_config(config_name)
        info: dict = {}
        model = load_state(cfg, weights, info=info)
        sm = CheckpointServingModel(name or config_name, cfg, model,
                                    wire_dtype=wire_dtype,
                                    infer_dtype=infer_dtype,
                                    calib_batches=calib_batches,
                                    calib_dir=calib_dir, device=device)
        sm.weights = info["weights"]
        sm.params_digest = info["digest"]
        sm.detect_decode = str(detect_decode)
        sm.detect_topk = int(detect_topk)
        sm.detect_score_threshold = float(detect_score_threshold)
        sm.detect_iou_threshold = float(detect_iou_threshold)
        sm.detect_soft_nms = str(detect_soft_nms)
        sm.detect_soft_sigma = float(detect_soft_sigma)
        sm.detect_max_per_class = int(detect_max_per_class)
        return self.add(sm)

    def get(self, name: str | None = None) -> ServingModel:
        if name is None:
            if len(self._models) != 1:
                raise KeyError(
                    f"model name required (serving {sorted(self._models)})")
            return next(iter(self._models.values()))
        if name not in self._models:
            raise KeyError(f"unknown model '{name}'; "
                           f"serving {sorted(self._models)}")
        return self._models[name]

    def names(self) -> list[str]:
        return sorted(self._models)
