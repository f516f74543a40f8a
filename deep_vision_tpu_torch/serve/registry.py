"""Model registry: name → ServingModel with per-bucket forward callables.

Port of ``deep_vision_tpu/serve/registry.py`` (``ServingModel``,
``CheckpointServingModel``, ``ModelRegistry`` with versions).  The
engine asks ``compile_bucket(b)`` for a callable that takes a padded
batch of exactly ``b`` inputs; the model decides how it runs.  A model
loads from a training workdir (``load_checkpoint(name, workdir=...)``,
the newest complete step, ``core/restore.py``), a ``.npz`` of the
reference's flax tree, or a seeded random init.

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
  * it runs eagerly (CUDA graphs per bucket come in a later slice);
  * it reads the model's weights through ``weights_in_use``: under the
    control plane's ``WeightCache`` (serve/models.py) the weights may
    have been evicted to a host copy since the callable was built, and
    are re-admitted into fresh device storage on the caller's stream
    before the forward, so no callable is ever rebuilt for residency;
  * it carries ``cost_flops`` and ``flops_source``: the bucket's FLOPs
    (one image's, counted once a model by ``obs/mfu.py``, times the
    bucket), the serving-MFU numerator.

Replicas (``serve/replicas.py``): ``for_device(device)`` is a per-device
view of a checkpoint model that owns its own copy of the weights on
``device``, made once when the replica is built, never per batch; its
bucket callables run there.  Two views on one CUDA device hold two
copies.  The base model is left as it was.

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

import contextlib
import threading

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
        #: where the weights came from: an npz (``weights``) or a
        #: workdir's checkpoint step (``restored_step``, None for random
        #: init, with ``restore_fallback`` when a newer step was torn and
        #: the step directory's ``restored_mtime``, and ``restored_ema``,
        #: which copy of the checkpoint serves: its params EMA or the
        #: trained weights), and their byte digest (core/restore.py)
        self.weights: str | None = None
        self.restored_step: int | None = None
        self.restore_fallback = False
        self.restored_mtime: float | None = None
        self.restored_ema: str | None = None
        self.params_digest: str | None = None
        #: version number under the control plane (serve/models.py)
        self.serve_version: int | None = None
        #: cascade front-tier knob (serve/cascade.py): K > 0 fuses the
        #: classify workload's softmax + top-K confidence epilogue into
        #: this model's bucket callables, so the router reads the top-1
        #: off a 3·K-scalar row instead of dense logits; 0 = dense rows
        self.cascade_topk: int = 0
        self._model: torch.nn.Module | None = None
        # weight residency (serve/models.py WeightCache): the cache that
        # manages this model, the host copy of every parameter and
        # buffer once spilled, whether the device copy is live, the
        # event a readmit's copies end at, and every CUDA stream that
        # ran this model (their work must finish before an evicted
        # storage is reused: record_stream)
        self._cache = None
        self._host_weights: list[torch.Tensor] | None = None
        self._resident = True
        self._weights_ready = None
        self._streams: dict[int, torch.cuda.Stream] = {}
        self._residency_lock = threading.Lock()
        # (FLOPs of one image, source), counted at the first bucket built
        self._image_flops: tuple[float | None, str] | None = None
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
        """Bytes the weights and buffers take on the device when
        resident: for int8 models the int8 codes plus float32 scales,
        biases and BN statistics.  The weight cache's unit."""
        if self._model is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in self._model.state_dict().values()))

    # -- weight residency ----------------------------------------------------

    def _tensors(self) -> list[torch.Tensor]:
        return list(self._model.parameters()) + list(self._model.buffers())

    def spill_weights(self) -> int:
        """Point every parameter and buffer at its host copy (made on the
        first spill, pinned on CUDA, and kept: the weights never change
        after load) and drop the device storage.  Storage that a stream
        which ran this model may still read is handed back to the
        caching allocator only after that stream's queued work
        (``record_stream``).  Returns the bytes newly copied to the
        host (0 after the first spill)."""
        tensors = self._tensors()
        copied = 0
        on_cuda = self.device.type == "cuda"
        if self._host_weights is None:
            if on_cuda:
                torch.cuda.synchronize(self.device)  # every writer done
            self._host_weights = [
                torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                    device="cpu", pin_memory=on_cuda
                                    ).copy_(t) for t in tensors]
            copied = sum(t.numel() * t.element_size() for t in tensors)
        streams = list(self._streams.values()) if on_cuda else []
        for t, host in zip(tensors, self._host_weights):
            for s in streams:
                t.data.record_stream(s)
            t.data = host
        self._resident = False
        self._weights_ready = None
        return copied

    def admit_weights(self) -> None:
        """Copy the host copy into fresh device storage on the caller's
        current stream (``non_blocking``: the copies queue ahead of the
        forward on that stream; other streams wait on
        ``_weights_ready``).  A failed allocation raises: the model never
        serves from host weights."""
        on_cuda = self.device.type == "cuda"
        for t, host in zip(self._tensors(), self._host_weights):
            dev = torch.empty_strided(host.size(), host.stride(),
                                      dtype=host.dtype, device=self.device)
            dev.copy_(host, non_blocking=on_cuda)
            t.data = dev
        if on_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            self._weights_ready = ready
        self._resident = True

    def release_device_weights(self) -> None:
        """Free the device copy of a retired version's weights (they stay
        on the host): versions kept for observability cost host RAM,
        never device memory.  A later call re-admits them."""
        with self._residency_lock:
            if self._model is not None and self._resident:
                self.spill_weights()

    @contextlib.contextmanager
    def weights_in_use(self):
        """The weights resident on the device for the duration of one
        launch: admitted through the cache (which will not evict them
        until the block exits) or re-admitted after a release, and the
        current stream made to wait for a readmit's copies."""
        cache = self._cache
        pinned = cache is not None and cache.pin(self)
        if not pinned and not self._resident:
            with self._residency_lock:
                if not self._resident:
                    self.admit_weights()
        try:
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                self._streams.setdefault(stream.cuda_stream, stream)
                ready = self._weights_ready
                if ready is not None:
                    stream.wait_event(ready)
            yield
        finally:
            if pinned:
                cache.unpin(self)

    def placement_desc(self) -> str:
        """Where this model's weights and batches live (stats and
        health name each replica's device with it)."""
        return str(self.device)

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
                "restored_step": self.restored_step,
                "restore_fallback": self.restore_fallback,
                "restored_mtime": self.restored_mtime,
                "restored_ema": self.restored_ema,
                "params_digest": self.params_digest,
                "version": self.serve_version}


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
        self.cfg = cfg
        #: calibration provenance, reused when a reload recalibrates
        self.calib_batches = int(calib_batches)
        self.calib_dir = calib_dir
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

    def for_device(self, device) -> "CheckpointServingModel":
        """A replica view on ``device``: the same metadata, calibration
        and decode knobs, and its OWN copy of the network and its
        weights there, copied from this model once, here.  The view
        keeps its own residency state (its weights are registered with
        the weight cache apart from this model's, and released apart:
        ``release_device_weights``); this model is left untouched."""
        import copy

        device = resolve_device(device)
        view = copy.copy(self)
        view.device = device
        view._host_weights = None
        view._resident = True
        view._weights_ready = None
        view._streams = {}
        view._residency_lock = threading.Lock()
        view._cache = None  # registered by whoever budgets the replica
        with self.weights_in_use(), torch.no_grad():
            view._model = copy.deepcopy(self._model).to(device)
        return view

    def _bucket_flops(self, batch: int) -> tuple[float | None, str]:
        """(FLOPs of bucket ``batch``, their source).  The model's FLOPs
        are counted once, on one zero image of what the model itself
        takes, and scaled by the batch: the convolutions and matmuls
        ``FlopCounterMode`` counts are linear in it.  The ingest is left
        out (it launches the serve_ingest kernel, and its few operations
        an element are no FLOPs a peak is quoted in).  The first
        ``FlopCounterMode`` of a process also pays for torch's lazy
        imports behind it (seconds, once a process, at the first bucket
        built)."""
        from deep_vision_tpu_torch.obs.mfu import (
            bucket_flops,
            params_flops_lower_bound,
        )

        if self._image_flops is None:
            feed = torch.bfloat16 if self.infer_dtype == "bfloat16" \
                else torch.float32
            image = torch.zeros((1, *self.input_shape), dtype=feed,
                                device=self.device)
            try:
                with self.weights_in_use():
                    self._image_flops = (bucket_flops(self._model, image),
                                         "flop_counter")
            except Exception:  # noqa: BLE001 — the count is best effort; the fallback is labelled
                self._image_flops = (None, "params_lower_bound")
        per_image, source = self._image_flops
        if per_image is None:
            return params_flops_lower_bound(self._model, batch), \
                "params_lower_bound"
        return per_image * batch, source

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
        owner = self

        def call(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x, wire_np))
            if tuple(x.shape) != shape or x.dtype != wire:
                raise ValueError(f"bucket {batch} of '{self.name}' takes "
                                 f"{wire} {list(shape)}, got {x.dtype} "
                                 f"{list(x.shape)}")
            with owner.weights_in_use(), torch.inference_mode():
                return finish(forward(x.to(device, non_blocking=True)))

        call.cost_flops, call.flops_source = owner._bucket_flops(batch)
        return call


class ModelRegistry:
    def __init__(self):
        self._models: dict[str, ServingModel] = {}
        # name → version → ServingModel: the control plane publishes
        # each promoted version here, so ``get(name, version=N)``
        # answers for any retained version
        self._versions: dict[str, dict[int, ServingModel]] = {}

    def add(self, model: ServingModel,
            version: int | None = None) -> ServingModel:
        self._models[model.name] = model
        if version is None:
            version = model.serve_version
        if version is not None:
            self._versions.setdefault(model.name, {})[int(version)] = model
        return model

    def remove_version(self, name: str, version: int) -> None:
        """Forget one retained version (the plane prunes retired versions
        past its retain window, so these refs don't pin them)."""
        table = self._versions.get(name)
        if table is not None:
            table.pop(int(version), None)
            if not table:
                self._versions.pop(name, None)

    def load_checkpoint(self, config_name: str, weights: str | None = None,
                        name: str | None = None,
                        wire_dtype: str = "float32",
                        infer_dtype: str = "float32",
                        calib_batches: int = 2,
                        calib_dir: str | None = None,
                        device=None,
                        workdir: str | None = None,
                        cascade_topk: int = 0,
                        detect_decode: str = "device",
                        detect_topk: int = 100,
                        detect_score_threshold: float = 0.05,
                        detect_iou_threshold: float = 0.5,
                        detect_soft_nms: str = "off",
                        detect_soft_sigma: float = 0.5,
                        detect_max_per_class: int = 0) -> ServingModel:
        """Build ``config_name``'s model with ``weights`` (a flax-layout
        ``.npz``), or from ``workdir`` (a training workdir of the port:
        its newest restorable checkpoint), or a seeded random init with
        neither, and serve it on ``device`` (default cuda).  ``wire_dtype``/``infer_dtype`` as in the module
        docstring; int8 calibrates on ``calib_batches`` batches from
        ``calib_dir`` (deterministic synthetic data when None).
        ``cascade_topk`` > 0 marks a cascade front tier: the classify
        workload fuses its confidence epilogue (softmax + top-K on the
        device) into the bucket callables (serve/cascade.py).

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
        model = load_state(cfg, weights, workdir=workdir, tag="serve",
                           info=info)
        sm = CheckpointServingModel(name or config_name, cfg, model,
                                    wire_dtype=wire_dtype,
                                    infer_dtype=infer_dtype,
                                    calib_batches=calib_batches,
                                    calib_dir=calib_dir, device=device)
        stamp_restore(sm, info)
        sm.cascade_topk = int(cascade_topk)
        sm.detect_decode = str(detect_decode)
        sm.detect_topk = int(detect_topk)
        sm.detect_score_threshold = float(detect_score_threshold)
        sm.detect_iou_threshold = float(detect_iou_threshold)
        sm.detect_soft_nms = str(detect_soft_nms)
        sm.detect_soft_sigma = float(detect_soft_sigma)
        sm.detect_max_per_class = int(detect_max_per_class)
        return self.add(sm)

    def get(self, name: str | None = None,
            version: int | None = None) -> ServingModel:
        """The model ``name`` (required when more than one is served), or
        its retained ``version``; a miss raises ``KeyError`` whose
        ``args[0]`` is the message."""
        if name is None:
            if len(self._models) != 1:
                raise KeyError(
                    f"model name required (serving {sorted(self._models)})")
            name = next(iter(self._models))
        if name not in self._models:
            raise KeyError(f"unknown model '{name}'; "
                           f"serving {sorted(self._models)}")
        if version is not None:
            table = self._versions.get(name, {})
            if int(version) not in table:
                raise KeyError(f"model '{name}' has no version {version}; "
                               f"versions {sorted(table)}")
            return table[int(version)]
        return self._models[name]

    def names(self) -> list[str]:
        return sorted(self._models)


def stamp_restore(sm: ServingModel, info: dict) -> None:
    """Copy ``load_state``'s ``info`` onto the serving model."""
    sm.weights = info["weights"]
    sm.restored_step = info["step"]
    sm.restore_fallback = bool(info["fallback"])
    sm.restored_mtime = info["mtime"]
    sm.restored_ema = info["ema"]
    sm.params_digest = info["digest"]
