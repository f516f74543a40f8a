"""Pipeline parallelism as a training mode: a stem and ``S`` same-shape
stages as one ``nn.Module``, the stages run as a GPipe microbatch
pipeline over a rank's ``pipe`` places (``parallel/pipeline.py``).

Port of ``deep_vision_tpu/parallel/pipelined.py``.
``cli.train -m hourglass104 --mesh data=d,pipe=p`` trains the Stacked
Hourglass (or CenterNet) with its stacks split over the ``p`` places of
each rank: place ``k`` holds stages ``k·S/p … (k+1)·S/p − 1``, their
parameters, optimizer state and activations, and the stem sits on place
0.  The Trainer (``core/trainer.py``) uses the model unchanged, but lets
it place itself (:meth:`PipelinedModel.place`).

As in the reference:

* the stem runs ahead of the pipeline on the rank's whole batch, and
  its BatchNorm normalizes by the global batch across the data ranks
  (the reference's stem runs under GSPMD): :meth:`batchnorm_mesh_root`
  points ``models/common.set_batchnorm_mesh`` at the stem alone;
* a stage's BatchNorm normalizes by its microbatch of the rank's shard,
  and its running statistics move once a microbatch, then are averaged
  over the data ranks at the end of each training forward (the
  reference's ``pmean`` over ``data``);
* with ``num_microbatches = 1`` on ``data = 1`` both regimes are the
  monolithic network's, so the pipelined step is the monolithic step;
* ``num_microbatches`` defaults to the pipe size, and a smaller batch
  (the last eval batch) takes the largest ``M`` that divides it
  (:meth:`_microbatches_for`);
* checkpoints hold the pipelined layout (``stem.*``, ``stages.<s>.*``);
  :meth:`export_monolithic_variables` merges it into the family's
  monolithic ``state_dict`` (``models/hourglass.merge_stacked_variables``,
  ``models/centernet.merge_centernet_variables``), which serving loads
  (``core/restore.py``), and :meth:`import_monolithic_variables` splits
  a monolithic one in.

Every stage has one structure, so the last stage keeps re-injection
convs the monolithic network does not have: computed, never used
downstream, given no gradient, and dropped by the merge.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
from torch import nn

from deep_vision_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS
from deep_vision_tpu_torch.parallel.pipeline import pipeline_apply


@dataclasses.dataclass(frozen=True)
class _Family:
    """A stacked family: its configuration read off the monolithic model
    (``arch``), its stem and stage modules, its init (in module order),
    its layout maps and the walkers of its flax tree (``convert.py``)."""
    name: str
    arch: Callable        # monolithic model -> dict of the stage's kwargs
    stem: Callable        # (filters, dtype) -> stem module
    stage: Callable       # (**arch, reinject, dtype) -> stage module
    reset: Callable       # (module, generator) -> None
    merge: Callable       # pipelined state_dict -> monolithic state_dict
    split: Callable       # (monolithic state_dict, template) -> pipelined
    flax_stem: Callable   # (prefix, filters) -> the stem's flax leaves
    flax_stage: Callable  # (prefix, **arch) -> a stage's flax leaves


@functools.cache
def families() -> dict:
    """The stacked families, keyed by their monolithic class."""
    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.models import centernet as cn
    from deep_vision_tpu_torch.models import hourglass as hg

    return {
        hg.StackedHourglass: _Family(
            "StackedHourglass",
            lambda m: dict(num_heatmap=m.num_heatmap, filters=m.filters,
                           num_residual=m.num_residual, order=m.order),
            hg.HourglassStem, hg.HourglassStack,
            hg.reset_hourglass_parameters,
            lambda sd: hg.merge_stacked_variables(sd, hg.num_stages(sd)),
            hg.split_stacked_variables,
            convert.hourglass_stem_leaves, convert.hourglass_stage_leaves),
        cn.CenterNet: _Family(
            "CenterNet",
            lambda m: dict(num_classes=m.num_classes, order=m.order,
                           filters=m.filters),
            cn.CenterNetStem, cn.CenterNetStack,
            cn.reset_centernet_parameters,
            lambda sd: cn.merge_centernet_variables(sd, hg.num_stages(sd)),
            cn.split_centernet_variables,
            convert.centernet_stem_leaves, convert.centernet_stage_leaves),
    }


def family_of(model: nn.Module) -> _Family | None:
    """The stacked family of a monolithic model, or None."""
    return families().get(type(model))


class PipelinedModel(nn.Module):
    """Stem + ``num_stages`` same-shape stages as one model; ``forward``
    takes the family's NHWC input and returns its tuple of per-stage
    outputs on the first place."""

    def __init__(self, stem: nn.Module, stages: list, mesh,
                 num_microbatches: int | None = None,
                 family: _Family | None = None, arch: dict | None = None):
        super().__init__()
        if PIPE_AXIS not in mesh.shape:
            raise ValueError(f"mesh {dict(mesh.shape)} has no "
                             f"'{PIPE_AXIS}' axis")
        pipe = int(mesh.shape[PIPE_AXIS])
        if len(stages) % pipe:
            raise ValueError(
                f"num_stages={len(stages)} not divisible by pipe axis "
                f"size {pipe}")
        self.stem = stem
        self.stages = nn.ModuleList(stages)
        self.num_stages = len(stages)
        self.num_microbatches = num_microbatches or max(pipe, 1)
        self.mesh = mesh
        self.family = family
        self.arch = arch

    # ------------------------------------------------------ constructors

    @classmethod
    def _of_family(cls, model, mesh, num_microbatches: int | None):
        """The pipelined counterpart of ``model`` (its structure: weights
        come from :meth:`reset_parameters` or
        :meth:`import_monolithic_variables`)."""
        fam = family_of(model)
        dt = model.compute_dtype
        arch = fam.arch(model)
        stages = [fam.stage(**arch, reinject=True, dtype=dt)
                  for _ in range(model.num_stack)]
        return cls(fam.stem(model.filters, dt), stages, mesh,
                   num_microbatches, fam, arch)

    @classmethod
    def from_stacked_hourglass(cls, model, mesh,
                               num_microbatches: int | None = None):
        """The pipelined counterpart of a monolithic
        :class:`~deep_vision_tpu_torch.models.hourglass.StackedHourglass`."""
        from deep_vision_tpu_torch.models.hourglass import StackedHourglass

        if not isinstance(model, StackedHourglass):
            raise TypeError(
                f"from_stacked_hourglass needs a StackedHourglass; "
                f"got {type(model).__name__}")
        return cls._of_family(model, mesh, num_microbatches)

    @classmethod
    def from_centernet(cls, model, mesh, num_microbatches: int | None = None):
        """The pipelined counterpart of a monolithic
        :class:`~deep_vision_tpu_torch.models.centernet.CenterNet`."""
        from deep_vision_tpu_torch.models.centernet import CenterNet

        if not isinstance(model, CenterNet):
            raise TypeError(
                f"from_centernet needs a CenterNet; "
                f"got {type(model).__name__}")
        return cls._of_family(model, mesh, num_microbatches)

    @classmethod
    def for_model(cls, model, mesh, num_microbatches: int | None = None):
        """Dispatch on the monolithic model's family (what ``cli.train``
        uses: any stacked family a config builds)."""
        if family_of(model) is None:
            raise TypeError(
                f"pipeline training mode supports the stacked-hourglass "
                f"families (StackedHourglass, CenterNet); "
                f"got {type(model).__name__}")
        return cls._of_family(model, mesh, num_microbatches)

    # --------------------------------------------------------- placement

    @property
    def places(self) -> list[torch.device]:
        return self.mesh.pipe_devices

    def stage_place(self, s: int) -> torch.device:
        """The place of stage ``s``: ``s // (S/p)``."""
        return self.places[s // (self.num_stages // len(self.places))]

    def place(self) -> "PipelinedModel":
        """Move the stem to the first place and each stage to its own
        (channels_last on a card), holding each tensor once."""
        def put(module, dev):
            module.to(dev)
            if dev.type == "cuda":
                module.to(memory_format=torch.channels_last)

        put(self.stem, self.places[0])
        for s, stage in enumerate(self.stages):
            put(stage, self.stage_place(s))
        return self

    def batchnorm_mesh_root(self) -> nn.Module:
        """The modules whose BatchNorm normalizes across the data ranks:
        the stem alone (the stages normalize by their microbatch)."""
        return self.stem

    def set_compute_dtype(self, dtype: torch.dtype) -> "PipelinedModel":
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        return self

    def reset_parameters(self, generator: torch.Generator
                         ) -> "PipelinedModel":
        """The family's init in module order (the stem, then the stages):
        every tensor the monolithic network has draws what the
        monolithic init from the same generator draws."""
        self.family.reset(self, generator)
        return self

    # ----------------------------------------------------------- forward

    def _microbatches_for(self, batch: int) -> int:
        """The largest ``M ≤ num_microbatches`` dividing the rank's
        ``batch`` (an eval batch may be smaller)."""
        m = max(1, min(self.num_microbatches, batch))
        while batch % m:
            m -= 1
        return m

    def forward(self, x: torch.Tensor) -> tuple:
        """NHWC ``(B, H, W, 3)`` → the family's tuple of per-stage
        outputs (float32 NHWC), in batch order on the first place."""
        carry = self.stem(x.to(self.places[0]))
        outs = pipeline_apply(self.stages, carry, self.mesh,
                              self._microbatches_for(int(x.shape[0])))
        if self.training and self.mesh.reduces:
            self._average_stage_stats()
        return tuple(outs)

    @torch.no_grad()
    def _average_stage_stats(self) -> None:
        """The stages' running statistics as their mean over the data
        ranks (the reference's ``pmean`` over ``data``)."""
        bufs = [b for n, b in self.stages.named_buffers()
                if n.endswith(("running_mean", "running_var"))]
        for b, avg in zip(bufs, self.mesh.mean_(bufs)):
            b.copy_(avg)

    # ------------------------------------------------------------ layout

    def import_monolithic_variables(self, state_dict: dict
                                    ) -> "PipelinedModel":
        """Load a monolithic ``state_dict`` of the family (the last
        stage's re-injection from this model's own tensors)."""
        sd = self.family.split(dict(state_dict), self.state_dict())
        self.load_state_dict(sd, strict=True)
        return self

    def export_monolithic_variables(self, state_dict: dict | None = None
                                    ) -> dict:
        """This model's (or a pipelined ``state_dict``'s) tensors in the
        monolithic layout, copied to the CPU: what ``cli.infer`` and
        serving load."""
        sd = self.state_dict() if state_dict is None else state_dict
        return {k: v.detach().to("cpu", copy=True) for k, v in
                self.family.merge(dict(sd)).items()}


def is_pipelined_state(state_dict) -> bool:
    """Whether a ``state_dict`` holds the pipelined layout: every key
    under ``stem.`` or ``stages.``, and both present (the reference's
    top-level ``{stem, stages}``; a ShuffleNet's ``stem.``/``stages.``
    sit beside its ``fc.``)."""
    keys = list(state_dict)
    return all(k.startswith(("stem.", "stages.")) for k in keys) and \
        any(k.startswith("stem.") for k in keys) and \
        any(k.startswith("stages.") for k in keys)


def monolithic_state_dict(model: nn.Module, state_dict: dict) -> dict:
    """A pipelined ``state_dict`` merged into the layout of ``model``, a
    monolithic network of its family (the reference's
    ``restore_pipelined``); raises ``TypeError`` for another family."""
    fam = family_of(model)
    if fam is None:
        raise TypeError(f"checkpoint stores a pipeline layout but the "
                        f"config builds no pipelined family: "
                        f"{type(model).__name__}")
    return fam.merge(state_dict)


__all__ = ["DATA_AXIS", "PIPE_AXIS", "PipelinedModel",
           "is_pipelined_state", "monolithic_state_dict"]
