"""A serving model laid over a ``data × model`` grid of local devices.

The reference serves one model over a 2-D mesh from one process: the
padded batch splits over ``data``, the weights are laid over ``model`` by
the partition rules (``parallel/partition.py``), and GSPMD inserts the
collectives.  The port keeps that shape with one process, one engine and
an explicit grid of ``torch.device``s (``parallel.mesh.LocalMesh``):

* **the data axis**: row ``r`` of the grid takes ``bucket / D`` images;
  its first device runs everything that is not split over ``model``;
* **a kernel sharded on its output features** runs column-parallel: each
  model device computes its slice of output channels from the input
  copied to it, and the slices are concatenated in order on the row's
  first device;
* **a kernel sharded on its input features** runs row-parallel: each
  model device convolves its slice of input channels, the partial
  results are summed in device order on the row's first device, and the
  bias is added once;
* **any other placement** a rule can write (a 1-D leaf, a grouped or
  depthwise kernel, a spatial kernel dim, the ``data`` axis) stays
  sharded at rest, as the reference lays it, and is gathered onto the
  row's first device for each launch;
* a replicated tensor is held once a row, on its first device (the only
  device of the row that reads it).

An int8 weight's per-output-channel scale travels with its codes: a
column shard holds its slice of the scale, a row shard the whole scale.
Every view owns its device storage (``MeshModel``'s tensors), so the
weight cache spills and re-admits each shard on its own device.

Spec checks raise the reference's words (jax's ``device_put`` of a
``NamedSharding``): an axis not in the mesh, a spec longer than the
leaf's rank, a dim not divisible by its axis.
"""

from __future__ import annotations

import contextlib
import copy
import math
import threading

import torch
from torch import nn

from deep_vision_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS


def _mesh_repr(mesh) -> str:
    axes = ", ".join(f"'{k}': {v}" for k, v in mesh.shape.items())
    return f"Mesh({axes})"


def _sharding_repr(mesh, spec: tuple) -> str:
    return (f"NamedSharding(mesh={_mesh_repr(mesh)}, "
            f"spec=PartitionSpec{tuple(spec)!r})")


def check_axes(mesh, spec: tuple) -> None:
    """An axis the mesh lacks raises as jax's ``NamedSharding`` does."""
    names = tuple(mesh.shape)
    seen = set()
    for a in spec:
        if a is None:
            continue
        if not isinstance(a, str):
            raise ValueError(f"partition spec entry {a!r} of "
                             f"PartitionSpec{tuple(spec)!r}: one axis "
                             f"name or None per dim")
        if a not in names:
            raise ValueError(f"Resource axis: {a} of "
                             f"PartitionSpec{tuple(spec)!r} is not found "
                             f"in mesh: {names}.")
        if a in seen:
            raise ValueError(
                f"A single NamedSharding spec specification can map every "
                f"mesh axis to at most one positional dimension, but "
                f"PartitionSpec{tuple(spec)!r} has duplicate entries for "
                f"`{a}`")
        seen.add(a)


def check_fits(mesh, spec: tuple, shape: tuple) -> None:
    """A spec longer than the leaf's rank, or a dim its axis does not
    divide, raises as jax's ``device_put`` does (``shape`` is the flax
    layout's)."""
    ns = _sharding_repr(mesh, spec)
    if len(spec) > len(shape):
        raise ValueError(
            f"One of device_put args is incompatible with its sharding "
            f"annotation {ns}: Sharding {ns} is only valid for values of "
            f"rank at least {len(spec)}, but was applied to a value of "
            f"rank {len(shape)}.")
    for d, a in enumerate(spec):
        if a is not None and shape[d] % mesh.shape[a]:
            raise ValueError(
                f"One of device_put args was given the sharding of {ns}, "
                f"which implies that the global size of its dimension {d} "
                f"should be divisible by {mesh.shape[a]}, but it is equal "
                f"to {shape[d]} (full shape: {tuple(shape)})")


def _on(device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself when it is there already; across two
    cards, the copy waits on an event recorded after ``t``'s producer on
    its own device's current stream."""
    if t.device == device:
        return t
    if t.is_cuda and device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(device).wait_event(ready)
    return t.to(device, non_blocking=t.is_cuda and device.type == "cuda")


class _Spec:
    """One tensor's placement: ``tspec`` is the spec on the port's dims
    (an axis of size 1 dropped), ``mode`` how it runs."""

    def __init__(self, tspec: tuple, mode: str):
        self.tspec = tspec
        self.mode = mode  # replicated | column | row | gathered | shard


def _block(t: torch.Tensor, tspec: tuple, mesh, idx: tuple) -> torch.Tensor:
    """The block of ``t`` that grid position ``idx`` = (data index, model
    index) holds."""
    for dim, axis in enumerate(tspec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        i = idx[0] if axis == DATA_AXIS else idx[1]
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t


def _index(tspec: tuple, r: int, c: int) -> tuple:
    return (r if DATA_AXIS in tspec else 0, c if MODEL_AXIS in tspec else 0)


def _set(module: nn.Module, name: str, value) -> None:
    if name in module._parameters:
        module._parameters[name] = None if value is None else \
            nn.Parameter(value, requires_grad=False)
    else:
        module._buffers[name] = value


class ShardedLayer(nn.Module):
    """A conv or dense layer split over the row's model devices:
    ``mode`` "column" (output features: outputs concatenated) or "row"
    (input features: partial outputs summed in order); the bias, held
    on the row's first device, is added once after the gather."""

    def __init__(self, shards: list, devices: list, mode: str, bias,
                 linear: bool):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.devices = list(devices)
        self.mode = mode
        self.linear = linear
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first = self.devices[0]
        dim = x.dim() - 1 if self.linear else 1
        xs = x.chunk(len(self.shards), dim=dim) if self.mode == "row" \
            else [x] * len(self.shards)
        outs = []
        for sub, dev, xi in zip(self.shards, self.devices, xs):
            with _on(dev):
                outs.append(sub(to_device(xi, dev)))
        outs = [to_device(o, first) for o in outs]
        if self.mode == "column":
            y = torch.cat(outs, dim=dim)
        else:
            y = outs[0]
            for o in outs[1:]:
                y = y + o
        if self.bias is not None:
            b = self.bias.to(y.dtype)
            y = y + (b if self.linear else b.view(1, -1, 1, 1))
        return y


class MeshModel(nn.Module):
    """Every tensor a mesh view holds: one module a data row (``rows``;
    split layers replaced by :class:`ShardedLayer`) and the blocks of the
    gathered leaves (``blocks``).  Its parameters and buffers are the
    view's device storage, which the weight cache spills and
    re-admits."""

    def __init__(self, rows: list, blocks: nn.Module):
        super().__init__()
        self.rows = nn.ModuleList(rows)
        self.blocks = blocks


class MeshLayout:
    """``model`` (a served ``nn.Module``) laid over ``mesh`` by ``specs``
    (flax path → spec, ``partition.param_partition_spec``)."""

    def __init__(self, model: nn.Module, mesh, specs: dict, leaves: list):
        from deep_vision_tpu_torch.models.common import Conv2d, Linear

        self.mesh = mesh
        grid = mesh.devices
        self.n_data, self.n_model = grid.shape
        self.first = [grid[r][0] for r in range(self.n_data)]
        # every tensor the model holds (non-persistent buffers too)
        sd = dict(model.named_parameters())
        sd.update(model.named_buffers())
        for path, leaf in leaves:
            check_axes(mesh, specs.get(path, ()))
        self.specs: dict[str, _Spec] = {}
        for path, leaf in leaves:
            spec = tuple(specs.get(path, ()))
            check_fits(mesh, spec, leaf.shape)
            tspec = [None] * len(leaf.shape)
            for d, axis in enumerate(spec):
                if axis is not None and mesh.shape[axis] > 1:
                    tspec[leaf.dims[d]] = axis
            tspec = tuple(tspec)
            self.specs[leaf.key] = _Spec(
                tspec, "replicated" if not any(tspec) else "gathered")
        # split layers: a kernel sharded on one feature dim over model
        split: dict[str, _Spec] = {}
        for name, mod in model.named_modules():
            s = self.specs.get(f"{name}.weight")
            if s is None or s.mode != "gathered" or \
                    not isinstance(mod, (Conv2d, Linear)) or \
                    getattr(mod, "groups", 1) != 1 or DATA_AXIS in s.tspec:
                continue
            axes = [d for d, a in enumerate(s.tspec) if a is not None]
            if axes in ([0], [1]):
                s.mode = "column" if axes == [0] else "row"
                split[name] = s
                scale = self.specs.get(f"{name}.weight_scale")
                if scale is not None:
                    scale.mode = "shard"  # travels with its codes
        self.chip_bytes, self.global_bytes = self._bytes(model.state_dict())
        #: key → the whole tensor's shape
        self.shapes = {k: tuple(t.shape) for k, t in sd.items()}
        self._locks = [threading.Lock() for _ in range(self.n_data)]
        self.module = self._build(model, sd, split)

    # -- accounting --------------------------------------------------------

    def _bytes(self, sd: dict) -> tuple[int, int]:
        """(per-chip, logical) bytes: a leaf split over an axis prices a
        chip its block, as the reference's ``shard_shape`` does (an int8
        scale by its own spec too); the rest at full size."""
        chip = total = 0
        for key, t in sd.items():
            n = t.numel() * t.element_size()
            total += n
            s = self.specs.get(key)
            parts = 1 if s is None else math.prod(
                self.mesh.shape[a] for a in s.tspec if a is not None)
            chip += n // parts
        return chip, total

    # -- placement ---------------------------------------------------------

    def _build(self, model: nn.Module, sd: dict, split: dict) -> MeshModel:
        grid = self.mesh.devices
        blocks = nn.Module()
        #: row → key → {block index: buffer name in ``blocks``}
        self.block_names: list[dict] = [{} for _ in range(self.n_data)]
        rows = []
        with torch.no_grad():
            for r in range(self.n_data):
                first = self.first[r]
                memo = {}
                for key, t in sd.items():
                    s = self.specs.get(key)
                    if s is None or s.mode == "replicated":
                        new = t.detach().to(first, copy=True)
                    else:
                        new = torch.empty(0, dtype=t.dtype, device=first)
                    if isinstance(t, nn.Parameter):
                        new = nn.Parameter(new, requires_grad=False)
                    memo[id(t)] = new
                    if s is not None and s.mode == "gathered":
                        for c in range(self.n_model):
                            idx = _index(s.tspec, r, c)
                            names = self.block_names[r].setdefault(key, {})
                            if idx in names:
                                continue
                            name = f"b{len(blocks._buffers)}"
                            blocks.register_buffer(name, _block(
                                t.detach(), s.tspec, self.mesh, idx
                            ).to(grid[r][c], copy=True).contiguous())
                            names[idx] = name
                row = copy.deepcopy(model, memo)
                for name, s in split.items():
                    self._split(row, name, s, sd, r)
                rows.append(row)
        return MeshModel(rows, blocks)

    def _split(self, row: nn.Module, name: str, s: _Spec, sd: dict,
               r: int) -> None:
        from deep_vision_tpu_torch.models.common import Linear

        grid = self.mesh.devices
        parent_name, _, attr = name.rpartition(".")
        parent = row.get_submodule(parent_name) if parent_name else row
        layer = getattr(parent, attr)
        w = sd[f"{name}.weight"].detach()
        scale = sd.get(f"{name}.weight_scale")
        shards = []
        for c in range(self.n_model):
            dev = grid[r][c]
            sub = copy.deepcopy(layer)
            _set(sub, "weight",
                 _block(w, s.tspec, self.mesh, (0, c)).to(
                     dev, copy=True).contiguous())
            if scale is not None:
                sc = scale.detach()
                if s.mode == "column":
                    sc = sc.chunk(self.n_model)[c]
                _set(sub, "weight_scale", sc.to(dev, copy=True).contiguous())
            if "bias" in sub._parameters:
                _set(sub, "bias", None)
            shards.append(sub)
        # the row's own copy of the bias (or its placeholder when the
        # bias is gathered at use)
        bias = layer._parameters.get("bias")
        setattr(parent, attr, ShardedLayer(
            shards, [grid[r][c] for c in range(self.n_model)], s.mode,
            None if bias is None else bias.detach(),
            isinstance(layer, Linear)))

    # -- execution ---------------------------------------------------------

    def gathered(self, r: int) -> dict:
        """key → the whole tensor on row ``r``'s first device, for every
        leaf held sharded at rest (read from whichever row holds each
        block: a leaf split over ``data`` spans the rows)."""
        module = self.module
        out = {}
        first = self.first[r]
        for key, s in self.specs.items():
            if s.mode != "gathered":
                continue
            nd = self.n_data if DATA_AXIS in s.tspec else 1
            nm = self.n_model if MODEL_AXIS in s.tspec else 1
            parts = []
            for i in range(nd):
                names = self.block_names[i if nd > 1 else r][key]
                cols = [to_device(module.blocks._buffers[names[(i, j)]],
                                  first) for j in range(nm)]
                parts.append(_cat(cols, s.tspec, MODEL_AXIS))
            out[key] = _cat(parts, s.tspec, DATA_AXIS)
        return out

    def run_row(self, r: int, x: torch.Tensor):
        """Row ``r``'s forward of its shard ``x`` (on its first device)."""
        row = self.module.rows[r]
        tensors = self.gathered(r)
        if not tensors:
            return row(x)
        with self._locks[r]:
            return torch.func.functional_call(row, tensors, (x,),
                                               strict=False)


def _cat(parts: list, tspec: tuple, axis: str) -> torch.Tensor:
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=tspec.index(axis))
