"""Model export: the eval forward as a ``torch.export`` archive (``.pt2``).

Port of ``deep_vision_tpu/core/export.py``, where ``jax.export``
serializes the jitted forward to StableHLO.  Here ``torch.export``
traces the eval forward at one fixed input shape (batch included),
float32, on host-normalized input, into an ATen graph that reloads
without the Python model code (``cli.infer export``; ``cli.serve
--stablehlo`` serves it).  As in the reference, the served weights come
from the workdir at load time (``load_exported(path, weights=)``), not
from the archive's own copy.
"""

from __future__ import annotations

import os

import torch


def _signature(program) -> tuple:
    """(every input spec's kind, name and target; the user input's shape
    and dtype) of an ``ExportedProgram``."""
    specs = [(str(s.kind), s.arg.name, s.target)
             for s in program.graph_signature.input_specs]
    users = set(program.graph_signature.user_inputs)
    shapes = [(tuple(n.meta["val"].shape), n.meta["val"].dtype)
              for n in program.graph.nodes
              if n.op == "placeholder" and n.name in users]
    return specs, shapes


def export_forward(model: torch.nn.Module, state_dict, input_shape,
                   path: str) -> int:
    """Trace ``model``'s eval forward with ``state_dict`` loaded (None:
    its own weights), at the float32 NHWC ``input_shape`` (batch
    included), on the model's device, and write the archive to
    ``path``.  The bytes written are read back and checked: the same
    input signature and the same parameter and buffer names, or
    ``ValueError``.  Returns the byte count."""
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.eval()
    device = next(model.parameters()).device
    x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    # the loader loads the workdir's weights by name into the archive's
    # module, so the archive is servable only if its signature and its
    # names survive the round trip: check the bytes being shipped
    reloaded = torch.export.load(path)
    if (_signature(reloaded) != _signature(program)
            or list(reloaded.state_dict) != list(program.state_dict)):
        raise ValueError(
            f"the exported program does not round-trip through "
            f"torch.export.save/load: signature {_signature(program)} "
            f"reloaded as {_signature(reloaded)}")
    return os.path.getsize(path)


def load_exported(path: str, weights=None, device=None):
    """Load an archive of :func:`export_forward`; returns a callable
    ``x -> outputs`` on ``device`` (the archive's own by default) that
    carries ``input_shape`` (batch included), ``fixed_batch``,
    ``param_names`` and ``module``.  ``weights`` (a ``state_dict``, e.g.
    the workdir's) replace the archive's own copy; names and shapes must
    agree."""
    program = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    module = program.module()
    if weights is not None:
        module.load_state_dict(weights, strict=True)
    (input_shape, _), = _signature(program)[1]

    def call(x):
        return module(x)

    call.module = module
    call.input_shape = input_shape
    call.fixed_batch = int(input_shape[0])
    call.param_names = list(program.state_dict)
    return call
