"""Parameter partitioning for the ``model`` mesh axis (tensor parallelism).

Port of ``deep_vision_tpu/parallel/partition.py``.  Two mechanisms,
layered as in the reference:

  * **Regex rule tables** (``match_partition_rules``): an ordered list of
    ``(regex, spec)`` pairs matched with ``re.search`` against each
    leaf's ``/``-joined path (``params/Dense_0/kernel``).  First match
    wins; ``strict=True`` demands that every leaf match EXACTLY one
    rule.  ``RULE_TABLES`` / ``rules_for`` hold the built-in tables.
  * **First-divisible-axis fallback** (``first_divisible_spec``): with no
    table, shard the first dim (scanning trailing→leading, so output
    features keep priority) that is ≥ ``min_shard_dim`` and divisible by
    the ``model`` axis; every leaf left whole above the threshold is
    logged (``partition_replicated``).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one axis
name (or None) per leading dim, ``()`` for a replicated leaf — what
``parallel.mesh.batch_sharding`` returns too.

The rules speak the reference's namespace.  A port model's tensors are
named by the flax path its family's converter gives them
(``convert.flax_leaf_map``: the strict ``*_to_flax`` converters run on
tagged tensors), and the specs index FLAX-layout dims: a conv kernel
``(kH, kW, I, O)`` is the port's ``(O, I, kH, kW)`` weight, a dense kernel
``(I, O)`` the port's ``(O, I)``; an int8 weight's per-output-channel
scale is the reference's ``param_scales/<path>/kernel``.  So one
``--partition-rules`` string lays the same leaves in both packages.
``serve/mesh_view.py`` places and runs what the specs say.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import numpy as np

from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.parallel.mesh import MODEL_AXIS

_log = get_logger("dvt.parallel.partition")


def P(*axes) -> tuple:
    """The reference's ``PartitionSpec(*axes)`` as a tuple."""
    return tuple(axes)

#: flax dim → port (torch) dim, by rank: a conv kernel HWIO ↔ OIHW, a
#: dense kernel (in, out) ↔ (out, in); lower ranks keep their dims
FLAX_TO_TORCH_DIMS = {4: (2, 3, 1, 0), 2: (1, 0), 1: (0,), 0: ()}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One tensor of a port model under its flax path: ``key`` is its
    ``state_dict`` name, ``shape`` the flax-layout shape, ``dims[d]`` the
    port dim of flax dim ``d``."""

    key: str
    tensor: Any
    shape: tuple
    dims: tuple

    @property
    def dtype(self):
        return self.tensor.dtype


def _module_leaves(model) -> list[tuple[str, Leaf]]:
    from deep_vision_tpu_torch.convert import flax_leaf_map

    sd = model.state_dict()
    out = []
    for key, path in flax_leaf_map(model).items():
        t = sd[key]
        dims = FLAX_TO_TORCH_DIMS[t.dim()]
        shape = tuple(int(t.shape[td]) for td in dims)
        out.append((path, Leaf(key, t, shape, dims)))
    return sorted(out, key=lambda kv: kv[0].split("/"))


def _dict_leaves(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    out = []
    for k in sorted(tree, key=str):  # jax flattens dicts in key order
        v = tree[k]
        if isinstance(v, dict):
            out += _dict_leaves(v, prefix + (str(k),))
        else:
            out.append(("/".join(prefix + (str(k),)), v))
    return out


def leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    """``/``-joined leaf names paired with leaves (``params/Dense_0/kernel``)
    — the namespace the rule regexes match.  A nested dict flattens in
    key order as jax flattens it; a port ``nn.Module`` gives its tensors
    as :class:`Leaf` records under their flax paths, in the same order."""
    if hasattr(tree, "state_dict") and hasattr(tree, "named_modules"):
        return _module_leaves(tree)
    return _dict_leaves(tree)


def _shape(leaf) -> tuple:
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


def _is_scalar(leaf) -> bool:
    shape = _shape(leaf)
    return len(shape) == 0 or int(np.prod(shape)) == 1


def _rebuild(tree: Any, specs: list) -> Any:
    """The specs in ``tree``'s structure: a nested dict for a dict, a
    ``{path: spec}`` dict for a module."""
    names = [n for n, _ in leaf_paths(tree)]
    if not isinstance(tree, dict):
        return dict(zip(names, specs))
    out: dict = {}
    for name, spec in zip(names, specs):
        node = out
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = spec
    return out


def spec_leaves(specs: Any) -> list[tuple[str, tuple]]:
    """``(path, spec)`` pairs of a spec tree (nested or flat dict)."""
    if all(isinstance(v, tuple) for v in specs.values()):
        return sorted(specs.items(), key=lambda kv: kv[0].split("/"))
    return _dict_leaves(specs)


def match_partition_rules(rules: Sequence[tuple[str, tuple]], params: Any,
                          *, strict: bool = False) -> Any:
    """Map an ordered ``(regex, spec)`` table over ``params``.

    Each leaf's ``/``-joined path is matched with ``re.search``.  Scalars
    (and 1-element leaves) always replicate — no rule needed.  Default:
    first match wins, an unmatched leaf replicates.  ``strict=True`` is
    the exact-layout contract: every non-scalar leaf must match EXACTLY
    one rule — zero matches or an overlap raise ``ValueError`` naming
    the leaf and the offending rules."""
    compiled = [(re.compile(pat), pat, spec) for pat, spec in rules]
    specs = []
    for name, leaf in leaf_paths(params):
        if _is_scalar(leaf):
            specs.append(P())
            continue
        hits = [(pat, spec) for rx, pat, spec in compiled
                if rx.search(name)]
        if strict and len(hits) != 1:
            if not hits:
                raise ValueError(
                    f"strict partition rules: leaf '{name}' "
                    f"{_shape(leaf)} matches no rule "
                    f"(table: {[pat for _, pat, _ in compiled]})")
            raise ValueError(
                f"strict partition rules: leaf '{name}' matches "
                f"{len(hits)} rules {[pat for pat, _ in hits]} — each "
                f"leaf must match exactly one")
        specs.append(tuple(hits[0][1]) if hits else P())
    return _rebuild(params, specs)


def first_divisible_spec(shape: tuple, n_model: int,
                         min_shard_dim: int = 1024) -> tuple:
    """The fallback sharder: shard the first dim (trailing→leading, so
    output features keep priority) that is ≥ ``min_shard_dim`` AND
    divisible by the ``model`` axis; replicate when none qualifies."""
    if n_model <= 1 or len(shape) < 2:
        return P()
    for dim in reversed(range(len(shape))):
        if shape[dim] >= min_shard_dim and shape[dim] % n_model == 0:
            spec = [None] * len(shape)
            spec[dim] = MODEL_AXIS
            return P(*spec)
    return P()


def param_partition_spec(params: Any, mesh, min_shard_dim: int = 1024,
                         rules: Sequence[tuple[str, tuple]] | None = None,
                         strict: bool = False) -> Any:
    """The spec of every leaf of ``params`` on ``mesh`` (anything with a
    ``shape`` dict of axis sizes).

    With ``rules``, the regex table decides (``match_partition_rules``).
    Without, the first-divisible-axis fallback shards wide leaves over
    ``model``.  Either way, every big leaf (a dim ≥ ``min_shard_dim``)
    left fully replicated is logged with its shape and the reason."""
    n_model = mesh.shape.get(MODEL_AXIS, 1)
    leaves = leaf_paths(params)
    if rules is not None:
        specs = match_partition_rules(rules, params, strict=strict)
    else:
        specs = _rebuild(params, [
            first_divisible_spec(_shape(leaf), n_model, min_shard_dim)
            for _, leaf in leaves])
    if n_model > 1:
        flat = dict(spec_leaves(specs))
        for name, leaf in leaves:
            shape = _shape(leaf)
            if flat[name] == P() and not _is_scalar(leaf) \
                    and max(shape) >= min_shard_dim:
                event(_log, "partition_replicated", leaf=name,
                      shape=list(shape), model_axis=n_model,
                      reason="no dim >= min_shard_dim divisible by the "
                             "model axis" if rules is None
                      else "rule table replicates it")
    return specs


#: Per-model-family rule tables for the zoo's wide layers (the
#: reference's, verbatim).  Regexes target flax param paths
#: (``params/<module>/kernel``); the tables shard output-feature dims
#: over ``model`` and the catch-all replicates the rest under
#: first-match-wins, so ``strict=True`` rejects them by construction.
RULE_TABLES: dict[str, list[tuple[str, tuple]]] = {
    "classifier": [
        (r"(head|classifier|logits|fc\d*|Dense_\d+)/kernel$",
         P(None, MODEL_AXIS)),
        (r"conv.*/kernel$", P(None, None, None, MODEL_AXIS)),
        (r".*", P()),
    ],
    "gan": [
        (r"(proj|project|Dense_\d+|fc\d*)/kernel$",
         P(None, MODEL_AXIS)),
        (r"(Conv|ConvTranspose).*/kernel$",
         P(None, None, None, MODEL_AXIS)),
        (r".*", P()),
    ],
}


def rules_for(task: str | None) -> list[tuple[str, tuple]] | None:
    """The rule table for a serving task family (None = use the
    first-divisible-axis fallback sharder)."""
    if task is None:
        return None
    if task in ("gan", "generation", "cyclegan", "dcgan"):
        return RULE_TABLES["gan"]
    if task in ("classification", "classify"):
        return RULE_TABLES["classifier"]
    return None


def parse_partition_rules(spec: str) -> list[tuple[str, tuple]]:
    """CLI syntax for ``--partition-rules``: ``;``-separated
    ``regex=axes`` entries, where ``axes`` is a ``,``-separated axis
    name per dim (``-`` or empty = replicate that dim) and an empty
    right-hand side replicates the whole leaf.  A bare table name
    (``classifier``/``gan``) selects the built-in table.

        head/kernel=-,model;conv.*/kernel=-,-,-,model;.*=
    """
    spec = spec.strip()
    if spec in RULE_TABLES:
        return RULE_TABLES[spec]
    rules: list[tuple[str, tuple]] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"partition rule '{entry}': expected regex=axes "
                "(e.g. 'head/kernel=-,model') or a table name "
                f"{sorted(RULE_TABLES)}")
        pat, _, axes = entry.partition("=")
        axes = axes.strip()
        if not axes:
            rules.append((pat.strip(), P()))
            continue
        dims = [None if a.strip() in ("", "-", "None") else a.strip()
                for a in axes.split(",")]
        rules.append((pat.strip(), P(*dims)))
    if not rules:
        raise ValueError(f"partition rules '{spec}': no entries")
    return rules
