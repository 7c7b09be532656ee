"""Named-axis sharding rules for the LM stack (the port of the reference's
``repro.dist.sharding``, with no jax).

The reference maps LOGICAL axis names onto MESH axes with a rules dict:

* ``batch`` / ``fsdp`` -> ``("pod", "data")`` — data parallelism + ZeRO-3,
* ``heads`` / ``kv_heads`` / ``ff`` / ``vocab`` / ``experts`` -> ``"model"``
  — tensor / expert parallelism,
* ``seq_act`` -> ``"model"`` — inter-layer sequence (activation) sharding.

Every mapping is divisibility-guarded (:func:`fit`): a dimension that does
not divide over its mesh axes is replicated.

A mesh is described by its axis names and sizes (:func:`mesh_axes`), and
the rules carry them (``rules["_axes"]``), where the reference keeps a
module-global.  A spec is a tuple with one entry per dimension: None, a
mesh axis name, or a tuple of names, as the reference's ``PartitionSpec``.

The port acts on every rule (``repro_torch.dist.zero`` and
``repro_torch.dist.tp``): a rank holds each parameter's shard under
``param_specs`` over ``"model"`` (heads, ff, vocab and experts) and ZeRO-3
shards the ``zero_dim`` over the dp axes; the batch goes over the dp
axes; the stream between layers is split over the sequence where
``seq_act`` is ``"model"``; the cache is placed by ``cache_specs``.
:func:`shard` gives a rank's block of a tensor under the rules, where the
reference constrains a global array's layout.
"""
from __future__ import annotations

import math
import re

from ..convert import _reference_path

DP_AXES = ("pod", "data")


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size}, in the mesh's order, of a torch ``DeviceMesh``
    (``mesh_dim_names``), of anything with the reference mesh's
    ``axis_names`` and ``devices.shape``, or of such a dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_rules_for(cfg, mesh, *, multi_pod: bool | None = None,
                   kind: str = "train") -> dict:
    """Logical-axis -> mesh-axis rules for one (arch x mesh x kind) cell, as
    the reference's; ``"_axes"`` holds the mesh's axis sizes."""
    del multi_pod
    axes = mesh_axes(mesh)
    dp = tuple(a for a in DP_AXES if a in axes)
    tp = "model" if "model" in axes else None
    moe = getattr(cfg, "moe", None) if cfg is not None else None
    return {
        "batch": dp,
        "fsdp": dp,
        "seq_act": None if kind == "decode" else tp,
        "heads": tp,
        "kv_heads": tp,
        "ff": tp,
        "vocab": tp,
        "experts": tp if moe is not None else None,
        "_kind": kind,
        "_axes": axes,
    }


def shard(x, *names, rules: dict | None = None, coords: dict | None = None):
    """The reference's activation annotation, as a rank's part: with
    ``rules`` and ``coords`` ({mesh axis: this rank's index on it}), the
    block of ``x`` (one logical name, or None, a dim) that the rank holds
    where the rules give a dim mesh axes that divide it (as ``fit``), and
    ``x`` itself otherwise; without ``rules``, the identity (the
    reference's outside ``use_rules``)."""
    if rules is None or len(names) != x.dim():
        return x
    sizes, used = rules["_axes"], set()
    for dim, name in enumerate(names):
        axes = fit(rules.get(name) if name else None, x.shape[dim], sizes, used)
        if axes is None:
            continue
        index = 0
        for a in _axes_tuple(axes):
            index = index * sizes[a] + coords[a]
        x = x.chunk(math.prod(sizes[a] for a in _axes_tuple(axes)), dim)[index]
    return x


def _axes_tuple(ax) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def fit(ax, dim: int, sizes: dict, used: set):
    """The usable mesh axes for one dimension (or None): the axes of ``ax``
    not in ``used``, if the dimension divides over their product (> 1)."""
    axes = tuple(a for a in _axes_tuple(ax) if a is not None and a not in used)
    if not axes:
        return None
    total = math.prod(sizes.get(a, 1) for a in axes)
    if total <= 1 or dim % total:
        return None
    used.update(axes)
    return axes if len(axes) > 1 else axes[0]


def _set_dim(spec: list, dim_from_end: int, ax, shape, sizes: dict, used: set):
    i = len(shape) - dim_from_end
    if i < 0 or spec[i] is not None:
        return
    spec[i] = fit(ax, shape[i], sizes, used)


def param_spec(names, shape, rules: dict) -> tuple:
    """The reference's placement of one parameter: tensor/expert
    parallelism by name on the trailing dims, then ZeRO-3 on the largest
    free dim over the dp axes.  ``names``: the reference pytree path;
    ``shape``: the reference leaf's (stacked, where the reference stacks)."""
    sizes = rules["_axes"]
    spec: list = [None] * len(shape)
    used: set = set()
    leaf = names[-1] if names else ""
    if len(shape) == 0 or max(shape) <= 1:
        return tuple(spec)
    if leaf == "table":                                  # (V, D) / (K, V, D)
        _set_dim(spec, 2, rules.get("vocab"), shape, sizes, used)
    elif "lm_head" in names and leaf == "w":             # (D, V)
        _set_dim(spec, 1, rules.get("vocab"), shape, sizes, used)
    elif "moe" in names and leaf in ("gate", "up", "down") and len(shape) >= 3:
        _set_dim(spec, 3, rules.get("experts"), shape, sizes, used)   # (E, D, F)
    elif leaf in ("up", "gate", "wk_ff"):                # MLP in (D, F)
        _set_dim(spec, 1, rules.get("ff"), shape, sizes, used)
    elif leaf == "down":                                 # MLP out (F, D)
        _set_dim(spec, 2, rules.get("ff"), shape, sizes, used)
    elif leaf in ("wq", "wk", "wv"):                     # (D, H*hd)
        _set_dim(spec, 1, rules.get("heads"), shape, sizes, used)
    elif leaf == "wo":                                   # (H*hd, D)
        _set_dim(spec, 2, rules.get("heads"), shape, sizes, used)
    if len(shape) >= 2:
        free = [i for i, s in enumerate(spec) if s is None]
        if free:
            i = max(free, key=lambda j: shape[j])
            spec[i] = fit(rules.get("fsdp"), shape[i], sizes, used)
    return tuple(spec)


def _stack_key(name: str):
    """(name with its layer index blanked, the index) for a parameter of a
    stacked group, else (name, None)."""
    m = re.match(r"(layers\.(?:\w+\.)?)(\d+)\.(.*)", name)
    if m is None:
        return name, None
    return f"{m.group(1)}#.{m.group(3)}", int(m.group(2))


def param_specs(shapes: dict, rules: dict) -> dict[str, tuple]:
    """{port parameter name: spec over its own dims} for a whole model's
    ``{name: shape}`` (``named_parameters`` of a full model, on any device).

    The reference places its leaves stacked, (L, ...) for the L layers of
    a group; so is each port leaf here, and the layer dim is dropped from
    the spec: the port's spec is the reference's on the trailing dims.
    Where the reference's ZeRO dim is the layer dim, the port's spec has
    no ZeRO dim."""
    layers: dict[str, int] = {}
    for name in shapes:
        key, i = _stack_key(name)
        if i is not None:
            layers[key] = max(layers.get(key, 0), i + 1)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        path, layer = _reference_path(name)
        if layer is None:
            out[name] = param_spec(list(path), shape, rules)
        else:
            stacked = (layers[_stack_key(name)[0]],) + shape
            out[name] = param_spec(list(path), stacked, rules)[1:]
    return out


def batch_specs(cfg, batch: dict, rules: dict) -> dict[str, tuple]:
    """Input batches shard on the leading (global batch) dim over dp."""
    del cfg
    out = {}
    for name, leaf in batch.items():
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if shape:
            spec[0] = fit(rules.get("batch"), shape[0], rules["_axes"], set())
        out[name] = tuple(spec)
    return out


def cache_specs(cfg, cache: dict, rules: dict) -> dict:
    """Decode-state specs over the cache's nested dicts: batch (dim 1 of
    the layer-stacked leaves) over dp; heads over ``"model"`` where the
    leaf has a heads dim (k/v (L, B, T, KVH, hd); rwkv6's wkv and
    Mamba2's ssm (L, B, H, ...))."""
    del cfg
    sizes = rules["_axes"]

    def spec(leaf_name: str, shape):
        s: list = [None] * len(shape)
        used: set = set()
        if len(shape) >= 2:
            s[1] = fit(rules.get("batch"), shape[1], sizes, used)
        if leaf_name in ("k", "v") and len(shape) >= 5:
            s[3] = fit(rules.get("kv_heads"), shape[3], sizes, used)
        elif leaf_name in ("wkv", "ssm") and len(shape) >= 3:
            s[2] = fit(rules.get("heads"), shape[2], sizes, used)
        return tuple(s)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return spec(name, tuple(node.shape))

    return walk(cache, "")


def zero_dim(spec: tuple, rules: dict) -> int | None:
    """The dim of ``spec`` that ZeRO-3 shards (the one holding the dp
    axes), or None."""
    dp = rules.get("fsdp") or ()
    for i, ax in enumerate(spec):
        if ax is not None and set(_axes_tuple(ax)) <= set(dp):
            return i
    return None


def is_expert(spec: tuple) -> bool:
    """Whether a leaf's spec splits it over ``"model"`` on its expert dim."""
    return len(spec) >= 3 and spec[-3] == "model"


__all__ = ["batch_specs", "cache_specs", "fit", "is_expert", "make_rules_for",
           "mesh_axes", "param_spec", "param_specs", "shard", "zero_dim"]
