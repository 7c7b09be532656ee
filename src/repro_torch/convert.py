"""Carry the JAX package's configuration, flow state, LM parameters and
KV caches into the port and back.

The reference's state is plain numpy once it leaves JAX, so nothing here
imports it:

* :func:`config_from_reference` takes the dict of the reference's
  ``repro.sim.registry.config_to_dict`` (``dataclasses.asdict`` of its
  ``LBMConfig``) and gives the port's :class:`LBMConfig`; the port's
  ``repro_torch.sim.registry.config_to_dict`` writes that same dict, and
  session manifests carry it.
* :func:`state_from_reference` takes ``np.asarray(ref_engine.f)`` — the
  storage layout (Q, T, n) of a gather engine in its ``layout_scheme``
  order, or the packed (T+1, Q, n) state of a fused engine — and gives the
  port engine's state.  The reference engine must have run the same
  geometry and configuration (layout and orders included).
* :func:`state_to_reference` does the reverse.
* :func:`ensemble_from_reference` seats every replica of a port ensemble
  from ``np.asarray(ref_ensemble.f)`` — (B, Q, T, n) storage layout on
  gather, the replicated packed (B*T + 1, Q, n) state on fused — and
  ``ensemble.f.cpu().numpy()`` is the port ensemble's state in that
  layout.
* :func:`lm_params_from_reference` takes the reference ``CausalLM``'s
  parameter pytree as nested dicts of numpy arrays and returns a port
  :class:`CausalLM` holding them; :func:`lm_params_to_reference` does the
  reverse, byte for byte.  The stacked groups of the reference's
  ``stack`` (``layers`` over the L layers, dense or rwkv6; gemma2's
  ``pairs``; the moe family's ``dense_layers`` and ``moe_layers``;
  zamba2's ``mamba`` and its per-group ``lora``) are indexed on their
  leading axis; zamba2's ``shared`` block is one copy.
* :func:`opt_state_to_reference` / :func:`opt_state_from_reference`
  carry the AdamW state (``repro_torch.optim.adamw``) across in the
  reference's layout ``{"m": tree, "v": tree, "count": int32}``, the
  trees in the parameters' pytree layout: a training checkpoint of either
  package restores in the other.
* :func:`lm_cache_from_reference` / :func:`lm_cache_to_reference` carry a
  decode cache across, a tree of nested dicts of any shape (k/v groups,
  rwkv6's ``wkv``/``tshift1``/``tshift2``, zamba2's ``ssm``/``conv``/
  ``attn_kv``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.boundary import BoundarySpec
from .core.collision import CollisionConfig
from .core.engine import LBMConfig, SparseTiledLBM
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import CausalLM


def config_from_reference(d: dict) -> LBMConfig:
    """The port's LBMConfig from a reference ``config_to_dict`` dict.

    ``kernel_interpret`` (Pallas interpret mode) has no counterpart and is
    dropped.
    """
    d = {k: v for k, v in d.items() if k != "kernel_interpret"}
    d["collision"] = CollisionConfig(**d["collision"])
    d["boundaries"] = tuple(
        (int(tv), BoundarySpec(kind=s["kind"], normal=tuple(s["normal"]),
                               velocity=tuple(s["velocity"]),
                               rho=float(s["rho"])))
        for tv, s in d["boundaries"])
    d["periodic"] = tuple(bool(p) for p in d["periodic"])
    d["u0"] = tuple(float(v) for v in d["u0"])
    if d.get("force") is not None:
        d["force"] = tuple(float(v) for v in d["force"])
    return LBMConfig(**d)


def _packed_shape(engine: SparseTiledLBM):
    t, n = engine.tiling.num_tiles, engine.tiling.nodes_per_tile
    return (t + 1, engine.lat.q, n), (engine.lat.q, t, n)


def state_from_reference(f_np: np.ndarray, engine: SparseTiledLBM) -> torch.Tensor:
    """The port state for ``engine`` from a reference engine's ``f``.

    A packed (T+1, Q, n) array is a fused engine's state; a (Q, T, n) array
    a gather engine's storage layout.  Either converts into either backend
    (through the canonical (Q, T, n) order) and becomes the engine's new
    state buffer: assign the result to ``engine.f``.
    """
    f = torch.tensor(np.asarray(f_np), dtype=engine.dtype,
                     device=engine.device)
    packed, storage = _packed_shape(engine)
    if tuple(f.shape) == packed:
        canon = f[:-1].movedim(0, 1)
    elif tuple(f.shape) == storage:
        # a gather engine's storage layout is this config's layout_scheme
        canon = (engine.backend.canonical(f) if engine.cfg.backend == "gather"
                 else f)
    else:
        raise ValueError(f"state shape {tuple(f.shape)} is neither packed "
                         f"{packed} nor storage {storage}")
    return engine.backend.initial_state(canon.contiguous())


def state_to_reference(engine: SparseTiledLBM) -> np.ndarray:
    """``engine.f`` as numpy in the layout of a reference engine with the
    same configuration: packed (T+1, Q, n) for fused, storage (Q, T, n) for
    gather."""
    return engine.f.detach().cpu().numpy()


def ensemble_from_reference(f_np: np.ndarray, ensemble) -> None:
    """Seat every replica of the port's ``ensemble`` from a reference
    ensemble's ``f`` over the same geometry and configuration: (B, Q, T, n)
    in the storage layout of a gather ensemble, or (B*T + 1, Q, n) packed
    of a fused one (either converts into either backend)."""
    eng = ensemble.engine
    f = torch.tensor(np.asarray(f_np), dtype=eng.dtype, device=eng.device)
    (t1, q, n), (_, t, _) = _packed_shape(eng)
    b = ensemble.batch
    if tuple(f.shape) == (b * t + 1, q, n):
        canon = f[:-1].view(b, t, q, n).transpose(1, 2)
    elif tuple(f.shape) == (b, q, t, n):
        canon = (eng.backend.canonical(f) if eng.cfg.backend == "gather"
                 else f)
    else:
        raise ValueError(f"ensemble state shape {tuple(f.shape)} is neither "
                         f"packed {(b * t + 1, q, n)} nor storage {(b, q, t, n)}")
    for i in range(b):
        ensemble.set_replica(i, canon[i])


# --------------------------------------------------------------------------
# LM parameters and caches
# --------------------------------------------------------------------------
def _reference_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """The reference pytree path of a port parameter name, and the index
    into its stacked (n, ...) array (None for an unstacked one)."""
    if name.startswith("layers."):
        _, part, *rest = name.split(".")
        if part.isdigit():                       # one list of layers
            if rest[0] in ("local", "global"):   # a Pair's blocks
                return ("stack", "pairs", *rest), int(part)
            return ("stack", "layers", *rest), int(part)
        if part == "shared":                     # zamba2's one shared block
            return ("stack", "shared", *rest), None
        return ("stack", part, *rest[1:]), int(rest[0])   # a named group
    return {"embed": ("embed", "table"), "final_norm": ("final_norm",),
            "lm_head": ("lm_head", "w")}[name], None


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes, as JAX gives it) included."""
    arr = np.array(arr)                 # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def named_from_reference(tree: dict, like: dict[str, torch.Tensor]) -> dict:
    """{port name: numpy array} from a reference pytree in the parameters'
    layout (nested dicts of numpy arrays), for every name of ``like``
    ({port name: tensor of the expected shape}).  Raises on a shape
    mismatch and on a reference leaf without a port counterpart."""
    out, seen = {}, set()
    for name, p in like.items():
        path, layer = _reference_path(name)
        node = tree
        for key in path:
            node = node[key]
        arr = np.asarray(node if layer is None else node[layer])
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{'.'.join(path)}: shape {arr.shape}, "
                             f"expected {tuple(p.shape)}")
        out[name] = arr
        seen.add(path)
    leaves = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            leaves.add(path)

    walk(tree, ())
    if leaves != seen:
        raise ValueError(f"reference parameters without a port counterpart: "
                         f"{sorted(leaves - seen)}")
    return out


def lm_params_from_reference(params_np: dict, cfg: ModelConfig,
                             device=None) -> CausalLM:
    """A port model on ``device`` (None: the card) holding the reference's
    parameters, frozen for serving or comparison (``requires_grad_()``
    makes them train)."""
    model = CausalLM(cfg, device=device, seed=None).requires_grad_(False)
    load_params(model, params_np)
    return model


def load_params(model: CausalLM, params_np: dict) -> None:
    """Copy a reference parameter pytree into ``model``'s parameters."""
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, arr in named_from_reference(params_np, named).items():
            named[name].copy_(_tensor(arr))


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def named_to_reference(named: dict[str, torch.Tensor]) -> dict:
    """The reference pytree (nested dicts of numpy arrays, stacked groups
    stacked) of tensors keyed by port parameter name."""
    out: dict = {}
    stacked: dict = {}
    for name, p in named.items():
        path, layer = _reference_path(name)
        arr = p.detach().to("cpu", copy=True).numpy()   # owns its bytes
        if layer is None:
            _put(out, path, arr)
        else:
            stacked.setdefault(path, []).append(arr)
    for path, arrs in stacked.items():
        _put(out, path, np.stack(arrs))
    return out


def lm_params_to_reference(model: CausalLM) -> dict:
    """The reference pytree of ``model``'s parameters, as numpy."""
    return named_to_reference(dict(model.named_parameters()))


def opt_state_to_reference(state: dict) -> dict:
    """The AdamW state in the reference's layout, as numpy."""
    return {"m": named_to_reference(state["m"]), "v": named_to_reference(state["v"]),
            "count": np.array(int(state["count"]), dtype=np.int32)}


def opt_state_from_reference(tree: dict, state: dict) -> None:
    """Copy a reference AdamW state into the port's ``state`` (in place;
    its m and v give the names and shapes)."""
    with torch.no_grad():
        for part in ("m", "v"):
            for name, arr in named_from_reference(tree[part], state[part]).items():
                state[part][name].copy_(_tensor(arr))
    state["count"] = torch.tensor(int(np.asarray(tree["count"])), dtype=torch.int32)


def _map_tree(fn, tree):
    return ({k: _map_tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict)
            else fn(tree))


def lm_cache_from_reference(cache_np: dict, device=None) -> dict:
    """A reference decode cache (nested dicts of numpy arrays) as the
    port's, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _tensor(a).to(dev), cache_np)


def lm_cache_to_reference(cache: dict) -> dict:
    """The port's decode cache as numpy; bfloat16 leaves come back widened
    to float32 (numpy has no bfloat16)."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map_tree(arr, cache)
