"""The port's sharding rules (``repro_torch.dist.sharding``) against the
reference's ``repro.dist.sharding``: for all ten configs at full size, on
the production meshes 16 x 16 and 2 x 16 x 16 and on the four-card meshes
1 x 4, 2 x 2 and 4 x 1, every parameter's spec, the batch's and the decode
cache's.

No devices are needed: the reference's ``set_axis_sizes`` and
``make_rules_for`` read only a mesh's ``axis_names`` and
``devices.shape``, so a stand-in object carries them.  Reference
parameters come from ``jax.eval_shape`` of its init, the port's from a
model on the meta device.  The reference places stacked leaves (L, ...),
one per group of layers; the port's per-layer leaf is held to the
reference's spec on the trailing dims.  Where the reference's ZeRO dim is
the layer-stack dim itself, the leaf would be named below
(``ZERO_ON_LAYER_DIM``; none is, at these meshes): the port's spec then has
no ZeRO dim either.
"""
from functools import lru_cache
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.dist import sharding as RS
from repro.models.model import CausalLM as RModel
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist import sharding as PS
from repro_torch.models.model import CausalLM
from repro_torch.models.transformer import init_cache

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}

# (arch, mesh, port parameter with its layer index blanked) where the
# reference's ZeRO shards the stacked leaf's layer dim: none, at these five
# meshes
ZERO_ON_LAYER_DIM: set = set()


def _mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(RModel(r_get_config(arch)).init, jax.random.PRNGKey(0))


@lru_cache(maxsize=None)
def _port_shapes(arch):
    model = CausalLM(get_config(arch), device="meta", seed=None)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    ref_params = _ref_params(arch)
    shapes = _port_shapes(arch)
    seen = set()
    on_layer_dim = set()
    for mesh_name in MESHES:
        mesh = _mesh(mesh_name)
        RS.set_axis_sizes(mesh)
        ref = RS.param_pspecs(ref_params, RS.make_rules_for(r_get_config(arch), mesh))
        rules = PS.make_rules_for(get_config(arch), mesh)
        got = PS.param_specs(shapes, rules)
        assert got.keys() == shapes.keys()
        for name, spec in got.items():
            path, layer = convert._reference_path(name)
            want = tuple(_leaf(ref, path))
            seen.add(path)
            if layer is not None:
                if want[0] is not None:
                    on_layer_dim.add((arch, mesh_name, PS._stack_key(name)[0]))
                want = want[1:]
            assert spec == want, (mesh_name, name, spec, want)
    assert seen == {path for path, _ in _leaves(ref_params)}
    assert on_layer_dim == {k for k in ZERO_ON_LAYER_DIM if k[0] == arch}


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    k = cfg.num_codebooks if cfg.family == "audio" else 0
    ref_cache = jax.eval_shape(lambda: RModel(r_cfg).init_cache(32, 256))
    port_cache = init_cache(cfg, 32, 256, torch.bfloat16, "meta")
    for mesh_name in MESHES:
        mesh = _mesh(mesh_name)
        RS.set_axis_sizes(mesh)
        r_rules = RS.make_rules_for(r_cfg, mesh, kind="decode")
        rules = PS.make_rules_for(cfg, mesh, kind="decode")
        for b in (1, 6, 32, 256):
            batch = {"tokens": np.zeros((b, 128) + ((k,) if k else ()), np.int32),
                     "labels": np.zeros((b, 128) + ((k,) if k else ()), np.int32)}
            if cfg.family == "vlm":
                batch["prefix_embeds"] = np.zeros((b, cfg.prefix_tokens, cfg.d_model),
                                                  np.float32)
            want = {n: tuple(s) for n, s in RS.batch_pspecs(r_cfg, batch, r_rules).items()}
            assert PS.batch_specs(cfg, batch, rules) == want, (mesh_name, b)
        want = dict(_leaves(RS.cache_pspecs(r_cfg, ref_cache, r_rules)))
        got = dict(_leaves(PS.cache_specs(cfg, port_cache, rules)))
        assert got == {p: tuple(s) for p, s in want.items()}, mesh_name


def test_port_uses_expert_and_zero_dims():
    """What the port acts on: deepseek's routed experts split over "model"
    at 1 x 4 and 2 x 2 (not at 4 x 1), ZeRO's dim, and ``shard``: the
    identity without rules, else the rank's block (batch over "data", the
    sequence over "model"; a dim that does not divide stays whole)."""
    shapes = _port_shapes("deepseek-moe-16b")
    up = "layers.moe_layers.0.moe.experts.up"                # (64, 2048, 1408)
    for mesh_name, expert, zero in (("1x4", True, None), ("2x2", True, 1),
                                    ("4x1", False, 1)):
        rules = PS.make_rules_for(get_config("deepseek-moe-16b"), _mesh(mesh_name))
        spec = PS.param_specs(shapes, rules)[up]
        assert PS.is_expert(spec) == expert, mesh_name
        assert PS.zero_dim(spec, rules) == zero, mesh_name
    x = torch.ones(2)
    assert PS.shard(x, "batch") is x                      # no rules: the identity
    rules = PS.make_rules_for(get_config("deepseek-moe-16b"), _mesh("2x2"))
    act = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    for d in range(2):
        for m in range(2):
            got = PS.shard(act, "batch", "seq_act", None, rules=rules,
                           coords={"data": d, "model": m})
            assert torch.equal(got, act[2 * d:2 * d + 2, 3 * m:3 * m + 3])
    odd = torch.ones(3, 5, 2)
    assert PS.shard(odd, "batch", "seq_act", None, rules=rules,
                    coords={"data": 1, "model": 1}).shape == (3, 5, 2)
    decode = PS.make_rules_for(get_config("deepseek-moe-16b"), _mesh("2x2"), kind="decode")
    assert PS.shard(act, "batch", "seq_act", None, rules=decode,
                    coords={"data": 1, "model": 1}).shape == (2, 6, 3)
