"""The dry-run and roofline stack of the port (``repro_torch.launch.dryrun``,
``repro_torch.roofline``, the LBM dry-run of ``repro_torch.launch.lbm``)
against the reference, on the CPU.

One reference subprocess (its launchers set a fake device count, so it
never shares this process) gives: the cell grid (``SHAPES``, both
``cells`` lists, ``LONG_CONTEXT_ARCHS``), every ``input_specs`` shape and
dtype, ``param_stats``, ``model_flops_for`` and the microbatch rule of the
ten full configs; the LBM dry-run on the single-pod mesh; and
``analyze_hlo(...).dots_flops`` of the starcoder2-3b smoke forward on one
CPU device.  The port is held to them: the grid and the counts exactly,
the LBM dry-run's structural keys exactly (float64 values to 1e-12), and
the counter's product FLOPs of the same forward to 0.1 % once the
reference's dense attention products (4 B S^2 H hd a layer) are replaced
by K3's visible pairs.  Then the counter's own conventions, the kernels'
cost functions on the meta device, ``CountComm``, the collision's
per-node counts (``benchmarks/flops_table2.py``'s ordering), cells counted
at full width (chatglm3-6b, each kind, both production meshes) and at
every family's smoke size, and a decode with a float8 cache.
"""
import json
import math
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec, cells,
                                 get_config, get_smoke, input_specs, param_stats)
from repro_torch.core import collision as C
from repro_torch.core.lattice import get_lattice
from repro_torch.dist.comm import CountComm
from repro_torch.kernels import collide as k2
from repro_torch.kernels import flash as k3
from repro_torch.kernels import stream_collide as k1
from repro_torch.launch import dryrun
from repro_torch.launch import lbm as launcher
from repro_torch.launch.mesh import MeshSpec, make_production_mesh, mesh_chip_count
from repro_torch.models.model import CausalLM
from repro_torch.roofline.analysis import model_flops_for
from repro_torch.roofline.count import Counter

ROOT = Path(__file__).resolve().parents[1]
SMOKE_B, SMOKE_S = 2, 32

REF_PROG = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.argv.append("--dryrun")
import jax, jax.numpy as jnp
import numpy as np
from repro import configs as C
from repro.launch import lbm as L
from repro.roofline.analysis import model_flops_for
from repro.roofline.hlo_cost import analyze_hlo
from repro.models.model import CausalLM
out = {"shapes": {k: [s.kind, s.seq_len, s.global_batch] for k, s in C.SHAPES.items()},
       "cells": C.cells(), "cells_all": C.cells(include_skipped=True),
       "long": list(C.LONG_CONTEXT_ARCHS), "specs": {}, "stats": {}, "mf": {}, "micro": {}}
for arch in C.ARCHS:
    cfg = C.get_config(arch)
    out["stats"][arch] = list(C.param_stats(cfg))
    out["micro"][arch] = 4 if (cfg.n_layers * cfg.d_model > 300_000
                               or cfg.family == "hybrid") else 1
    out["specs"][arch] = {
        name: {k: [list(v.shape), str(v.dtype)] for k, v in C.input_specs(cfg, s).items()}
        for name, s in C.SHAPES.items()}
    out["mf"][arch] = {name: model_flops_for(cfg, s.kind, s.seq_len, s.global_batch)
                       for name, s in C.SHAPES.items()}
out["lbm"] = L.dryrun(False, verbose=False)
cfg = C.get_smoke("starcoder2-3b")
model = CausalLM(cfg)
params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
batch = {"tokens": jax.ShapeDtypeStruct((%d, %d), jnp.int32)}
text = jax.jit(model.forward).lower(params, batch).compile().as_text()
out["dots"] = analyze_hlo(text).dots_flops
print("REF_JSON", json.dumps(out))
""" % (SMOKE_B, SMOKE_S)


_REF: dict = {}


def _start_reference() -> None:
    if "proc" not in _REF:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
        env.pop("XLA_FLAGS", None)
        _REF["proc"] = subprocess.Popen([sys.executable, "-c", REF_PROG],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True, env=env, cwd=ROOT)


@pytest.fixture(scope="module", autouse=True)
def _reference_running():
    """The reference's run starts with the module's first test and runs
    beside the port's own cases; the cases that read it come last."""
    _start_reference()
    yield
    if _REF["proc"].poll() is None:
        _REF["proc"].kill()
        _REF["proc"].communicate()


@lru_cache(maxsize=None)
def reference() -> dict:
    _start_reference()
    out, err = _REF["proc"].communicate(timeout=300)
    assert _REF["proc"].returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("REF_JSON "))
    return json.loads(line[len("REF_JSON "):])


# --------------------------------------------------------------------------
# the LBM dry-run
# --------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _lbm_single():
    return launcher.dryrun(False, verbose=False)


def test_lbm_dryrun_fused_counts_k1_by_its_cost():
    out = launcher.dryrun(False, verbose=False, backend="fused")
    launches, flops, nbytes = out["kernels"]["stream_collide_tiles"]
    assert launches == 1 and flops > 0 and nbytes > 0
    # the busiest slab holds the inlet or the outlet: its NEBB pass is one
    # launch too, counted by its cost function
    nebb = out["kernels"]["nebb_boundary_pass"]
    assert set(out["kernels"]) == {"stream_collide_tiles", "nebb_boundary_pass"}
    assert nebb[0] == 1 and 0 < nebb[2] < nbytes / 4
    assert out["coll_bytes_per_device"] == 350_208


# --------------------------------------------------------------------------
# the counter
# --------------------------------------------------------------------------
def test_counter_conventions():
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 4, device="meta")
    with Counter() as c:
        x = a @ b                       # 2 * 8 * 16 * 4
        y = x.exp()                     # 32 elementwise
        z = y.sum(-1)                   # 32 reduced
        v = y.reshape(4, 8).t()         # views: nothing
        w = torch.empty(10, device="meta")     # empty: nothing
    assert c.dots_flops == 2 * 8 * 16 * 4
    assert c.flops == 2 * 8 * 16 * 4 + 32 + 32
    assert c.by_op["mm"][2] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.by_op["exp"][2] == 2 * 32 * 4 and c.by_op["sum"][2] == (32 + 8) * 4
    assert "view" not in c.by_op and "empty" not in c.by_op and "t" not in c.by_op
    assert c.peak >= 3 * 512 and v.shape == (8, 4) and w.shape == (10,) and z.shape == (8,)


def test_counter_tracks_live_storages():
    with Counter() as c:
        x = torch.empty(1000, device="meta").exp()       # 4,000 B -> 4,096
        assert c.live == 2 * 4096 or c.live == 4096
        y = x * 2
        del x
        peak = c.peak
        del y
    assert peak >= 2 * 4096 and c.live <= peak


def test_counter_meta_rule_for_bincount():
    ids = torch.empty(12, 2, dtype=torch.long, device="meta")
    with Counter() as c:
        n = torch.bincount(ids.reshape(-1), minlength=8)
    assert n.shape == (8,) and n.dtype == torch.int64 and c.flops == 24


@pytest.mark.parametrize("s,t,window,prefix", [(1, 1, None, 0), (7, 7, None, 0),
                                               (64, 64, 5, 0), (40, 40, None, 9),
                                               (33, 33, 4, 20), (20, 30, None, 0),
                                               (30, 20, 3, 25)])
def test_visible_pairs_equal_the_mask(s, t, window, prefix):
    want = int(k3.visible_mask(torch.arange(s), torch.arange(t), window=window,
                               prefix_len=prefix).sum())
    assert k3.visible_pairs(s, t, window=window, prefix_len=prefix) == want
    assert k3.visible_pairs(s, t, causal=False) == s * t


def test_kernels_on_meta_report_their_costs():
    """Each wrapper on meta tensors: outputs of the right shapes, no
    launch, its cost function's (FLOPs, bytes) reported."""
    b, s, h, kvh, hd = 2, 100, 8, 2, 64
    q = torch.empty(b, s, h, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, kvh, hd, dtype=torch.bfloat16, device="meta")
    lat, cfg = get_lattice("D3Q19"), C.CollisionConfig()
    f = torch.empty(11, 19, 64, device="meta", dtype=torch.float64)
    types = torch.empty(11, 64, dtype=torch.uint8, device="meta")
    nbrs = torch.empty(10, 27, dtype=torch.int32, device="meta")
    before = (k1.stream_collide_tiles.launches, k2.collide_tiles.launches,
              k3.flash_attention.launches, k3.flash_attention_bwd.launches)
    with Counter() as c:
        out, lse = k3.flash_attention(q, k, k, window=30, return_lse=True)
        grads = k3.flash_attention_bwd(q, k, k, out, out, lse, window=30)
        g = k1.stream_collide_tiles(f, types, nbrs, lat, cfg)
        g2 = k2.collide_tiles(f[:10].permute(1, 0, 2).contiguous(),
                              torch.empty(10, 64, dtype=torch.bool, device="meta"), lat, cfg)
    assert out.shape == q.shape and lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert [x.shape for x in grads] == [q.shape, k.shape, k.shape]
    assert g.shape == f.shape and g2.shape == (19, 10, 64)
    assert before == (k1.stream_collide_tiles.launches, k2.collide_tiles.launches,
                      k3.flash_attention.launches, k3.flash_attention_bwd.launches)
    kern = c.kernels
    assert kern["flash_attention"][1:] == list(k3.flash_attention_cost(
        b, s, s, h, kvh, hd, 2, window=30, return_lse=True))
    assert kern["flash_attention_bwd"][1:] == list(k3.flash_attention_bwd_cost(
        b, s, s, h, kvh, hd, 2, window=30))
    pairs = k3.visible_pairs(s, s, window=30)
    assert kern["flash_attention"][1] == 4.0 * hd * h * b * pairs
    assert kern["stream_collide_tiles"][1:] == list(k1.stream_collide_cost(10, lat, cfg, 8))
    # the bytes chip_smoke.py's K1 bound has always divided
    assert kern["stream_collide_tiles"][2] == 2 * 10 * 19 * 64 * 8 + 11 * 64 + 10 * 27 * 4 \
        + 19 * 64 * 5
    assert kern["collide_tiles"][1:] == list(k2.collide_cost(640, lat, cfg, 8))


def test_count_comm_records_operand_bytes_both_ways():
    mesh = MeshSpec((2, 4), ("data", "model"))
    comm = CountComm(mesh)
    x = torch.empty(2, 8, 16, device="meta", requires_grad=True)
    with Counter() as c:
        (g,) = comm.gather([x], 1)
        (r,) = comm.scatter_sum([g], 1)
        (s,) = comm.sum([r])
        (a,) = comm.all_to_all([s])
        (m,) = comm.all_mean([a])
        m.sum().backward()
    assert g.shape == (2, 32, 16) and r.shape == x.shape and m.shape == x.shape
    n = 2 * 8 * 16 * 4
    assert c.coll[("all-gather", "model")] == n + n          # fwd gather, bwd of scatter
    assert c.coll[("reduce-scatter", "model")] == 4 * n + 4 * n
    assert c.coll[("all-reduce", "model")] == 2 * n
    assert c.coll[("all-to-all", "model")] == 2 * n
    assert c.coll[("all-reduce", "data,model")] == 2 * n
    assert x.grad.shape == x.shape


# --------------------------------------------------------------------------
# the collision's per-node count (benchmarks/flops_table2.py's claims)
# --------------------------------------------------------------------------
def test_counted_collision_flops_keep_the_table2_ordering():
    lat = get_lattice("D3Q19")
    per_node = {}
    for model in ("lbgk", "lbmrt"):
        for fluid in ("incompressible", "quasi_compressible"):
            cfg = C.CollisionConfig(model=model, fluid=fluid)
            f = torch.empty(19, 10, 64, device="meta", dtype=torch.float32)
            solid = torch.empty(10, 64, dtype=torch.bool, device="meta")
            with Counter() as c:
                k2.collide_tiles(f, solid, lat, cfg)
            per_node[model, fluid] = c.flops / 640
            assert per_node[model, fluid] == C.model_flops_per_node(cfg, lat)
    for fluid in ("incompressible", "quasi_compressible"):
        assert 2 <= per_node["lbmrt", fluid] / per_node["lbgk", fluid] <= 5
    for model in ("lbgk", "lbmrt"):
        assert per_node[model, "quasi_compressible"] > per_node[model, "incompressible"]


# --------------------------------------------------------------------------
# cells counted
# --------------------------------------------------------------------------
@pytest.mark.parametrize("multi", (False, True), ids=("16x16", "2x16x16"))
def test_full_width_dense_cells_count_on_both_meshes(multi):
    mesh = make_production_mesh(multi)
    assert mesh_chip_count(mesh) == (512 if multi else 256)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        out = dryrun.count_cell("chatglm3-6b", shape, mesh, verbose=False)
        assert out["ok"] and out["chips"] == mesh.chips and out["mesh"] == mesh.name
        assert 0 < out["useful_flops_ratio"] <= 1, (shape, out["useful_flops_ratio"])
        assert out["t_compute"] > 0 and out["t_memory"] > 0 and out["t_collective"] > 0
        assert out["fits"] == (out["hbm_need"] <= 80e9)
        # K3 forward: 28 layers, twice a step in training (each block is
        # checkpointed), none in decode (its one query row runs plain)
        launches = out["kernels"].get("flash_attention", [0])[0]
        assert launches == {"train_4k": 56, "prefill_32k": 28, "decode_32k": 0}[shape]


def test_qwen_decode_takes_a_float8_cache():
    out = dryrun.count_cell("qwen1.5-32b", "decode_32k", verbose=False)
    assert out["cache_dtype"] == "float8_e4m3fn" and not out["fits"]


SMOKE_MESH = MeshSpec((2, 4), ("data", "model"))
SMOKE_SHAPES = (ShapeSpec("train", "train", 64, 8), ShapeSpec("prefill", "prefill", 64, 4),
                ShapeSpec("decode", "decode", 64, 4))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_counts_at_its_smoke_size(arch):
    cfg = get_smoke(arch)
    for shape in SMOKE_SHAPES:
        out = dryrun.count_cell(arch, shape.name, SMOKE_MESH, shape=shape, cfg=cfg,
                                verbose=False)
        if shape.kind == "prefill":
            # 2 N D counts 2 V D a token for the vocabulary tables: a prefill
            # computes the logits of its last position only, and an untied
            # input table is a lookup, no product.  A smoke config's tables
            # are a quarter of its parameters, so this shows there; held
            # without them
            table = cfg.vocab_size * cfg.d_model * (cfg.num_codebooks
                                                    if cfg.family == "audio" else 1)
            tokens = shape.global_batch * shape.seq_len
            skipped = 2.0 * table * (tokens - shape.global_batch)
            if not cfg.tie_embeddings:
                skipped += 2.0 * table * tokens
            assert out["model_flops"] - skipped <= out["flops_per_device"] * out["chips"]
        else:
            assert 0 < out["useful_flops_ratio"] <= 1, (shape, out["useful_flops_ratio"])
        assert out["ok"]
        assert out["flops_per_device"] > 0 and out["hbm_need"] > 0
        assert out["coll_bytes_per_device"] > 0
        if cfg.family == "moe" and shape.kind != "decode":
            assert out["coll_by_op"].get("all-to-all", 0) > 0


def test_count_cell_one_card_is_make_train_step():
    """On a 1 x 1 mesh the count is the program of make_train_step: no
    collectives, the parameters and AdamW state resident."""
    cfg = get_smoke("starcoder2-3b")
    out = dryrun.count_cell("starcoder2-3b", "t", MeshSpec((1, 1), ("data", "model")),
                            shape=ShapeSpec("t", "train", 64, 2), cfg=cfg, verbose=False)
    n = sum(p.numel() for p in CausalLM(cfg, device="meta", seed=None).parameters())
    assert out["coll_bytes_per_device"] == 0 and out["argument_bytes"] >= 3 * 4 * n
    assert out["hbm_need"] >= out["argument_bytes"]


def test_main_writes_cells_and_gauges(tmp_path):
    out, met = tmp_path / "d.json", tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "deepseek-moe-16b", "--shape", "decode_32k", "--out",
                        str(out), "--metrics-out", str(met)]) == 0
    (cell,) = json.loads(out.read_text())
    assert cell["ok"] and cell["arch"] == "deepseek-moe-16b"
    names = {json.loads(x)["name"] for x in met.read_text().splitlines()}
    assert {"dryrun.ok", "dryrun.t_memory", "dryrun.hbm_need"} <= names
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape", "long_500k"]) == 0


# --------------------------------------------------------------------------
# decode with a float8 cache
# --------------------------------------------------------------------------
def test_smoke_decode_with_a_float8_cache():
    cfg = get_smoke("starcoder2-3b")
    model = CausalLM(cfg, device="cpu", seed=0).requires_grad_(False)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(0))
    logits, cache = model.prefill(toks, 48, torch.float8_e4m3fn)
    for i in range(4):
        logits, cache = model.decode_step(logits.argmax(-1), cache, 24 + i)
        assert bool(torch.isfinite(logits).all())
    assert all(v.dtype == torch.float8_e4m3fn for v in cache["layers"].values())
    assert math.isfinite(float(logits.float().abs().max()))


# --------------------------------------------------------------------------
# the grid, the parameter counts and the model FLOPs
# --------------------------------------------------------------------------
def test_cell_grid_matches_reference():
    ref = reference()
    assert {k: [s.kind, s.seq_len, s.global_batch] for k, s in SHAPES.items()} == ref["shapes"]
    assert [list(c) for c in cells()] == ref["cells"]
    assert [list(c) for c in cells(include_skipped=True)] == ref["cells_all"]
    assert list(LONG_CONTEXT_ARCHS) == ref["long"]
    assert len(cells()) == 33 and len(cells(include_skipped=True)) == 40


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_stats_and_model_flops_match_reference(arch):
    ref, cfg = reference(), get_config(arch)
    for name, shape in SHAPES.items():
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in input_specs(cfg, shape).items()}
        assert got == ref["specs"][arch][name], name
        assert all(v.is_meta for v in input_specs(cfg, shape).values())
        assert model_flops_for(cfg, shape.kind, shape.seq_len, shape.global_batch) == \
            ref["mf"][arch][name]
    assert list(param_stats(cfg)) == ref["stats"][arch]
    assert dryrun.microbatches_for(cfg) == ref["micro"][arch]


# --------------------------------------------------------------------------
# the LBM dry-run against the reference's
# --------------------------------------------------------------------------
def test_lbm_dryrun_structure_matches_reference():
    got, want = _lbm_single(), reference()["lbm"]
    for key in ("mesh", "chips", "slabs", "geometry", "fluid_nodes", "tile_utilisation",
                "interior_frac", "frontier_frac", "bounce_frac", "node_order",
                "split_stream", "coll_bytes_per_device", "coll_by_op"):
        assert got[key] == want[key], key
    assert got["min_bytes_per_device"] == pytest.approx(want["min_bytes_per_device"],
                                                        rel=1e-12)
    assert got["coll_bytes_per_device"] == 350_208
    model_keys = [k for k in want["metrics"] if not k.endswith("_hlo")
                  and k != "lbm.bytes.hlo_per_device"]
    for key in model_keys:
        assert got["metrics"][key] == pytest.approx(want["metrics"][key], rel=1e-12), key
    assert set(got["metrics"]) == set(want["metrics"])
    assert got["dominant"] in ("t_compute", "t_memory", "t_collective")
    assert got["flops_per_device"] > 0 and got["bytes_per_device"] > got["min_bytes_per_device"]


# --------------------------------------------------------------------------
# the forward's products against the reference's HLO
# --------------------------------------------------------------------------
def test_smoke_forward_products_match_reference_hlo():
    cfg = get_smoke("starcoder2-3b")
    model = CausalLM(cfg, device="meta", seed=None)
    tokens = torch.empty(SMOKE_B, SMOKE_S, dtype=torch.long, device="meta")
    with torch.no_grad(), Counter() as c:
        model.forward(tokens)
    k3_flops = c.kernels["flash_attention"][1]
    pairs = k3.visible_pairs(SMOKE_S, SMOKE_S)
    dense = cfg.n_layers * 4 * SMOKE_B * SMOKE_S ** 2 * cfg.n_heads * cfg.hd
    want = reference()["dots"] - dense + cfg.n_layers * 4 * SMOKE_B * cfg.n_heads * cfg.hd * pairs
    got = c.dots_flops + k3_flops
    assert abs(got - want) <= 1e-3 * want, (got, want)
