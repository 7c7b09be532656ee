"""The dry-run: every (arch x shape x mesh) cell counted for one H100 rank
of the production meshes, without allocating (the port of the reference's
``repro.launch.dryrun``, which lowers and compiles each cell for a TPU pod).

For each cell, :func:`count_cell` builds one rank's model on the meta device
under the reference's rules (``dist.sharding``, ``dist.tp``: its shards over
"model", and ZeRO-3 over the dp axes as ``dist.zero`` places it), then
counts one step of the cell's kind under ``roofline.count.Counter``: a train
step (``train.step.make_train_step``'s program, with the reference's
microbatch rule), one prefill, or one decode step.  The rank's collectives
go through ``dist.comm.CountComm`` (operand bytes by op and mesh axis), and
FSDP's gathers and reduce-scatters are added per unit
(``dist.zero.fsdp_collectives``).  It prints and returns the reference's
keys (the roofline terms of ``roofline.analysis.RooflineReport``) plus
``hbm_need`` (the counted peak live bytes of the rank) and whether the cell
fits the card's 80 GB.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun.json --metrics-out results/dryrun.jsonl

Every number is counted, with the H100's rates from ``repro_torch.hw``:
t_compute = FLOPs / the peak of the step's dtype, t_memory = bytes / HBM
bandwidth, t_collective = each mesh axis's bytes / NVLink inside an 8-card
node or the network across nodes.  Nothing runs on a device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from .. import hw
from ..configs import (ARCHS, LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec, cells, get_config,
                       input_specs)
from ..dist import tp
from ..dist.comm import CountComm, Rank
from ..dist.sharding import batch_specs, make_rules_for, param_specs, zero_dim
from ..dist.zero import _bodies, _names, fsdp_collectives
from ..models.layers import CastParams
from ..models.model import CausalLM, torch_dtype
from ..optim.adamw import AdamWConfig, apply_updates, init_state
from ..roofline.analysis import model_flops_for, report
from ..roofline.count import Counter
from ..train.step import make_train_step
from .mesh import MeshSpec, make_production_mesh, mesh_chip_count

# a decode cache of bf16 that would take more than this share of the card
# runs in float8_e4m3fn: the reference's rule, 4 GiB of a 16 GiB TPU chip
# (a quarter), is 20 GB of the H100's 80
FP8_CACHE_SHARE = 0.25


def microbatches_for(cfg) -> int:
    """The reference's rule: deep and wide models (n_layers x d_model above
    300,000) and the hybrid accumulate over 4 microbatches."""
    return 4 if cfg.n_layers * cfg.d_model > 300_000 or cfg.family == "hybrid" else 1


def rank_model(cfg, mesh: MeshSpec, kind: str, m: int = 0):
    """Model rank ``m`` of a data row of ``mesh`` on the meta device: its
    leaves cut to their "model" shards, its blocks marked with a counting
    comm.  Returns (model, rules, specs of the whole model's leaves)."""
    rules = make_rules_for(cfg, mesh.sizes(), kind=kind)
    model = CausalLM(cfg, device="meta", seed=None)
    specs = param_specs({n: p.shape for n, p in model.named_parameters()}, rules)
    M = mesh.axis_size("model")
    tp.check_tp(cfg, M)
    if M > 1:
        tp.shard_module_(model, "", specs, m, M)
    if mesh.chips > 1:
        tp.attach(model, Rank(CountComm(mesh), m, M, rules))
    return model, rules, specs


def local_rows(cfg, shape: ShapeSpec, rules: dict) -> int:
    """A rank's rows of the global batch: split over the dp axes where they
    divide it (the rules' ``fit``), else every row."""
    spec = batch_specs(cfg, {"tokens": torch.empty(shape.global_batch, device="meta")},
                       rules)["tokens"][0]
    div = 1
    for a in (spec if isinstance(spec, tuple) else (spec,) if spec else ()):
        div *= rules["_axes"][a]
    return shape.global_batch // div


def _data(rules: dict) -> tuple[int, str]:
    sizes = rules["_axes"]
    dp = [a for a in rules.get("fsdp") or () if a in sizes]
    d = 1
    for a in dp:
        d *= sizes[a]
    return d, ",".join(dp)


def _zeroed(name, p, specs, rules, data) -> int | None:
    i = zero_dim(specs[name], rules)
    return i if data > 1 and i is not None and p.shape[i] % data == 0 else None


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _resident(c: Counter, model, specs, rules) -> float:
    """The rank's parameters as live bytes: themselves at D = 1; with
    ZeRO-3 their shards, plus the gathered root unit and two gathered body
    units (the one computing and the one prefetched).  Returns the
    parameter bytes the rank holds."""
    data, _ = _data(rules)
    params = dict(model.named_parameters())
    if data == 1:
        c.resident(list(params.values()))
        return float(_nbytes(params.values()))
    held = sum(p.numel() * p.element_size() // (data if _zeroed(n, p, specs, rules, data)
                                                is not None else 1)
               for n, p in params.items())
    units, body = set(), []
    for prefix, mod, is_unit in _bodies(model):
        if is_unit:
            names = _names(mod, prefix)
            units.update(names.values())
            body.append(_nbytes(names))
    root = _nbytes(p for n, p in params.items() if n not in units)
    c.reserve(held + root + 2 * max(body, default=0))
    return float(held)


def _record(c: Counter, colls) -> None:
    for op, axes, operand, output in colls:
        c.collective(op, axes, operand, output)


def _count_train(c: Counter, model, cfg, batch: dict, specs, rules, micro: int) -> float:
    """One train step; returns the argument bytes (parameters and AdamW
    state the rank holds)."""
    data, dp = _data(rules)
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if data == 1:
        with c.paused():
            opt = init_state(params)
        state = [list(params.values()), opt["m"], opt["v"]]
        c.resident(state)
        args = sum(_nbytes(x if isinstance(x, list) else x.values()) for x in state)
        step_fn = make_train_step(model, AdamWConfig(), microbatches=micro)
        for _ in range(micro):
            _record(c, fsdp_collectives(model, specs, rules))
        step_fn(opt, batch, 0)
        return float(args)
    # ZeRO-3 over the dp axes: the step of make_train_step, with each
    # FSDP'd leaf's gradient reduce-scattered onto its shard as it is made
    # and AdamW over the shards
    shard = {}
    for n, p in params.items():
        i = _zeroed(n, p, specs, rules, data)
        size = list(p.shape)
        if i is not None:
            size[i] //= data
        shard[n] = torch.empty(size, dtype=p.dtype, device="meta")
    held = _resident(c, model, specs, rules)
    with c.paused():
        opt = init_state(shard)
    c.resident([opt["m"], opt["v"]])
    grads: dict = {}

    def reduced(name):
        def hook(p):
            grads[name] = p.grad.new_empty(shard[name].shape)
            p.grad = None
        return hook

    handles = [p.register_post_accumulate_grad_hook(reduced(n)) for n, p in params.items()
               if _zeroed(n, p, specs, rules, data) is not None]
    gsum = None
    try:
        rows = batch["tokens"].shape[0] // micro
        for i in range(micro):
            part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            _record(c, fsdp_collectives(model, specs, rules))
            prefix = part.get("prefix_embeds")
            loss, _ = model.loss(part["tokens"].long(), part["labels"], prefix_embeds=prefix)
            loss.backward()
            g = {n: grads.pop(n) if n in grads else p.grad for n, p in params.items()}
            for p in params.values():
                p.grad = None
            if micro > 1:
                if gsum is None:
                    gsum = {n: torch.zeros_like(t, dtype=torch.float32) for n, t in g.items()}
                for n in gsum:
                    gsum[n] += g[n]
            else:
                gsum = g
            # the metrics' means over the ranks (loss, ce, aux)
            c.collective("all-reduce", ",".join(rules["_axes"]), 12.0, 12.0)
    finally:
        for h in handles:
            h.remove()
    if micro > 1:
        gsum = {n: g / micro for n, g in gsum.items()}
    apply_updates(shard, opt, gsum, AdamWConfig(), 0)
    c.collective("all-reduce", ",".join(rules["_axes"]), 4.0, 4.0)    # the grad norm
    return held + _nbytes(list(opt["m"].values()) + list(opt["v"].values()))


def cache_dtype_for(model, cfg, rows: int, max_len: int) -> torch.dtype:
    """bfloat16, or float8_e4m3fn where the rank's bf16 cache would pass
    ``FP8_CACHE_SHARE`` of the card's memory (the reference's rule)."""
    cache = model.init_cache(rows, max_len, torch.bfloat16)
    per_dev = _nbytes(v for group in cache.values() for v in
                      (group.values() if isinstance(group, dict) else [group]))
    return torch.float8_e4m3fn if per_dev > FP8_CACHE_SHARE * hw.HBM_CAPACITY \
        else torch.bfloat16


def _warm_casts(c: Counter, model, dtype: torch.dtype) -> None:
    """A server's steady state: every frozen parameter's cast copy in the
    compute dtype made (``CastParams`` keeps them), uncounted, and held as
    live bytes."""
    copies = []
    with c.paused():
        for mod in model.modules():
            if isinstance(mod, CastParams):
                for name, p in mod._parameters.items():
                    if p is not None and p.dtype != dtype:
                        copies.append(mod.cast(name, dtype))
    c.resident(copies)


def count_cell(arch: str, shape_name: str, mesh: MeshSpec | None = None, *,
               shape: ShapeSpec | None = None, cfg=None, cache_dtype=None,
               verbose: bool = True) -> dict:
    """Count one cell for one rank of ``mesh`` (default: the single-pod
    production mesh): the reference's ``lower_cell`` keys, plus
    ``hbm_need`` (peak live bytes of the rank), ``fits`` (``hbm_need`` <=
    the card's 80 GB), ``cache_dtype`` (decode) and ``microbatches``
    (train).  ``shape``/``cfg`` replace the grid's shape and the arch's
    full config (a smaller cell, a cut depth); ``cache_dtype`` replaces the
    decode cache's rule.  A server's counts are its steady state: on one
    data rank the frozen weights' cast copies exist already (with ZeRO-3
    every call gathers, and casts, anew)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh()
    kind = shape.kind
    model, rules, specs = rank_model(cfg, mesh, kind)
    rows = local_rows(cfg, shape, rules)
    inputs = {k: v[:rows] for k, v in input_specs(cfg, shape).items()}
    extra: dict = {}
    t0 = time.time()
    with Counter() as c:
        if kind == "train":
            micro = microbatches_for(cfg)
            if rows % micro:
                micro = 1
            args = _count_train(c, model, cfg, inputs, specs, rules, micro)
            extra["microbatches"] = micro
        else:
            model.requires_grad_(False)
            args = _resident(c, model, specs, rules)
            if _data(rules)[0] == 1:
                _warm_casts(c, model, torch_dtype(cfg.dtype))
            _record(c, fsdp_collectives(model, specs, rules, backward=False))
            prefix = inputs.get("prefix_embeds")
            if kind == "prefill":
                model.prefill(inputs["tokens"].long(), shape.seq_len, torch.bfloat16,
                              prefix_embeds=prefix)
                extra["cache_dtype"] = "bfloat16"
            else:
                with c.paused():
                    dtype = cache_dtype or cache_dtype_for(model, cfg, rows, shape.seq_len)
                    cache = model.init_cache(rows, shape.seq_len, dtype)
                c.resident(cache)
                args += _nbytes(v for group in cache.values() for v in
                                (group.values() if isinstance(group, dict) else [group]))
                model.decode_step(inputs["tokens"].long(), cache, shape.seq_len - 1)
                extra["cache_dtype"] = str(dtype).replace("torch.", "")
    seconds = time.time() - t0
    mf = model_flops_for(cfg, kind, shape.seq_len, shape.global_batch)
    rep = report(c, arch=arch, shape=shape.name, mesh=mesh,
                 dtype=torch_dtype(cfg.dtype), model_flops=mf, argument_bytes=args)
    out = rep.to_dict()
    out.update(kind=kind, count_s=round(seconds, 2), hbm_need=float(c.peak),
               fits=bool(c.peak <= hw.HBM_CAPACITY), rows=rows,
               kernels={k: list(v) for k, v in c.kernels.items()},
               by_op={k: list(v) for k, v in c.by_op.items()}, ok=True, **extra)
    if verbose:
        print(f"[{arch} x {shape.name} @ {mesh.name}] OK  args={args / 2**30:.2f} GiB "
              f"need={c.peak / 2**30:.2f} GiB of {hw.HBM_CAPACITY / 1e9:.0f} GB "
              f"({'fits' if out['fits'] else 'does not fit'}); counted in {seconds:.1f} s")
        print(f"  terms: compute={out['t_compute'] * 1e3:.2f}ms "
              f"memory={out['t_memory'] * 1e3:.2f}ms "
              f"collective={out['t_collective'] * 1e3:.2f}ms "
              f"-> dominant={out['dominant']} "
              f"roofline_frac={out['roofline_fraction']:.3f} "
              f"useful_flops={out['useful_flops_ratio']:.3f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="count every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--metrics-out", default=None, dest="metrics_out",
                    help="write each cell's roofline terms as obs JSONL gauges "
                         "(dryrun.* names, labelled by arch/shape/mesh)")
    args = ap.parse_args(argv)
    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        if args.shape == "long_500k" and args.arch not in LONG_CONTEXT_ARCHS:
            print(f"SKIP {args.arch} x long_500k: a full-attention arch")
            return 0
        todo = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results, failures = [], 0
    t0 = time.time()
    for arch, shape_name in todo:
        for mp in meshes:
            mesh = make_production_mesh(mp)
            try:
                results.append(count_cell(arch, shape_name, mesh))
            except Exception as e:  # a cell that cannot be counted is a fault
                failures += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape_name, "mesh": mesh.name,
                                "chips": mesh_chip_count(mesh), "ok": False,
                                "error": repr(e)})
    print(f"{len(results)} cells counted in {time.time() - t0:.1f} s, {failures} failures")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out} ({len(results)} cells, {failures} failures)")
    if args.metrics_out:
        from ..obs import MetricRegistry

        reg = MetricRegistry()
        for r in results:
            labels = {"arch": r.get("arch", "?"), "shape": r.get("shape", "?"),
                      "mesh": r.get("mesh", "?")}
            reg.gauge("dryrun.ok", **labels).set(1.0 if r.get("ok") else 0.0)
            for key in ("t_compute", "t_memory", "t_collective", "roofline_fraction",
                        "useful_flops_ratio", "hbm_need"):
                if key in r:
                    reg.gauge(f"dryrun.{key}", **labels).set(float(r[key]))
        print(f"metrics -> {reg.write_jsonl(args.metrics_out)}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
