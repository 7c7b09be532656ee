#!/usr/bin/env python3
"""Training across ranks, measured: the LM on a (data, model) mesh of
cards (``repro_torch.dist.zero``), one process per rank over NCCL, through
the launcher's own loop and rank spawner (``repro_torch.launch.train.run``,
``spawn_ranks``) with a per-step probe.

    # four H100s: deepseek-moe-16b's 28 layers on 1 x 4 and 2 x 2, chatglm3-6b on 4 x 1
    python3 tools/train_ranks.py --arch deepseek-moe-16b --mesh 1x4 2x2
    python3 tools/train_ranks.py --arch chatglm3-6b --mesh 4x1
    # a CPU rehearsal over gloo at smoke size
    python3 tools/train_ranks.py --arch deepseek-moe-16b --mesh 2x2 --device cpu \
        --smoke --seq 64 --warm 1 --timed 1

Per mesh, each rank builds its shard of the model from seed 0 at the
config's published widths (depth cut only by ``--layers``), bf16 compute,
float32 parameters and AdamW state, every scanned body checkpointed, and
trains on ``--batch`` x ``--seq`` global tokens (the batch over "data";
over "model" tensor, sequence and expert parallelism): ``--warm``
steps, ``--timed`` steps (the launcher's per-step clock; K3's launches are
counted over them), then one step under ``torch.profiler`` on every rank.
Prints, per mesh, ms/step, tok/s over the global batch, the share of W x
the dense bf16 peak that 6 N positions plus the attention's products make
(N the parameters a token's forward reads), each rank's peak device memory
(the whole run's, set-up included), every step's loss and grad norm, K3's
launches, and per rank the profiled step's device span, idle share and
NCCL kernel time by collective; then the card's name and power limit, and
one JSON line of the summaries.  Step 0's losses of two meshes of one model
are held to each other within 1e-3 relative (bf16 compute; the partial
sums over "model" round in bf16, and expert capacities count each
rank's sequence shard).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.hw import BF16_PEAK  # noqa: E402
from repro_torch.kernels import flash as k3  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.model import CausalLM  # noqa: E402

# NCCL kernels of a profiled step by collective (all-to-all runs as grouped
# sends and receives)
COLLECTIVES = {"all-to-all": "SendRecv", "all-gather": "AllGather",
               "reduce-scatter": "ReduceScatter", "all-reduce": "AllReduce"}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def busy_us(dev) -> float:
    """The union of device op intervals (us)."""
    busy, end = 0.0, -1.0
    for start, stop, _ in dev:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def attention_calls(cfg) -> int:
    """K3 launches per prefill: one per attention layer (zamba2's shared
    block once per group; none in rwkv6)."""
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def attention_pairs(cfg, s: int) -> float:
    """Visible (query, key) pairs of one sequence of ``s`` positions summed
    over a forward's attention calls: gemma2's local layers under their
    window, a vlm's under its prefix square, else causal."""
    pos = torch.arange(s)

    def pairs(**kw) -> float:
        return float(k3.visible_mask(pos, pos, **kw).sum())

    if cfg.layer_pattern == "local_global":
        return cfg.n_layers // 2 * (pairs(window=cfg.local_window) + pairs())
    prefix = cfg.prefix_tokens if cfg.family == "vlm" else 0
    return attention_calls(cfg) * pairs(prefix_len=prefix)


def active_params(model, cfg) -> int:
    """N of a step's 6 N tokens: the parameters one token's forward reads,
    each as often as it runs -- a MoE layer's routed experts count top_k of
    n_experts, zamba2's shared block counts once per call."""
    n = model.param_count()
    if cfg.family == "moe":
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        for block in model.layers["moe_layers"]:
            routed = sum(p.numel() for p in block.moe.experts.parameters())
            n -= routed // e * (e - k)
    if cfg.family == "hybrid":
        shared = sum(p.numel() for p in model.layers["shared"].parameters())
        n += (attention_calls(cfg) - 1) * shared
    return n


def train_flops(cfg, batch: int, seq: int) -> tuple[float, int]:
    """A step's counted flops (6 N positions plus the attention's products)
    and N, from a model on the meta device."""
    meta = CausalLM(cfg, device="meta", seed=None)
    n_active = active_params(meta, cfg)
    attn = 3 * 4.0 * cfg.hd * cfg.n_heads * batch * attention_pairs(cfg, seq)
    return 6.0 * n_active * batch * seq + attn, n_active


class RankRun(NamedTuple):
    """One measured training run: a ``data`` x ``model`` mesh (NCCL, a
    card each; gloo with ``device="cpu"``), ``batch`` global rows of
    ``seq`` tokens, ``warm`` untimed steps, ``timed`` timed ones, then one
    profiled (on the card); ``layers`` cuts the depth (None: the
    config's); ``smoke``: the config's smoke size (CPU rehearsals)."""
    arch: str
    data: int
    model: int
    batch: int
    seq: int
    warm: int
    timed: int
    layers: int | None = None
    device: str = "cuda"
    smoke: bool = False

    def args(self) -> argparse.Namespace:
        """The launcher's arguments for this run."""
        argv = ["--arch", self.arch, "--steps", str(self.warm + self.timed + 1),
                "--batch", str(self.batch), "--seq", str(self.seq), "--data",
                str(self.data), "--model", str(self.model), "--device", self.device,
                "--log-every", "1"]
        return launcher.parse_args(argv + ["--smoke"] * self.smoke
                                   + ["--layers", str(self.layers)] * bool(self.layers))

    def config(self):
        cfg = get_smoke(self.arch) if self.smoke else get_config(self.arch)
        return dataclasses.replace(cfg, n_layers=self.layers) if self.layers else cfg


def step_profile(prof) -> dict:
    """One profiled step's device time: its span (first device op's start
    to the last one's end), the union of every op (busy) and of the
    non-NCCL ops (compute), the time only NCCL kernels run (busy - compute:
    transfers and waits on peers that no compute overlaps), the idle shares
    of the span, each collective's NCCL kernel time, and the 12 kernels
    with the most time (names cut to 100 characters)."""
    from torch.autograd import DeviceType

    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    if not dev:
        return {"span_ms": None}
    span = (max(b for _, b, _ in dev) - dev[0][0]) / 1e3
    busy = busy_us(dev) / 1e3
    compute = busy_us([d for d in dev if "nccl" not in d[2].lower()]) / 1e3
    coll = {kind: sum(b - a for a, b, n in dev if "nccl" in n.lower() and key in n) / 1e3
            for kind, key in COLLECTIVES.items()}
    kernels: dict[str, float] = {}
    for a, b, n in dev:
        key = n.removeprefix("void ")[:100]
        kernels[key] = kernels.get(key, 0.0) + (b - a) / 1e3
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    return {"span_ms": span, "busy_ms": busy, "compute_ms": compute,
            "nccl_alone_ms": busy - compute, "idle_share": 1 - busy / span,
            "compute_idle_share": 1 - compute / span, "ops": len(dev),
            "collective_ms": coll, "kernels": top}


class StepProbe:
    """The launcher's per-step hook for a measured run: zeroes K3's
    counters before step ``warm``, reads them before step ``warm +
    timed``, and runs that step under ``torch.profiler`` where
    ``profile`` is set; the readings land in ``record``."""

    def __init__(self, warm: int, timed: int, profile: bool):
        self.warm, self.last, self.profile = warm, warm + timed, profile
        self.record: dict = {}

    @contextlib.contextmanager
    def __call__(self, step: int):
        if step == self.warm:
            k3.flash_attention.launches = k3.flash_attention_bwd.launches = 0
        if step != self.last:
            yield
            return
        self.record["k3_fwd"] = k3.flash_attention.launches
        self.record["k3_bwd"] = k3.flash_attention_bwd.launches
        if not self.profile:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
        self.record["profile"] = step_profile(prof)


def measure_rank(run: RankRun, mesh=None) -> dict:
    """This rank's (or, with no ``mesh``, the unsharded model's) run
    through the launcher's loop: its record with the probe's readings and
    ``step_ms``, the mean of the timed steps."""
    probe = StepProbe(run.warm, run.timed, profile=run.device == "cuda")
    rec = launcher.run(run.args(), mesh, probe)
    timed = rec["step_s"][run.warm:run.warm + run.timed]
    return {**rec, **probe.record, "step_ms": sum(timed) / len(timed) * 1e3,
            "rank": 0 if mesh is None else torch.distributed.get_rank()}


def measure(run: RankRun, timeout: float = 900) -> list[dict]:
    """Every rank's :func:`measure_rank` of ``run``, in rank order."""
    return launcher.spawn_ranks(measure_rank, run.data, run.model, run.device, run,
                                timeout=timeout)


def rank_summary(run: RankRun, results: list[dict], label: str = "") -> dict:
    """The run's numbers (rank 0's step time; every rank's peak) and a log
    line; the share of the dense bf16 peak is over all W cards.  A
    ``label`` names an unsharded run (``measure_rank`` with no mesh; give
    it a 1 x 1 ``run``)."""
    cfg = run.config()
    world = run.data * run.model
    flops, n_active = train_flops(cfg, run.batch, run.seq)
    step_ms = results[0]["step_ms"]
    tokens = run.batch * run.seq
    depth = f", depth cut to {cfg.n_layers} layers" if run.layers else ""
    ranks_ms = ", ".join(repr(r["step_ms"]) for r in results)
    name = label or f"ranks {run.arch} {run.data}x{run.model}"
    if run.device == "cuda":
        share = flops / (step_ms / 1e3) / (world * BF16_PEAK)
        rates = (f"{step_ms!r} ms/step (ranks {ranks_ms}) = {tokens / step_ms * 1e3!r} "
                 f"tok/s; (6 x {n_active:,} active x positions + attention) = "
                 f"{flops:.4e} flops = {share!r} of {world} x the dense bf16 peak; peak "
                 f"GiB per rank {[r['peak_gib'] for r in results]}")
    else:
        share = None
        rates = f"a CPU rehearsal over gloo, host ms/step {ranks_ms}; no device metric"
    layout = ("one process, no mesh" if label else
              f"{world} ranks, the batch and ZeRO-3 over {run.data}, tensor, sequence "
              f"and expert parallelism over {run.model}")
    line = (f"[{name}] {cfg.n_layers} layers{depth}, {layout}, {run.batch} x {run.seq} "
            f"tokens a step (bf16 compute, float32 parameters and AdamW state; {run.warm} "
            "warm-up steps, "
            f"{run.timed} timed): {rates}; setup {results[0]['setup_s']:.1f} s; losses "
            f"{results[0]['losses']}; grad norms {results[0]['grad_norms']}; K3 launches "
            f"in the timed steps: forward {results[0]['k3_fwd']}, backward "
            f"{results[0]['k3_bwd']}")
    for r in results:
        p = r.get("profile")
        if p and p["span_ms"] is not None:
            line += (f"\n[{name} profile rank {r['rank']}] one step: device span "
                     f"{p['span_ms']!r} ms, {p['ops']} device ops, busy {p['busy_ms']!r} ms "
                     f"(idle share {p['idle_share']!r}); compute kernels {p['compute_ms']!r} "
                     f"ms (share of the span with no compute kernel "
                     f"{p['compute_idle_share']!r}); NCCL kernels alone "
                     f"{p['nccl_alone_ms']!r} ms; NCCL kernel time, ms: "
                     + ", ".join(f"{k} {v!r}" for k, v in p["collective_ms"].items()))
        elif run.device == "cuda":
            line += (f"\n[{name} profile rank {r['rank']}] the profiler saw no device "
                     "time: idle share not measured")
    return {"step_ms": step_ms, "share": share,
            "tok_s": tokens / step_ms * 1e3 if run.device == "cuda" else None,
            "line": line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", nargs="+", required=True, help="DxM, e.g. 1x4 2x2")
    ap.add_argument("--batch", type=int, default=4, help="global rows")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--timed", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--timeout", type=float, default=1500)
    args = ap.parse_args(argv)
    summaries = {}
    for mesh in args.mesh:
        data, model = (int(v) for v in mesh.split("x"))
        run = RankRun(args.arch, data, model, args.batch, args.seq, args.warm, args.timed,
                      layers=args.layers, device=args.device, smoke=args.smoke)
        results = measure(run, timeout=args.timeout)
        summary = rank_summary(run, results)
        print(summary.pop("line"), flush=True)
        summaries[mesh] = {**summary, "step0_loss": results[0]["losses"][0],
                           "step0_grad_norm": results[0]["grad_norms"][0],
                           "peak_gib": [r["peak_gib"] for r in results],
                           "profile": [r.get("profile") for r in results]}
    first = summaries[args.mesh[0]]["step0_loss"]
    for mesh, s in summaries.items():
        rel = abs(s["step0_loss"] - first) / abs(first)
        print(f"[ranks {args.arch}] step 0 loss on {mesh}: {s['step0_loss']!r} "
              f"(rel {rel:.2e} to {args.mesh[0]}; tolerance 1e-3)")
        if rel > 1e-3:
            print("step 0 losses disagree across meshes", file=sys.stderr)
            return 1
    if args.device == "cuda":
        print(nvidia_smi())
    print(json.dumps({"arch": args.arch, "meshes": summaries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
