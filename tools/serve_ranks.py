#!/usr/bin/env python3
"""Serving across ranks, measured: the LM on a (data, model) mesh of cards
(``repro_torch.dist.zero.ranked_lm``, ``repro_torch.dist.tp``), one process
per rank over NCCL, through the serving launcher's own rank function and
spawner (``repro_torch.launch.serve.serve``, ``launch.train.spawn_ranks``).

    # four H100s: moonshot-v1-16b-a3b at full width on 1 x 4
    python3 tools/serve_ranks.py --arch moonshot-v1-16b-a3b --mesh 1x4
    # a CPU rehearsal over gloo at smoke size
    python3 tools/serve_ranks.py --arch moonshot-v1-16b-a3b --mesh 1x4 2x2 \
        --device cpu --smoke --prompt-len 64 --max-len 128

Per mesh, each rank builds its shard of the model from seed 0 at the
config's published widths, float32 parameters, bf16 compute (``--dtype``)
and a float32 cache, and serves ``--requests`` seeded prompts of
``--prompt-len`` tokens in ``--slots`` slots (``--slots`` / D a data row),
``--max-new`` greedy tokens each; after a warm-up prefill and decode step,
the engine times prefill and decode with CUDA events.  Then one prefill
of the first prompt and 4 decode steps run under ``torch.profiler`` (a
short window: the profiler's own processing grows with every event).
Prints, per mesh: prefill and decode tok/s over all rows, ms per decode
step, K3's launches per request in prefill, each rank's peak device
memory, and per rank the profiled window's device span, idle share and
NCCL kernel time by collective; then the card's name and power limit, and
one JSON line of the summaries.  Rank 0 logs each stage's host time as it
goes.  Every data row's ranks must produce the same
tokens (each samples from logits gathered over the vocabulary).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.train import spawn_ranks  # noqa: E402
from tools.train_ranks import nvidia_smi, step_profile  # noqa: E402


class RunProbe:
    """Profiles the calls it surrounds (on the card); its reading lands in
    ``record``.  Rank 0 logs when it is entered: the timed run is over."""

    def __init__(self, cuda: bool, t0: float):
        self.cuda, self.record, self.t0 = cuda, {}, t0

    def __enter__(self):
        if torch.distributed.is_initialized() and torch.distributed.get_rank() == 0:
            print(f"[serve-ranks] rank 0: set-up and timed run done after "
                  f"{time.perf_counter() - self.t0:.1f} s; profiling one prefill and "
                  f"{launcher.PROBE_STEPS} decode steps", flush=True)
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            self.record["profile"] = step_profile(self.prof)
        return False


def measure_rank(args, mesh=None) -> dict:
    t0 = time.perf_counter()
    rec = launcher.serve(args, mesh, probe=RunProbe(args.device == "cuda", t0))
    rank = torch.distributed.get_rank() if mesh is not None else 0
    if rank == 0:
        print(f"[serve-ranks] rank 0: done after {time.perf_counter() - t0:.1f} s",
              flush=True)
    return {**rec, "rank": rank}


def summary(args, data: int, model: int, recs: list) -> dict:
    cfg = launcher.config(args)
    rows = {r["row"]: r for r in recs}.values()
    pre_ms = max(r["phase_ms"]["prefill"] for r in rows)
    dec_ms = max(r["phase_ms"]["decode"] for r in rows)
    pre_tok = sum(r["counts"]["prefill"] for r in rows)
    dec_tok = sum(r["counts"]["decode"] for r in rows)
    steps = max(r["decode_steps"] for r in rows)
    k3_pre = sum(r["k3"]["prefill"] for r in rows) / args.requests
    name = f"serve-ranks {cfg.name} {data}x{model}"
    line = (f"[{name}] {cfg.n_layers} layers, {data * model} ranks (slots and requests "
            f"over {data}, tensor/sequence/expert parallelism over {model}), "
            f"{args.requests} requests of {args.prompt_len} tokens in {args.slots} slots, "
            f"{args.max_new} new, {cfg.dtype} compute, float32 parameters and cache: "
            f"prefill {pre_tok} tokens in {pre_ms!r} ms = {pre_tok / pre_ms * 1e3!r} tok/s; "
            f"decode {dec_tok} tokens in {steps} steps, {dec_ms!r} ms = "
            f"{dec_tok / dec_ms * 1e3!r} tok/s ({dec_ms / steps!r} ms a step); K3 launches "
            f"per request in prefill {k3_pre!r} a rank; set-up {recs[0]['setup_s']:.1f} s, "
            f"warm-up {recs[0]['warm_s']:.1f} s; peak GiB per rank "
            f"{[r['peak_gib'] for r in recs]}")
    for r in recs:
        p = r.get("profile")
        if p and p.get("span_ms") is not None:
            line += (f"\n[{name} profile rank {r['rank']}] one prefill and "
                     f"{launcher.PROBE_STEPS} decode steps: device "
                     f"span {p['span_ms']!r} ms, {p['ops']} device ops, busy {p['busy_ms']!r}"
                     f" ms (idle share {p['idle_share']!r}); compute kernels "
                     f"{p['compute_ms']!r} ms; NCCL kernels alone {p['nccl_alone_ms']!r} ms; "
                     "NCCL kernel time, ms: "
                     + ", ".join(f"{k} {v!r}" for k, v in p["collective_ms"].items()))
        elif args.device == "cuda":
            line += (f"\n[{name} profile rank {r['rank']}] the profiler saw no device "
                     "time: idle share not measured")
    for row in rows:
        same = [r["tokens"] for r in recs if r["row"] == row["row"]]
        if any(t != same[0] for t in same):
            raise AssertionError(f"data row {row['row']}: ranks produced different tokens")
    return {"line": line, "prefill_tok_s": pre_tok / pre_ms * 1e3,
            "decode_tok_s": dec_tok / dec_ms * 1e3, "decode_ms_step": dec_ms / steps,
            "peak_gib": [r["peak_gib"] for r in recs],
            "profile": [r.get("profile") for r in recs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", nargs="+", required=True, help="DxM, e.g. 1x4")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--timeout", type=float, default=1500)
    args = ap.parse_args(argv)
    summaries = {}
    for mesh in args.mesh:
        data, model = (int(v) for v in mesh.split("x"))
        argv_l = ["--arch", args.arch, "--requests", str(args.requests), "--slots",
                  str(args.slots), "--prompt-len", str(args.prompt_len), "--max-new",
                  str(args.max_new), "--max-len", str(args.max_len), "--device",
                  args.device, "--data", str(data), "--model", str(model)]
        largs = launcher.parse_args(argv_l + ["--smoke"] * args.smoke
                                    + (["--dtype", args.dtype] if args.dtype else []))
        recs = spawn_ranks(measure_rank, data, model, args.device, largs,
                           timeout=args.timeout)
        s = summary(largs, data, model, recs)
        print(s.pop("line"), flush=True)
        summaries[mesh] = s
    if args.device == "cuda":
        print(nvidia_smi())
    print(json.dumps({"arch": args.arch, "meshes": summaries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
