"""Serving launcher: fixed-slot batched prefill + decode.

    # full width on the card (the port's own weights from --seed)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --requests 8 --slots 4 --prompt-len 2048 --max-new 32 --max-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --requests 8 --slots 4 --prompt-len 6144 --max-new 32 --max-len 8192
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --requests 8 --slots 4 --prompt-len 2048 --max-new 32 --max-len 4096

    # a smoke config on the CPU (plain kernel versions); any arch but
    # musicgen-large (the engine does not serve the audio family: ROADMAP F6)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --device cpu

    # across cards: a (data, model) mesh, one process per rank spawned here
    # (NCCL, a card each; gloo with --device cpu)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --data 1 --model 4 --requests 8 --slots 4 --prompt-len 2048 --max-new 32 \
        --max-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke \
        --device cpu --data 2 --model 2 --requests 4 --slots 2 --prompt-len 16 --max-len 32

Prompts are tokens only, as in the reference's launcher: paligemma's
first 256 positions (its ``prefix_tokens``) then attend bidirectionally
over prompt tokens, with no image embeddings.  After a warm-up prefill
and decode step at the timed shapes (kernel build, weight copies; its
host time is printed apart), prefill and decode are timed apart by the
engine: CUDA events on the card, the host clock on the CPU.  The run prints both rates in tokens/s, the device they were
taken on, and the launches of kernel K3 in each phase (one per attention
layer per prefilled request: every layer of the dense and moe families,
zamba2's shared block once per group, none for rwkv6; none in decode).

``--data D --model M`` serves every family but audio (F6) across W = D x
M ranks (``repro_torch.dist.zero.ranked_lm``, ``repro_torch.dist.tp``):
data row d serves the requests whose id is d mod D in ``--slots`` / D
slots, its M ranks in lockstep, each holding its heads, ff and vocab
slices, its experts and its KV heads of the cache (``cache_specs``;
rwkv6's and Mamba2's recurrent states: the rank's heads); prefill splits
the prompt over the sequence, decode does not, and every rank samples
the same greedy token from the logits gathered over the vocabulary.  The rates are over all rows (tokens over the slowest row's
time).  A mesh that cannot start (more ranks than cards, a split that
cannot be made, ``dist.tp.check_tp``) fails before any rank serves.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.models.model import CausalLM
from repro_torch.serve.engine import Request, ServeEngine, check_servable


# decode steps after the probed prefill (``serve``)
PROBE_STEPS = 4


def config(args):
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    return cfg


def prompts(args, cfg) -> list:
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
            for _ in range(args.requests)]


def serve(args, mesh=None, probe=None) -> dict:
    """Serve the requests of one process (``mesh``: this rank's, from
    ``launch.mesh.make_lm_mesh``; its data row's requests).  ``probe``:
    None, or a context manager whose ``record`` (a dict) joins the
    result; after the timed run, one prefill of the first prompt and
    ``PROBE_STEPS`` decode steps of the engine's slots run inside it
    (``tools/serve_ranks.py`` profiles them).
    Returns this process's record: the finished requests' tokens by id,
    the engine's phase times, tokens and K3 launches, the set-up and
    warm-up seconds and the peak device GiB (None on the CPU)."""
    cfg = config(args)
    check_servable(cfg)
    t0 = time.perf_counter()
    if mesh is None:
        model = CausalLM(cfg, device=args.device, seed=args.seed)
        row, rows = 0, 1
    else:
        from repro_torch.dist.zero import ranked_lm

        model = ranked_lm(cfg, mesh, seed=args.seed)
        row, rows = model.placement.data_rank, model.placement.data
    say = print if mesh is not None and model.placement.rank == 0 else (lambda *a, **k: None)
    model.requires_grad_(False)
    eng = ServeEngine(model, args.slots // rows, args.max_len, seed=args.seed)
    setup = time.perf_counter() - t0
    say(f"[serve] rank 0: {cfg.name} built in {setup:.1f} s", flush=True)
    mine = [(rid, p) for rid, p in enumerate(prompts(args, cfg)) if rid % rows == row]
    cuda = model.device.type == "cuda"
    # warm-up at the timed shapes, outside the engine's phase times: the
    # kernels' build, the compute-dtype weight copies, the library's first
    # calls at each shape (on the host clock, since the build runs there)
    t0 = time.perf_counter()
    model.prefill(torch.as_tensor(mine[0][1], device=model.device)[None],
                  args.max_len, eng.cache_dtype)
    model.decode_step(torch.zeros(eng.slots, 1, dtype=torch.int64, device=model.device),
                      eng.cache, args.prompt_len)
    if cuda:
        torch.cuda.synchronize(model.device)
    warm = time.perf_counter() - t0
    say(f"[serve] rank 0: warm-up {warm:.1f} s; serving {len(mine)} requests", flush=True)
    for rid, prompt in mine:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))
    finished = eng.run()
    extra = {}
    if probe is not None:
        toks = torch.zeros(eng.slots, 1, dtype=torch.int64, device=model.device)
        with probe:
            model.prefill(torch.as_tensor(mine[0][1], device=model.device)[None],
                          args.max_len, eng.cache_dtype)
            for i in range(PROBE_STEPS):
                model.decode_step(toks, eng.cache, args.prompt_len + i)
        extra = probe.record
    return {**extra, "tokens": {r.rid: list(r.out_tokens) for r in finished},
            "phase_ms": dict(eng.phase_ms), "counts": dict(eng.tokens),
            "k3": dict(eng.k3_launches),
            "decode_steps": eng.decode_steps, "setup_s": setup, "warm_s": warm,
            "params": model.param_count(), "row": row,
            "device": torch.cuda.get_device_name(model.device) if cuda else "cpu",
            "peak_gib": (torch.cuda.max_memory_allocated(model.device) / 2**30
                         if cuda else None)}


def report(cfg, args, recs: list) -> None:
    """Print the run's lines from every process's record (one per data row
    counts: the row's M ranks serve the same requests)."""
    rows = {r["row"]: r for r in recs}.values()
    rec0 = recs[0]
    pre_ms = max(r["phase_ms"]["prefill"] for r in rows)
    dec_ms = max(r["phase_ms"]["decode"] for r in rows)
    pre_tok = sum(r["counts"]["prefill"] for r in rows)
    dec_tok = sum(r["counts"]["decode"] for r in rows)
    steps = max(r["decode_steps"] for r in rows)
    k3 = {ph: sum(r["k3"][ph] for r in rows) for ph in ("prefill", "decode")}
    mesh = "" if len(recs) == 1 else f" on a {args.data} x {args.model} mesh of ranks"
    print(f"{cfg.name} ({rec0['params']:,} parameters, {cfg.dtype}) on "
          f"{rec0['device']}{mesh}; set-up {rec0['setup_s']:.1f} s; warm-up (one prefill "
          f"and one decode step, kernel build included) {rec0['warm_s']:.1f} s")
    print(f"served {sum(len(r['tokens']) for r in rows)} requests: prefill {pre_tok} "
          f"tokens in {pre_ms:.1f} ms ({pre_tok / pre_ms * 1e3:.1f} "
          f"tok/s), decode {dec_tok} tokens in {steps} "
          f"steps, {dec_ms:.1f} ms ({dec_tok / dec_ms * 1e3:.1f} "
          f"tok/s)")
    cuda = rec0["device"] != "cpu"
    per_rank = "" if len(recs) == 1 else " on each data row's rank 0"
    print(f"K3 flash_attention launches{per_rank}: {sum(k3.values())} (prefill "
          f"{k3['prefill']}, decode {k3['decode']}; "
          f"{'kernel' if cuda else 'plain version on the CPU: 0 expected'})")
    if cuda and len(recs) > 1:
        print("peak device memory per rank, GiB: "
              + ", ".join(f"{r['peak_gib']:.2f}" for r in recs))


def finished_requests(args, cfg, recs: list) -> list:
    """The finished requests, in the order data row 0's engine finished
    them, then row 1's, ..."""
    ps = prompts(args, cfg)
    out = []
    for r in {r["row"]: r for r in recs}.values():
        for rid, toks in r["tokens"].items():
            out.append(Request(rid=rid, prompt=ps[rid], max_new_tokens=args.max_new,
                               out_tokens=toks, done=True))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="compute dtype (default: the config's)")
    ap.add_argument("--data", type=int, default=1,
                    help="ranks over the data axis (the slots and requests)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks over the model axis (tensor, sequence and expert "
                         "parallelism)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = config(args)
    check_servable(cfg)
    world = args.data * args.model
    if world == 1:
        recs = [serve(args)]
    else:
        from repro_torch.dist.tp import check_tp
        from repro_torch.launch.train import spawn_ranks

        check_tp(cfg, args.model)
        if args.slots % args.data or args.requests < args.data:
            raise ValueError(f"--slots {args.slots} and --requests {args.requests} do not "
                             f"split over {args.data} data ranks")
        recs = spawn_ranks(serve, args.data, args.model, args.device, args)
    report(cfg, args, recs)
    finished = finished_requests(args, cfg, recs)
    for r in finished[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")
    return finished


if __name__ == "__main__":
    main()
    sys.exit(0)
