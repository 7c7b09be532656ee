"""Training launcher (the reference's ``repro.launch.train``).

    # a smoke config on the CPU (plain kernel versions)
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --device cpu --steps 3
    # on the card (K3 forward and its backward kernel)
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ck
    # across ranks: a (data, model) mesh, one process per rank, spawned here
    # (NCCL, one card each; gloo with --device cpu); any family
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b \\
        --smoke --device cpu --data 2 --model 2 --steps 3 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --device cpu --data 2 --model 2 --steps 3 --batch 8 --seq 64 \\
        --microbatches 2 --compress int8

Wires together: config registry, synthetic data pipeline, AdamW, the
checkpointed train step, checkpoint store (async saves + preemption
emergency save), step watchdog, and optional gradient compression.  It
prints the reference's lines.  Checkpoints hold ``{"params", "opt"}`` in
the reference's pytree layout (``convert``) and ``extra={"step",
"data"}``: a run of either package resumes from the other's.  Every
family the port serves trains (``--arch`` over ``configs.ARCHS``): a vlm's
batches carry ``prefix_embeds``, a MoE's loss adds the router's aux.

``--data D --model M`` (default 1 x 1, one process) trains every family
across W = D x M ranks (``repro_torch.dist.zero``): the global batch over
"data" (the M ranks of data row d take shard d of D of each microbatch),
ZeRO-3 over "data", and over "model" tensor parallelism of heads, ff and
vocab, the stream split over the sequence between layers, and the MoE's
experts split (``repro_torch.dist.tp``).  ``--microbatches`` and
``--compress`` act as on one device: the global batch splits into
contiguous microbatches, each sharded over "data", and the compressor
sees each leaf whole.  The launcher spawns the W processes itself
(:func:`spawn_ranks`).  It raises when W exceeds the visible cards, D x
``--microbatches`` does not divide ``--batch``, or the config does not
split over M (``dist.tp.check_tp``).  Rank 0 prints, with tok/s over the global batch;
each rank's peak device memory is printed at the end.  Checkpoints are
gathered leaf by leaf and written by rank 0, in the same layout: a run
resumes on any mesh or on one card.  ``--layers`` cuts the depth.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.convert import (load_params, lm_params_to_reference,
                                 opt_state_from_reference, opt_state_to_reference)
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist.compress import Compressor
from repro_torch.dist.ft import PreemptionHandler, StepWatchdog
from repro_torch.dist.zero import ranked_lm
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models.model import CausalLM
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.step import make_train_step


def _smoke_100m(arch: str):
    """~100M-param same-family config for the end-to-end train example."""
    base = get_smoke(arch)
    return dataclasses.replace(
        base, name=f"{arch}-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=3072, vocab_size=49152)


def _config(args):
    if getattr(args, "smoke100m", False):
        cfg = _smoke_100m(args.arch)
    elif args.smoke:
        cfg = get_smoke(args.arch)
    else:
        cfg = get_config(args.arch)
    return dataclasses.replace(cfg, n_layers=args.layers) if args.layers else cfg


def build(args, mesh=None):
    """(cfg, model, step_fn, data_cfg); ``mesh``: this rank's
    (``launch.mesh.make_lm_mesh``), or None for one device."""
    cfg = _config(args)
    model = (CausalLM(cfg, device=args.device, seed=args.seed) if mesh is None
             else ranked_lm(cfg, mesh, seed=args.seed))
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    comp = Compressor(args.compress) if args.compress != "none" else None
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              compressor=comp)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
        num_codebooks=cfg.num_codebooks if cfg.family == "audio" else 0,
        prefix_tokens=cfg.prefix_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)
    return cfg, model, step_fn, data_cfg


def _trees(model: CausalLM, opt_state: dict) -> dict | None:
    """The checkpoint's trees; across ranks every rank gathers, and only
    rank 0 gets them (None elsewhere)."""
    params = lm_params_to_reference(model)
    opt = opt_state_to_reference(opt_state, model)
    return None if params is None else {"params": params, "opt": opt}


def save_checkpoint(store: CheckpointStore, step: int, model: CausalLM, opt_state: dict,
                    extra: dict, wait: bool = False) -> None:
    """Write ``{"params", "opt"}`` in the reference's layout (across ranks:
    every rank calls, rank 0 writes); ``wait=False`` writes on a thread."""
    trees = _trees(model, opt_state)
    if trees is None:
        return
    if wait:
        store.wait()
        store.save(step, trees, extra=extra)
    else:
        store.save_async(step, trees, extra=extra)


def restore_checkpoint(store: CheckpointStore, step: int, model: CausalLM,
                       opt_state: dict) -> dict:
    """Load a checkpoint of any mesh (or one card) into ``model`` and its
    AdamW state; returns its ``extra``."""
    trees, extra = store.restore_trees(step)
    load_params(model, trees["params"])
    opt_state_from_reference(trees["opt"], opt_state, model)
    return extra


def run(args, mesh=None, probe=None) -> dict:
    """Train on one device, or as this rank of ``mesh``.  ``probe``: None,
    or a callable of the step index returning a context manager entered
    around that step's work (``tools/train_ranks.py`` counts K3's launches
    and profiles a step this way).  Returns this rank's record: every
    step's loss and grad norm (across ranks: the means over the ranks) and
    seconds (the batch is made before the clock starts), the set-up
    seconds, and the peak device GiB (None on the CPU)."""
    t0 = time.perf_counter()
    cfg, model, step_fn, data_cfg = build(args, mesh)
    place = model.placement
    rank, ranks = (0, 1) if place is None else (place.rank, place.ranks)
    say = print if rank == 0 else (lambda *a, **k: None)
    row, rows = (0, 1) if place is None else (place.data_rank, place.data)
    pipe = TokenPipeline(data_cfg, shard=row, num_shards=rows,
                         microbatches=args.microbatches)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = StepWatchdog()
    preempt = PreemptionHandler()

    opt_state = init_state({n: p for n, p in model.named_parameters()})
    start_step = 0
    if store is not None and store.latest() is not None:
        extra = restore_checkpoint(store, store.latest(), model, opt_state)
        pipe.restore(extra["data"])
        start_step = extra["step"]
        say(f"resumed from step {start_step}")

    mesh_note = "" if place is None else f" mesh={place.data}x{place.model}"
    say(f"arch={cfg.name} params={model.param_count():,}{mesh_note} steps={args.steps}")

    cuda = model.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(model.device)

    sync()
    rec = {"losses": [], "grad_norms": [], "step_s": [],
           "setup_s": time.perf_counter() - t0, "peak_gib": None}
    for step in range(start_step, args.steps):
        batch = pipe.next()
        with contextlib.nullcontext() if probe is None else probe(step):
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(opt_state, batch, step)
            loss = float(metrics["loss"])            # waits for the step
            sync()
            dt = time.perf_counter() - t0
        rec["losses"].append(loss)
        rec["grad_norms"].append(float(metrics["grad_norm"]))
        rec["step_s"].append(dt)
        rep = watchdog.observe(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = args.batch * args.seq / dt
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {rec['grad_norms'][-1]:.3f} "
                f"{dt*1e3:.0f} ms ({tps:,.0f} tok/s)"
                + (" [STRAGGLER]" if rep.is_straggler else ""))
        if store is not None and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(store, step + 1, model, opt_state,
                            {"step": step + 1, "data": pipe.state()})
        if preempt.requested:
            if store is not None:
                save_checkpoint(store, step + 1, model, opt_state,
                                {"step": step + 1, "data": pipe.state()}, wait=True)
                say(f"emergency checkpoint at step {step + 1}; exiting")
            break
    if store is not None:
        store.wait()
    if rec["losses"]:
        say(f"final loss {rec['losses'][-1]:.4f} (first {rec['losses'][0]:.4f})")
    if cuda:
        rec["peak_gib"] = torch.cuda.max_memory_allocated(model.device) / 2**30
        if place is not None:
            peaks = [None] * ranks
            dist.all_gather_object(peaks, rec["peak_gib"])
            say("peak device memory per rank, GiB: " + ", ".join(f"{p:.2f}" for p in peaks))
    return rec


def _rank(rank: int, fn, args: tuple, kwargs: dict, data: int, model: int, device: str,
          addr: str, out: str) -> None:
    """One spawned rank of :func:`spawn_ranks`; rank 0 writes every rank's
    result to ``out``."""
    world = data * model
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=addr,
                            rank=rank, world_size=world)
    try:
        res = fn(*args, mesh=make_lm_mesh(data, model, device), **kwargs)
        gathered = [None] * world
        dist.all_gather_object(gathered, res)
        if rank == 0:
            torch.save(gathered, out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, data: int, model: int, device: str, *args,
                timeout: float | None = None, **kwargs) -> list:
    """Run ``fn(*args, mesh=..., **kwargs)`` as every rank of a ``data`` x
    ``model`` mesh, one process a rank (NCCL and a card each; gloo with
    ``device="cpu"``), and return the ranks' results in rank order.  More
    ranks than visible cards raise before any starts; a rank that raises,
    or ranks still running after ``timeout`` seconds (one stuck in a
    collective), raise here, and every rank is stopped."""
    world = data * model
    if device == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"a {data} x {model} mesh needs {world} cards; "
                         f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.pt")
        ctx = mp.spawn(_rank, args=(fn, args, kwargs, data, model, device, free_address(),
                                    out), nprocs=world, join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"a {data} x {model} mesh still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return torch.load(out, weights_only=False)


def free_address() -> str:
    """A ``tcp://localhost:<port>`` rendezvous on a free port."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--smoke100m", action="store_true",
                    help="~100M-param same-family config (train example)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--data", type=int, default=1,
                    help="ranks over the data axis (the batch, ZeRO-3)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks over the model axis (tensor, sequence and expert "
                         "parallelism)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the losses (across ranks: rank 0's, the means over the ranks)."""
    args = parse_args(argv)
    world = args.data * args.model
    if args.batch % (args.data * args.microbatches):
        raise ValueError(f"--batch {args.batch} does not split into {args.microbatches} "
                         f"microbatches over {args.data} data ranks")
    if world == 1:
        return run(args)["losses"]
    from repro_torch.dist.tp import check_tp

    check_tp(_config(args), args.model)
    return spawn_ranks(run, args.data, args.model, args.device, args)[0]["losses"]


if __name__ == "__main__":
    main()
