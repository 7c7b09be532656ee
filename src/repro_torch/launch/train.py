"""Training launcher (the reference's ``repro.launch.train``).

    # a smoke config on the CPU (plain kernel versions)
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --device cpu --steps 3
    # on the card (K3 forward and its backward kernel)
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ck

Wires together: config registry, synthetic data pipeline, AdamW, the
checkpointed train step, checkpoint store (async saves + preemption
emergency save), step watchdog, and optional gradient compression.  It
prints the reference's lines.  Checkpoints hold ``{"params", "opt"}`` in
the reference's pytree layout (``convert``) and ``extra={"step",
"data"}``: a run of either package resumes from the other's.  Every
family the port serves trains (``--arch`` over ``configs.ARCHS``): a vlm's
batches carry ``prefix_embeds``, a MoE's loss adds the router's aux.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.convert import (load_params, lm_params_to_reference,
                                 opt_state_from_reference, opt_state_to_reference)
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist.compress import Compressor
from repro_torch.dist.ft import PreemptionHandler, StepWatchdog
from repro_torch.models.model import CausalLM
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.step import make_train_step


def _smoke_100m(arch: str):
    """~100M-param same-family config for the end-to-end train example."""
    base = get_smoke(arch)
    return dataclasses.replace(
        base, name=f"{arch}-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=3072, vocab_size=49152)


def build(args):
    if getattr(args, "smoke100m", False):
        cfg = _smoke_100m(args.arch)
    elif args.smoke:
        cfg = get_smoke(args.arch)
    else:
        cfg = get_config(args.arch)
    model = CausalLM(cfg, device=args.device, seed=args.seed)
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


def _trees(model: CausalLM, opt_state: dict) -> dict:
    return {"params": lm_params_to_reference(model),
            "opt": opt_state_to_reference(opt_state)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--smoke100m", action="store_true",
                    help="~100M-param same-family config (train example)")
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
    args = ap.parse_args(argv)

    cfg, model, step_fn, data_cfg = build(args)
    pipe = TokenPipeline(data_cfg)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = StepWatchdog()
    preempt = PreemptionHandler()

    opt_state = init_state({n: p for n, p in model.named_parameters()})
    start_step = 0
    if store is not None and store.latest() is not None:
        latest = store.latest()
        trees, extra = store.restore(latest, _trees(model, opt_state))
        load_params(model, trees["params"])
        opt_state_from_reference(trees["opt"], opt_state)
        pipe.restore(extra["data"])
        start_step = extra["step"]
        print(f"resumed from step {start_step}")

    print(f"arch={cfg.name} params={model.param_count():,} steps={args.steps}")

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    losses = []
    for step in range(start_step, args.steps):
        t0 = time.time()
        opt_state, metrics = step_fn(opt_state, pipe.next(), step)
        loss = float(metrics["loss"])            # waits for the step
        sync()
        losses.append(loss)
        dt = time.time() - t0
        rep = watchdog.observe(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = args.batch * args.seq / dt
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f} ms ({tps:,.0f} tok/s)"
                  + (" [STRAGGLER]" if rep.is_straggler else ""))
        if store is not None and (step + 1) % args.ckpt_every == 0:
            store.save_async(step + 1, _trees(model, opt_state),
                             extra={"step": step + 1, "data": pipe.state()})
        if preempt.requested:
            if store is not None:
                store.wait()
                store.save(step + 1, _trees(model, opt_state),
                           extra={"step": step + 1, "data": pipe.state()})
                print(f"emergency checkpoint at step {step + 1}; exiting")
            break
    if store is not None:
        store.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
