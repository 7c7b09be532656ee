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

Prompts are tokens only, as in the reference's launcher: paligemma's
first 256 positions (its ``prefix_tokens``) then attend bidirectionally
over prompt tokens, with no image embeddings.  After a warm-up prefill
and decode step at the timed shapes (kernel build, weight copies; its
host time is printed apart), prefill and decode are timed apart by the
engine: CUDA events on the card, the host clock on the CPU.  The run prints both rates in tokens/s, the device they were
taken on, and the launches of kernel K3 in each phase (one per attention
layer per prefilled request: every layer of the dense and moe families,
zamba2's shared block once per group, none for rwkv6; none in decode).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.kernels.flash import flash_attention
from repro_torch.models.model import CausalLM
from repro_torch.serve.engine import Request, ServeEngine, check_servable


def main(argv=None):
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
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    check_servable(cfg)
    t0 = time.perf_counter()
    model = CausalLM(cfg, device=args.device, seed=args.seed).requires_grad_(False)
    eng = ServeEngine(model, args.slots, args.max_len, seed=args.seed)
    setup = time.perf_counter() - t0
    device = (torch.cuda.get_device_name(model.device)
              if model.device.type == "cuda" else "cpu")

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    # warm-up at the timed shapes, outside the engine's phase times: the
    # kernels' build, the compute-dtype weight copies, the library's first
    # calls at each shape (on the host clock, since the build runs there)
    t0 = time.perf_counter()
    model.prefill(torch.as_tensor(prompts[0], device=model.device)[None],
                  args.max_len, eng.cache_dtype)
    model.decode_step(torch.zeros(args.slots, 1, dtype=torch.int64,
                                  device=model.device), eng.cache, args.prompt_len)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    warm = time.perf_counter() - t0
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))
    flash_attention.launches = 0
    finished = eng.run()
    launches = flash_attention.launches

    pre_ms, dec_ms = eng.phase_ms["prefill"], eng.phase_ms["decode"]
    print(f"{cfg.name} ({model.param_count():,} parameters, {cfg.dtype}) on "
          f"{device}; set-up {setup:.1f} s; warm-up (one prefill and one decode "
          f"step, kernel build included) {warm:.1f} s")
    print(f"served {len(finished)} requests: prefill {eng.tokens['prefill']} "
          f"tokens in {pre_ms:.1f} ms ({eng.tokens['prefill'] / pre_ms * 1e3:.1f} "
          f"tok/s), decode {eng.tokens['decode']} tokens in {eng.decode_steps} "
          f"steps, {dec_ms:.1f} ms ({eng.tokens['decode'] / dec_ms * 1e3:.1f} "
          f"tok/s)")
    print(f"K3 flash_attention launches: {launches} (prefill "
          f"{eng.k3_launches['prefill']}, decode {eng.k3_launches['decode']}; "
          f"{'kernel' if model.device.type == 'cuda' else 'plain version on the CPU: 0 expected'})")
    for r in finished[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")
    return finished


if __name__ == "__main__":
    main()
    sys.exit(0)
