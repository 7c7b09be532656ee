#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, in parallel), log each source's registers
   and spills and, per instantiation, those of K3's Hopper kernels (the
   forward's and the backward's, at hd 64, 80, 128, 256) and of
   every kernel that spills, check which of K3's kernels each (dtype, hd) launches
   (read by the profiler: bf16 hd 64/80/128/256 the Hopper kernel, bf16
   hd 16 the mma.sync kernel, float32 the FMA kernel), and print the
   card's name and power limit;
2. hold the fused stream+collide kernel K1 against its plain PyTorch
   version on a small walled and a small periodic geometry: every mode x
   {LBGK, MRT} x {incompressible, quasi-compressible} x force on/off, in
   float64 and float32, and D2Q9;
3. hold the collision kernel K2 against its plain version on the same
   matrix of cases;
4. drive the main path at full size: ``make_case("spheres", scale=4)``
   (258 x 258 x 256, 236,017 tiles) with ``backend="fused"`` and NEBB
   inlet/outlet, LBGK incompressible, in float64 and float32, timed with
   CUDA events; the rw_only variant (paper §4.1, the bandwidth ceiling) in
   float64 and float32: K1 bit for bit against its plain version, then K1
   and ``Tensor.copy_`` of the same rows timed in turns (5 rounds x 20
   launches, medians); then the fused engine against the gather engine
   with the collision kernel after 10 float64 steps.
   Launch counters are zeroed just before each run and read just after;
   each kernel of the run must have launched once per step.  At the main
   path's shapes each kernel is held against its plain version and timed,
   beside its bound: K1 on the run's own state, the NEBB pass kernel
   (``csrc/nebb_pass.cu``) over the inlet and outlet nodes on K1's output
   of that state;
4b. drive the slab-sharded engine (``repro_torch.dist.lbm.ShardedLBM``) on
   the same case, fused LBGK incompressible, in float64 and float32, with D
   = 2 and D = 4 slabs on the one card: after 20 steps from t = 0 its owned
   tiles are held to the single fused engine's (1e-12 in float64, bit for
   bit reported), K1 must have launched D x steps, each slab's K1 is held
   against its plain version on the slab's state; then 100 steps from t =
   0 between CUDA events (ms per step, MFLUPS, the Eqn-10 share), the halo
   bytes per step (the reference's padded count and the bytes moved), the
   exchange alone between CUDA events, a profiler pass that traces every K1
   launch and gives the exchange's device time (its ``lbm.phase.halo``
   ranges) and the device idle share, and the peak device memory; then the
   gather engine with K2 at spheres scale 1, D = 4, float64, against the
   single gather + K2 engine, K2 launched D x steps and held per slab
   against its plain version;
5. drive the simulation-serving path (``repro_torch.sim``):
   (a) K1 over a B*T grid (B = 3 replicated tables, as ensembles launch
   it) on the small walled and periodic geometries, full mode, LBGK and
   MRT, float64 and float32: against its plain version on the same
   tables, and bit for bit against three single-replica launches;
   (b) the service at full size: ``make_case("spheres", scale=4)``,
   ``backend="fused"``, LBGK incompressible, float64 then float32,
   ``SimService(slots=4)`` with 6 sessions of 50, 55, ..., 75 steps (the
   launcher's ``--steps 50 --stagger 5``, so slots are refilled), warmed by
   ``warm_and_snapshot``, ``svc.run()`` between CUDA events: aggregate
   MFLUPS, ms per service step, peak device memory, each session's mass
   drift (finite).  K1's counter is zeroed just before the run and read
   just after; it must equal the group steps the service took (its
   ``sim.group.step`` spans).  Then K1 is launched once over the
   service's B*T tiles on its state after the run: each replica's rows
   must equal, bit for bit, a single launch over that replica's state
   with the engine's (T, 27) tables, and match the plain version on the
   same input; the NEBB pass kernel over every replica's boundary nodes
   of that output against its plain version, and its launches in the run
   equal to the group steps too.  K1 and the NEBB kernel at B = 4 are
   timed beside their bytes bounds; a profiler
   pass over 5 ensemble steps splits a step into K1 and the NEBB pass,
   and a profiled rerun of the service (a new service on the same
   registry) gives its device idle share and the device time of its
   finishes and seats.  Every profiler pass warms up inside its session
   and must trace every K1 launch of its window (a pass that lost a
   record is repeated, up to 3 passes);
   (c) parity on the card at spheres scale 1: replicas of a fused float64
   ensemble against single fused engines after 20 steps (1e-12), the
   split-stream gather engine bit for bit against the monolithic one after
   10 float64 steps, ``DenseLBM`` against the sparse engine on the duct
   case (1e-12);
   (d) a checkpoint round trip: a fused float64 service (2 slots, 3
   sessions) checkpointed after 20 steps, restored into a new service and
   finished; every session's final state bit for bit equal to an
   uninterrupted run's;
6. hold the flash-attention kernel K3 against its plain version on
   seeded unit-normal inputs: B in {1, 2} x (H, KVH) in {(4, 4), (4, 2),
   (24, 2)} x hd in {16, 64, 128, 256} x softcap in {None, 30} x causal
   on/off x S = T in {64, 129, 200, 2048} x {float32, bfloat16}; then with
   a window and with a prefix (gemma2's local layers, paligemma): bf16 at
   hd 64/128/256 and float32 at hd 64 x S = T in {200, 2048, 4500} x
   window in {1, 63, 64, 129, 1000, S} and prefix in {1, 127, 300, S + 1}
   (and window 129 with prefix 300) x softcap in {None, 50}, stopping at
   the first case beyond the bound; then at hd 80 (zamba2's shared block:
   the Hopper kernel in bf16, with its 16-column tail chunk; the FMA kernel
   in float32) x S = T in {1, 63, 64, 65, 127, 128, 129, 255, 257, 1000,
   2048} x (B, H, KVH) in {(1, 4, 2), (2, 4, 2)}, and zamba2's heads (1,
   32, 32) at 2048 x causal off, causal, windows 63 and 1000, prefixes 1,
   127 and 300, softcap 50 on four of them;
7. drive the LM serving path at full width, six models in turn, each
   freed before the next: starcoder2-3b (30 layers, d_model 3072, 24
   query heads over 2 KV heads, hd 128; 8 requests of 2048 tokens,
   max_len 4096), gemma2-2b (26 layers in 13 local/global pairs, window
   4096, attention softcap 50, hd 256, 8 query heads over 4 KV heads; 8
   requests of 6144 tokens, past the window, max_len 8192),
   paligemma-3b (18 layers, hd 256, 8 query heads over 1 KV head, a
   bidirectional prefix of 256 tokens; 8 requests of 512 tokens, max_len
   1024), deepseek-moe-16b (28 layers, the first dense, 27 MoE layers of
   64 routed experts top-6 and 2 shared, 16 heads at hd 128; bfloat16
   parameters, since its float32 ones and their bf16 copy take 98 GB),
   zamba2-2.7b (54 Mamba2 layers, a shared attention block after every 6,
   32 heads at hd 80) and rwkv6-3b (32 layers, no attention), the last
   three with 8 requests of 2048 tokens, max_len 4096: the port's own
   weights from seed 0 (float32 parameters unless said, bfloat16 compute,
   float32 cache), ``ServeEngine`` with 4 slots, 32 new tokens each,
   greedy.  K3's counters are zeroed just before each run and read just
   after: requests x attention layers launches (224 / 72 / 0 for the last
   three), all of them inside prefill calls and none inside decode calls
   (the engine reads the counter around each), of which requests x 13
   with gemma2's window and requests x 18 with paligemma's prefix.
   Prefill and decode are timed apart with CUDA events; logits after the
   run must be finite; one request's prefill logits are held against the
   same prefill with K3's plain version in its place (a sanity check: 5e-2
   of the largest logit; for deepseek with K3's top-k routing replayed, as
   a rounding can send a token to another expert; a control logs the gap
   with the plain version's window, prefix or causal mask dropped);
   deepseek's prefill must repeat bit for bit (its MoE combine sums in a
   fixed order); rwkv6's first layer's chunked WKV is held to the exact
   scan on the same inputs (the gap reported against the reference's
   1e-5 relative); a profiler pass splits one prefill and a few decode
   steps into device time and K3's share.  At each model's main shapes
   (the q/k/v of the first K3 launch of each mask in one prefill: the
   first layer, both layers of gemma2's first pair, zamba2's first shared
   block) K3 is held against its plain version and timed beside it,
   beside its operations bound over the visible (query, key) pairs and
   beside the library yardstick, which the port never calls and which is
   held to the same bound: ``scaled_dot_product_attention`` with the same
   mask, or, where gemma2's softcap applies, ``flex_attention`` with the
   softcap as its score_mod and the mask as its block mask;
8. the training path, after the serving models are freed:
   (a) K3's backward kernel (``csrc/flash_attn_bwd.cu``), from the lse of
   K3's forward, against its plain version on float64 copies of the
   inputs, dQ, dK and dV element by element within
   ``kernels.flash.error_bound_bwd``: float32 and bfloat16 x hd
   16/32/64/80/128/256 x G in {1, 2, 12} (2 KV heads) x S = T in {64, 200,
   1024} x causal, window 70, prefix 130, softcap 30, and all three (bf16
   at hd 64/80/128/256 runs the Hopper kernels);
   (b) the backward at the layers of starcoder2-3b, musicgen-large and
   zamba2-2.7b's shared attention (hd 80) (B = 2, S = 4096), gemma2-2b's
   local layer (hd 256, window 4096, softcap 50; S = 6144, so that the
   window hides keys) and paligemma-3b's (8 query heads over 1 KV head at
   hd 256, prefix 256; S = 4352, its training length) (bf16, causal)
   against its plain version, element by element and norm-wise, with planted
   faults (a query head dropped, each row's own 64-key tile left out of
   dQ) that the checks must reject, timed (median of 50 launches) beside
   its operations bound (10 hd flops per visible pair and head) and, in
   turns, beside the backward through autograd of
   ``scaled_dot_product_attention`` (causal, or with the prefix's boolean
   mask), or of ``flex_attention`` where the softcap applies (the library yardstick,
   which the port never calls); its kernels' device time (profiled) and
   the longest and average block's tile iterations;
   (c) starcoder2-3b trained at full width: ``make_train_step`` on
   ``TokenPipeline`` batches of 2 x 4096 tokens, bf16 compute, float32
   parameters and AdamW state, each layer under ``torch.utils.checkpoint``;
   2 warm-up steps, then 5 between CUDA events: ms/step, tokens/s, the
   share of the dense bf16 peak that 6 N tokens plus the attention's flops
   make, peak memory, every step's loss and grad norm (finite); K3's
   counters are zeroed just before the timed steps and read just after:
   forward 2 x 30 per step (each layer runs again in the backward),
   backward 30; one profiled step gives the device idle share, K3's
   forward and backward shares of device busy time and the backward's
   device time by kernel;
   (d) musicgen-large likewise with (B, S, 4) tokens and 3 timed steps,
   after the model-level prefill (2 x 1024 x 4 tokens) and 4 decode steps
   with (B, 1, 4) tokens, whose logits must be finite and (2, 1, 4, 2048)
   (``ServeEngine`` refuses the audio family, ROADMAP F6);
   (e) the other families likewise, 3 timed steps each: gemma2-2b (13
   local/global pairs, each pair one checkpointed body; its 4096-key window
   hides no key at S 4096, so no launch may apply it), paligemma-3b (2 x
   (256 prefix + 4096 text) positions; every forward launch applies the
   prefix), rwkv6-3b (the chunked WKV; no K3), zamba2-2.7b (the chunked
   SSD; each group of 6 Mamba2 layers with the shared block is one body:
   K3 at hd 80 on 9 calls; then the largest dt A of one forward, against
   float32 exp's underflow) and deepseek-moe-16b at full width and 4 of
   its 28 layers (the dense layer and 3 MoE layers: the capacity dispatch,
   the combine and the aux loss under autograd).  K3 must launch 2 x and
   its backward 1 x the attention calls per step (26 / 18 / 0 / 9 / 4);
   the flops count 6 N positions with N the parameters a token's forward
   reads as often as it runs (a MoE layer's top-6 of 64 routed experts,
   zamba2's shared block 9 times) plus the attention's products over each
   launch's visible pairs, not the WKV's or the SSD's own products;
9. the LM across ranks: (a) expert parallelism (``moe_ffn_ep``) at
   deepseek-moe-16b's layer width (d 2048, 64 routed experts top-6 of d_ff
   1408, 2 shared), M = 4 ``LocalComm`` ranks on the card, 4096 tokens a
   rank, float32, against ``moe_ffn`` on the same 16,384 tokens with the
   ranks' routing replayed: at capacity factor 2.0 no pair dropped
   (asserted), outputs within 1e-5 of the largest and the aux within 1e-6
   relative; each path's drop fraction at the config's 1.25; (b)
   deepseek-moe-16b at full width and 4 layers through the ranked path
   (``repro_torch.dist.zero``: ZeRO-3 with FSDP2, experts over "model"),
   one NCCL rank per visible card, mesh 1 x W, spawned by the launcher's
   ``spawn_ranks`` and trained by its loop (``tools/train_ranks.py``), and
   the unsharded model through the same loop in this process: 2 warm-up
   and 3 timed steps on max(2, W) x 4096 tokens, then one profiled; K3's
   counters zeroed just before the timed steps and read just after on
   every rank (forward 3 x 2 x 4, backward 3 x 4); step 0's loss and grad
   norm held to the unsharded step's on the same batch from the same seed
   (1e-6 relative at W = 1, where nothing is split; 1e-3 and 1e-2 at W >
   1); both runs' ms/step and profiled step printed side by side;
10. tensor and sequence parallelism over "model" (``repro_torch.dist.tp``)
   with M = 4 ``LocalComm`` ranks on the card, float32 parameters, bf16
   compute, each held to the unsharded layer on the same input with the
   stated tolerance (``TP_RATIO``): (a) chatglm3-6b's block (2 KV heads:
   each rank holds half a KV head's columns and gathers K and V) at B 1 x
   S 4096, forward and backward; (b) moonshot-v1-16b-a3b's MoE layer at B 1
   x S 2048, forward, with the sequence split, the shared experts over ff
   and the routed experts over "model" (capacity factor 2.0: no pair
   dropped, asserted; the unsharded layers replay the ranks' routing);
   (c) the slice's main path: moonshot-v1-16b-a3b at full width cut to 2
   layers (its dense layer and one MoE layer), split over the 4 ranks, a
   2048-token prefill (K3's counters zeroed just before and read just
   after: 4 ranks x 2 layers) and 4 greedy decode steps, the logits equal
   on every rank and finite; the unsharded model in bf16 and in float32
   fed the same tokens with the ranks' routing replayed, and the TP
   prefill's and each decode step's logits held to ``TP_RATIO`` as (a) and
   (b); the TP greedy token is float32's wherever float32's top-2 margin
   exceeds twice the unsharded bf16 model's largest logit error; K3 at one
   rank's shape there (S 2048, H = KVH = 4,
   hd 128, causal) held to its plain version (``error_bound``) and timed
   beside SDPA and its operations bound (``flash_attention_tp``);
   (d) the four ``examples/torch`` twins at their own sizes
   (``train_lm`` at ``--steps 20``), each in its own process: each exits 0
   and its last line's numbers are finite;
11. the ssm, hybrid, vlm and audio families across ranks
   (``repro_torch.dist.tp``): rwkv6-3b (2 layers), zamba2-2.7b (one group:
   6 Mamba2 layers and the shared block, its LoRA drawn), paligemma-3b (2
   blocks) and musicgen-large (2 blocks) at full width, float32
   parameters, bf16 compute, each split over M = 4 ``LocalComm`` ranks on
   the card: a train forward and backward of B 1 x 2048 positions
   (paligemma's 256 prefix among them; musicgen's (B, S, 4) tokens), the
   sequence split over the ranks, K3's counters zeroed just before and
   read just after (forward 2 x, backward 1 x the attention calls x 4
   ranks); every gradient (gathered whole) held norm-wise, with
   ``TP_RATIO``, against the unsharded model on the same weights in bf16
   and float32 (a gradient that is zero in float32 is listed, not held),
   the loss within 1e-3 of float32's; then a TP prefill of 2048 positions (K3: the attention calls x
   4 ranks) and 4 greedy decode steps (``prefill_ranks`` /
   ``decode_ranks``; musicgen's with (B, 1, 4) tokens), the logits equal
   on every rank, finite and held with ``TP_RATIO`` against the unsharded
   model fed the same tokens, the greedy tokens float32's wherever its
   top-2 margin exceeds twice the unsharded bf16 model's error; K3 at one
   rank's shape of each attending family (the first call of the ranks'
   training forward: paligemma's S 2048, H 2, KVH 1, hd 256, prefix 256;
   zamba2's H = KVH = 8 at hd 80; musicgen's 8 at hd 64) against its plain
   version (``error_bound``), timed beside SDPA (median of 50 launches)
   and its bound, and K3's backward there against its plain version
   (``error_bound_bwd``, norm-wise ``K3_BWD_NORM_REL``) beside SDPA's
   backward; then a ranked 1 x 1 step (one spawned NCCL rank)
   of chatglm3-6b at full width and 2 layers with 2 microbatches and int8
   compression, bit for bit the unsharded step with the same
   microbatches and compressor (loss, grad norm, a SHA-256 of every
   parameter after the step);
[dryrun]. the dry-run held to the card (``repro_torch.roofline``): (a) the
   spheres case of phase 4 counted as one slab on the meta device
   (``ShardedLBM.count_step``), f64 and f32: K1's counted bytes must be the
   kernels line's, and its t_memory, t_compute and bound are printed beside
   phase 4's ms a step; (b) starcoder2-3b's train step at 2 x 4096 on one
   card counted on the meta device (``launch.dryrun.count_cell``) and a real
   step counted on the card under the same ``Counter``: FLOPs and bytes
   within 1 % (every op that differs named), the counted peak within 10 %
   of ``max_memory_allocated``; (c) one decode step of
   ``ServeEngine(slots=4)`` on the same weights against the counted
   decode's t_memory.  No measured step may come in under its counted bound
   by more than ``DRYRUN_SLACK``;
12. print the ``kernels`` JSON line (K1, K2 and the NEBB pass kernel as
   the phases above ran them, K3 once for each serving run that attends, named for its
   mask or path: ``flash_attention``, ``_window``, ``_prefix``, ``_moe``
   at deepseek's hd 128, ``_hd80`` at zamba2's hd 80, ``_tp`` at
   moonshot's per-rank shape under tensor parallelism, ``_tp_paligemma``,
   ``_tp_zamba2`` and ``_tp_musicgen`` at phase 11's rank shapes
   (launches: those of the TP prefill), and K3's backward,
   ``flash_attention_bwd``, with its launches in starcoder2's timed
   training steps, its launches per step in each training run, its
   numbers at starcoder2's layer shape, the kernel of each of its widths
   and its numbers at the other layers of (b) and at phase 11's rank
   shapes), the
   ``nvidia-smi`` line and, last, the result line ``{"ok": true,
   "device": {...}}``.

Tensor parallelism (phase 10): the sharded bf16 layer and the unsharded
bf16 layer are each held to the float32 layer on the same weights and
input, norm-wise per output (and per gradient).  Where the unsharded
layer rounds one product of a row-parallel weight, the sharded one rounds
its M partial products and their M - 1 sums (in bf16, on the comm): for
partials of norm |a| / sqrt(M) that adds rounding error of norm about
2**-9 |a| sqrt((2M - 1) / M) < sqrt(2) 2**-9 |a|, so the sharded layer's
distance to float32 stays within (1 + sqrt(2)) of the unsharded one's;
``TP_RATIO`` = 2.5 is allowed.

Tolerances: 1e-12 absolute in float64, 1e-5 absolute in float32 on values
of order 0.1 — the kernels sum in another order than the plain versions
(and contract multiply-adds), so the last bits differ.  Collision results
are compared at fluid slots: the plain quasi-compressible math divides by
rho = 0 at solid slots before masking them.  K3: element by element,
``kernels.flash.error_bound`` — 1e-5 absolute in float32 (outputs of
order 1); in bfloat16 2**-7 (|plain| + P |v|), P |v| the same attention
over |v|: both versions compute in float32 and round to bfloat16 once, so
they differ by one bf16 ulp where their float32 results straddle a
rounding boundary, and K3's bf16 rounding of p in p.v moves an output by
at most 2**-8 (P |v|) however much its terms cancel (twice that is
allowed, as for the ulp).  K3's backward: ``kernels.flash.
error_bound_bwd`` -- 2**-14 (|plain| + mass) in float32 and 2**-7 (|plain|
+ mass) in bfloat16, the mass being each output's sum over absolute
values (P^T |dO|; scale M^T |q| and scale M |k| with M = p (|dO| |V|^T +
rowsum(|dO| o |O|)) bounding |dS| and its roundings): a blocked float32
sum's error, and in bfloat16 one ulp of the output plus the kernel's bf16
rounding of p and dS, doubled; at the training shapes also ||kernel -
plain|| / ||plain|| <= 2**-6 per output (each bf16 rounding moves an
output by at most 2**-8 of itself, and the roundings of p and dS add up
like the output's own terms).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.core import collision as C  # noqa: E402
from repro_torch.core.dense import DenseLBM  # noqa: E402
from repro_torch.core.engine import LBMConfig, SparseTiledLBM  # noqa: E402
from repro_torch.core.lattice import get_lattice  # noqa: E402
from repro_torch.core.tiling import SOLID, tile_geometry  # noqa: E402
from repro_torch.data import geometry as geo  # noqa: E402
from repro_torch.dist.lbm import ShardedLBM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.dist.comm import LocalComm  # noqa: E402
from repro_torch.kernels import collide as k2  # noqa: E402
from repro_torch.kernels import flash as k3  # noqa: E402
from repro_torch.kernels import nebb_pass as nebb  # noqa: E402
from repro_torch.kernels import stream_collide as k1  # noqa: E402
from repro_torch.launch import lbm as launcher  # noqa: E402
from repro_torch.launch import sim_serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import (CausalLM, decode_ranks, loss_ranks,  # noqa: E402
                                      prefill_ranks)
from repro_torch.launch.train import spawn_ranks  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_state  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.sim.service import SimService  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.dist import tp  # noqa: E402
from repro_torch.dist.sharding import param_specs  # noqa: E402
from repro_torch.hw import HBM_BYTES_PER_S, PEAK_FLOPS  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch.dryrun import count_cell  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.roofline.analysis import bound_ms  # noqa: E402
from repro_torch.roofline.count import Counter, differences  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from tools.train_ranks import (RankRun, step_digest, train_flops,  # noqa: E402
                               attention_calls, busy_us, measure,
                               measure_rank, nvidia_smi, rank_summary)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the [dryrun] phase: a measured step may come in under its counted bound
# by this factor at most (the bound's rates are the data sheet's peaks)
DRYRUN_SLACK = 1.05
# the sharded bf16 layer's norm-wise distance to the float32 layer, over
# the unsharded bf16 layer's (module docstring, phase 10)
TP_RATIO = 2.5
TP_RANKS = 4
# phase 11: the families placed across ranks in this slice, at full width
# and this depth (zamba2: one group of 6 Mamba2 layers and the shared
# block), over positions a step and a prompt (paligemma's 256 prefix among
# them)
TP_FAMILIES = (("rwkv6-3b", 2), ("zamba2-2.7b", 6), ("paligemma-3b", 2),
               ("musicgen-large", 2))
TP_FAMILY_SEQ = 2048
# the example twins, their arguments and time limits (s)
EXAMPLES = (("quickstart.py", (), 300), ("sparse_flow.py", (), 300),
            ("serve_lm.py", (), 300), ("train_lm.py", ("--steps", "20"), 600))
# timed steps per full-size run: the spheres case's velocity inlet diverges
# at dead-end inlet nodes (in the JAX package too) and turns non-finite
# near step 170, so every run restarts from t = 0 and stays well short
STEPS = 100
WARM = 20
PARITY_STEPS = 10
# rw_only: rounds x launches of the kernel and copy_ in turns
ROUNDS, REPS = 5, 20
SOURCE = "src/repro_torch/csrc"
# the simulation-serving run: the launcher's --sessions 6 --slots 4
# --steps 50 --stagger 5 (budgets stay under the spheres case's divergence)
SIM_SLOTS, SIM_SESSIONS, SIM_STEPS, SIM_STAGGER = 4, 6, 50, 5
ENS_BATCH = 3                # K1 over a B*T grid on the small geometries
# the sharded engine: slab counts on the one card, and the steps after
# which its owned tiles are held to the single engine's
SHARD_SLABS = (2, 4)
SHARD_PARITY_STEPS = 20
# K3 with a window and a prefix: (dtype, hd) of each kernel path that
# serves them (Hopper at hd 64/128/256, the FMA kernel in float32), S = T,
# and (window, prefix) cases: tile edges, a window of one key, 1000, one
# "S" or more; prefixes short of and across 128-row blocks, "S" or more
K3_MASK_KERNELS = ((torch.bfloat16, 64), (torch.bfloat16, 128),
                   (torch.bfloat16, 256), (torch.float32, 64))
K3_MASK_LENGTHS = (200, 2048, 4500)
K3_MASKS = ([(w, 0) for w in (1, 63, 64, 129, 1000, "S")]
            + [(None, p) for p in (1, 127, 300, "S")] + [(129, 300)])


class ServeRun(NamedTuple):
    """One serving run at full width."""
    arch: str
    slots: int
    max_len: int
    requests: int
    prompt: int
    new: int
    param_dtype: str | None = None   # None: the config's


# the serving runs: starcoder2 (global causal), gemma2 (prompts past its
# 4096-key window: every local layer masks and its ring wraps), paligemma
# (a 256-token bidirectional prefix), deepseek-moe-16b (K3 at hd 128 on
# every layer, the MoE FFN; its float32 weights and their bf16 copy, 98 GB,
# do not fit in 80 GB, so its weights are bf16), zamba2-2.7b (K3 at hd 80
# in the shared block once per group of 6 Mamba2 layers), rwkv6-3b (no
# attention: no K3)
SERVE_RUNS = (ServeRun("starcoder2-3b", 4, 4096, 8, 2048, 32),
              ServeRun("gemma2-2b", 4, 8192, 8, 6144, 32),
              ServeRun("paligemma-3b", 4, 1024, 8, 512, 32),
              ServeRun("deepseek-moe-16b", 4, 4096, 8, 2048, 32, "bfloat16"),
              ServeRun("zamba2-2.7b", 4, 4096, 8, 2048, 32),
              ServeRun("rwkv6-3b", 4, 4096, 8, 2048, 32))
# K3 at zamba2's head dim (the Hopper kernel with its 16-column tail chunk
# in bf16, FMA in float32): ragged lengths around the Hopper kernel's
# 128-row blocks and 128-key tiles (and the FMA kernel's 64); (B, H, KVH):
# GQA and two batches (and zamba2's (1, 32, 32) at its prompt length,
# 2048); (causal, window, prefix) masks, each with softcap None and, where
# marked, 50
K3_HD80_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 255, 257, 1000, 2048)
K3_HD80_HEADS = ((1, 4, 2), (2, 4, 2))
K3_HD80_MASKS = (((False, None, 0), True), ((True, None, 0), True), ((True, 63, 0), False),
                 ((True, 1000, 0), True), ((True, None, 1), False),
                 ((True, None, 127), True), ((True, None, 300), False))
# K3's backward kernel against its plain version: S = T, (G, KVH) with H =
# G x KVH (starcoder2's G = 12), and (window, prefix, softcap) masks
K3_BWD_LENGTHS = (64, 200, 1024)
K3_BWD_GROUPS = (1, 2, 12)
K3_BWD_MASKS = ((None, 0, None), (70, 0, None), (None, 130, None), (None, 0, 30.0),
                (40, 100, 30.0))
# the layers K3's backward is held and timed at, arch -> (B, S, prefix):
# starcoder2's (G = 12 at hd 128), musicgen's (hd 64) and zamba2's shared
# attention (hd 80) at the training runs' 2 x 4096; gemma2's local layer
# (hd 256, its attention softcap) at 6144, so that its 4096-key window
# hides keys; paligemma's (G = 8 at hd 256) at its training length, its
# 256-position prefix and 4096 text positions
K3_BWD_LAYERS = {"starcoder2-3b": (2, 4096, 0), "musicgen-large": (2, 4096, 0),
                 "zamba2-2.7b": (2, 4096, 0), "gemma2-2b": (2, 6144, 0),
                 "paligemma-3b": (2, 4352, 256)}
# At those shapes the backward's bf16 outputs are also held norm-wise:
# ||kernel - plain|| / ||plain|| per output.  Each version rounds every
# output to bf16 once (at most 2**-8 relative) and the kernel rounds p and
# dS to bf16, whose errors add up like the outputs themselves (random
# signs), so the distance stays near 2**-8; four times that is allowed.
# Where many terms cancel, error_bound_bwd's element-wise bound is loose
# beside the value it checks; planted faults show that the two checks
# together reject a kernel that drops one query head or each row's own
# 64-key tile.
K3_BWD_NORM_REL = 2.0 ** -6


class TrainRun(NamedTuple):
    """One training run at full width: ``warm`` untimed steps, then
    ``timed`` steps between CUDA events; ``layers`` cuts the depth (None:
    the config's)."""
    arch: str
    batch: int
    seq: int
    warm: int
    timed: int
    layers: int | None = None


# every family at the reference's train_4k sequence length (text tokens;
# paligemma's 256 prefix positions come on top), batch 2, bf16 compute,
# float32 parameters and AdamW state, each scanned body checkpointed.
# deepseek-moe-16b keeps its first dense layer and 3 MoE layers of 27: its
# 28 layers' state (16.4 B parameters, 262 GB) needs four cards
# (tools/train_ranks.py; phase 9 runs the ranked path at 4 layers)
TRAIN_RUNS = (TrainRun("starcoder2-3b", 2, 4096, 2, 5),
              TrainRun("musicgen-large", 2, 4096, 2, 3),
              TrainRun("gemma2-2b", 2, 4096, 2, 3),
              TrainRun("paligemma-3b", 2, 4096, 2, 3),
              TrainRun("rwkv6-3b", 2, 4096, 2, 3),
              TrainRun("zamba2-2.7b", 2, 4096, 2, 3),
              TrainRun("deepseek-moe-16b", 2, 4096, 2, 3, layers=4))


# the kernel names of K3's forward and backward in a profiler trace
K3_FWD_NAME, K3_BWD_NAME = "flash_fwd", "flash_bwd"


# the kernel of csrc/flash_attn.cu that each (dtype, hd) must launch
K3_KERNEL_OF = {("float32", hd): "flash_fwd_kernel" for hd in (16, 64, 80, 128, 256)} | {
    ("bfloat16", 16): "flash_fwd_mma_kernel"} | {
    ("bfloat16", hd): "flash_fwd_wgmma_kernel" for hd in (64, 80, 128, 256)}
# the kernels of csrc/flash_attn_bwd.cu that each (dtype, hd) must launch
# after prep_kernel; the Hopper kernels' grid splits a KV head's group, so
# they add group_sum_kernel where G > 1
K3_BWD_KERNELS_OF = {("float32", hd): ("dkdv_kernel", "dq_kernel")
                     for hd in (16, 32, 64, 80, 128, 256)} | {
    ("bfloat16", hd): ("dkdv_kernel", "dq_kernel") for hd in (16, 32)} | {
    ("bfloat16", hd): ("dkdv_wgmma_kernel", "dq_wgmma_kernel") for hd in (64, 80, 128, 256)}


def k3_bwd_kernels(dtype: str, hd: int, group: int) -> tuple[str, ...]:
    """The kernels (sorted names) one K3 backward launch of (dtype, hd)
    with G = ``group`` must run, from ``K3_BWD_KERNELS_OF``."""
    main = K3_BWD_KERNELS_OF[dtype, hd]
    split = group > 1 and "dkdv_wgmma_kernel" in main
    return tuple(sorted(("prep_kernel", *main) + (("group_sum_kernel",) if split else ())))


def model_mask(cfg) -> str:
    """The mask that sets a model apart, whose K3 launch fills the model's
    entry of the kernels line: gemma2's local layers' window, a vlm's
    prefix, else the causal mask."""
    if cfg.layer_pattern == "local_global":
        return "window"
    return "prefix" if cfg.family == "vlm" else "causal"


def kernel_entry(cfg) -> str:
    """The model's K3 entry of the kernels line, named for what sets its
    launches apart: gemma2's window, a vlm's prefix, zamba2's hd 80 (the
    Hopper kernel's 16-column tail chunk), the MoE family's layers; else
    causal K3."""
    mask = model_mask(cfg)
    if mask != "causal":
        return f"flash_attention_{mask}"
    if cfg.hd == 80:
        return "flash_attention_hd80"
    return "flash_attention_moe" if cfg.family == "moe" else "flash_attention"


def call_mask(kw: dict) -> str:
    """The mask of one K3 call's keyword arguments."""
    if kw.get("window") is not None:
        return "window"
    return "prefix" if kw.get("prefix_len") else "causal"


def log(msg: str) -> None:
    print(msg, flush=True)


# cycles of a spin kernel that keeps the card busy while the host enqueues
# the timed launches (~10 ms at the H100's clocks)
LEAD_CYCLES = 20_000_000


def time_ms(fn, reps: int, warm: int = 2, label: str = "") -> float:
    """Median milliseconds of ``reps`` calls of ``fn`` (after ``warm``),
    each between two CUDA events on the current stream.  A spin kernel
    runs first, so that the launches queue up behind it and the events
    time the device's work, not the host's launch rate (for kernels
    shorter than their wrapper's host time).  With ``label``, logs the
    median, the 80th percentile and the sample count."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(LEAD_CYCLES)
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    times = np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    if label:
        log(f"[time] {label}: median {np.median(times):.4f} ms, p80 "
            f"{np.percentile(times, 80):.4f} ms over {reps} launches")
    return float(np.median(times))


def interleaved_ms(fns: dict, warm: int = 2) -> dict[str, float]:
    """Median milliseconds per call of each of ``fns``, timed in turns:
    ``ROUNDS`` rounds, each running every function ``REPS`` times with a
    CUDA event after each call, the order reversed every other round, so
    that a drift of the host or the clocks favours none of them."""
    for fn in fns.values():
        for _ in range(warm):
            fn()
    names, samples = list(fns), {name: [] for name in fns}
    for r in range(ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(REPS + 1)]
            events[0].record()
            for ev in events[1:]:
                fns[name]()
                ev.record()
            events[-1].synchronize()
            samples[name] += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {name: float(np.median(v)) for name, v in samples.items()}


WINDOW = "chip_smoke.window"


# The kernel of ``torch.cuda._sleep``: launched first in a profiled window,
# its record marks the window's start on the device's clock.
MARKER_KERNEL = "spin_kernel"


PROFILE_PASSES = 3


K1_KERNEL = "stream_collide_kernel"


def _trace_once(fn, warm, scopes=()) -> tuple[list | None, list, int, str, dict]:
    """One profiler session: ``warm()``, then ``fn()`` inside a window.
    Returns the device ops (start us, end us, name) that start inside the
    window, sorted, the top-level host torch ops inside it, the K1
    launches ``fn`` made by the wrapper's own count, K1's records against
    its launches over the whole session, warm-up included, and for each
    name in ``scopes`` the device time (us) of the kernels launched under
    the host ranges of that name in the window (``obs.phase_scope`` ranges,
    with device annotations on).

    The window's device ops are told apart on the device's own clock: the
    profiler places device records against host ones with an offset that
    can be off by milliseconds, so a kernel launched inside the window may
    carry a start before the window's host start.  The window opens with
    a marker kernel, launched after the warm-up has finished on the card,
    and every device op that starts at or after the marker is the window's.
    Device ops come back as None when the marker's record was lost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        first = k1.stream_collide_tiles.launches
        warm()
        torch.cuda.synchronize()
        with record_function(WINDOW):
            torch.cuda._sleep(1)
            before = k1.stream_collide_tiles.launches
            fn()
            launched = k1.stream_collide_tiles.launches - before
            torch.cuda.synchronize()
    events = prof.events()
    session = (sum(e.device_type == DeviceType.CUDA and K1_KERNEL in e.name
                   for e in events),
               k1.stream_collide_tiles.launches - first)
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA and e.name != WINDOW
              and not getattr(e, "is_user_annotation", False)]
    marks = [start for start, _, name in device if MARKER_KERNEL in name]
    dev = None
    if len(marks) == 1:
        dev = sorted(op for op in device
                     if op[0] >= marks[0] and MARKER_KERNEL not in op[2])
    elif not device:
        dev = []
    (window,) = [e for e in events
                 if e.name == WINDOW and e.device_type == DeviceType.CPU]
    t0 = window.time_range.start
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::") and e.cpu_parent is not None
            and e.cpu_parent.name == WINDOW]
    scope_us = {name: sum(e.device_time_total for e in events
                          if e.name == name and e.device_type == DeviceType.CPU
                          and e.time_range.start >= t0) for name in scopes}
    return (dev, host, launched, "{} records of {} launches".format(*session),
            scope_us)


def traced(fn, warm, what: str,
           scopes=()) -> tuple[list, list, list[float], dict]:
    """``fn()`` under ``torch.profiler``, after ``warm()`` in the same
    session (a session can lose the records of the first kernels it sees,
    so the warm-up takes that loss and only what ``fn`` runs is kept).
    Returns ``_trace_once``'s device and host ops, K1's launch times (us)
    and the device time under each of ``scopes``.  A trace must hold every
    K1 launch ``fn`` made: the profiler now and then drops a kernel record,
    so a pass that lost one, or lost the window's marker, is discarded and
    repeated, up to ``PROFILE_PASSES`` passes; ``fn`` and ``warm`` must
    therefore be repeatable.  An empty trace (the profiler saw no device
    time) is returned as it is."""
    for attempt in range(1, PROFILE_PASSES + 1):
        dev, host, launched, session, scope_us = _trace_once(fn, warm, scopes)
        if dev is None:
            log(f"[profiler] pass {attempt} of {PROFILE_PASSES} over {what} lost "
                f"the window's marker kernel (whole session: {session}): pass "
                "discarded")
            continue
        k1_us = [b - a for a, b, name in dev if K1_KERNEL in name]
        if not dev or len(k1_us) == launched:
            return dev, host, k1_us, scope_us
        log(f"[profiler] pass {attempt} of {PROFILE_PASSES} over {what} traced "
            f"{len(k1_us)} of K1's {launched} launches (whole session, warm-up "
            f"included: {session}): pass discarded")
    raise AssertionError(f"the profiler did not trace all of K1's {launched} "
                         f"launches in {what}, in each of {PROFILE_PASSES} passes")


def rw_only_design(f: torch.Tensor, out: torch.Tensor, nbytes: int) -> str:
    """Which kernel K1's rw_only copy of ``nbytes`` from ``f`` into ``out``
    launches, and its shape, as ``csrc/stream_collide.cu`` chooses them:
    the bulk ring (its ``CHUNKS`` chunks of ``CHUNK`` bytes per one-warp
    block, read from the source) when the two are aligned alike mod 16,
    else the register kernel."""
    if f.data_ptr() % 16 != out.data_ptr() % 16:
        return "vector (register kernel, f and out aligned unlike mod 16)"
    src = (ROOT / SOURCE / "stream_collide.cu").read_text()
    chunk, chunks = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                     for k in ("CHUNK", "CHUNKS"))
    grid = -(-nbytes // (chunk * chunks))
    return (f"bulk ring, {chunks} chunks of {chunk} B in flight per one-warp "
            f"block, grid {grid}")


def k3_bwd_dq_faults(q, k, v, out, dout, tile: int = 64, **kw):
    """dQ of causal attention with the mask keywords ``kw`` (bf16 inputs,
    the plain version's float32 math) twice: whole, and with each query's
    own ``tile``-key tile left out of dS K, as a kernel that skipped the
    diagonal tile of its loop over key tiles would give (a planted
    fault)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    scale = kw.get("scale") or hd ** -0.5
    qg = q.float().reshape(b, s, kvh, h // kvh, hd)
    pos = torch.arange(s, device=q.device)
    p, dcap = k3._probs(q, k, **{**kw, "scale": scale})
    do = dout.float().reshape(qg.shape)
    ds = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    ds -= (do * out.float().reshape(qg.shape)).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds *= p
    del p
    if dcap is not None:
        ds *= dcap
    del dcap
    whole = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    ds.masked_fill_((pos[:, None] // tile) != (pos[None, :] // tile), 0.0)
    fault = whole - torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    return whole.reshape(q.shape).to(q.dtype), fault.reshape(q.shape).to(q.dtype)


def library_attention(q, k, v, *, scale, softcap, window, prefix_len):
    """(name, fn): the one PyTorch call that computes K3's causal function
    on these (B, S, H, hd) inputs, fn returning K3's layout -- the library
    yardstick, which the port never calls.  ``scaled_dot_product_attention``
    where no softcap applies (``is_causal``, or the boolean mask of the
    window and the prefix), else ``flex_attention`` compiled (at its
    first call), with the softcap as its ``score_mod`` and the mask as its
    block mask."""
    s, t = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if softcap is None:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None and not prefix_len:
            mask_kw = dict(is_causal=True)
        else:
            mask_kw = dict(attn_mask=k3.visible_mask(
                torch.arange(s, device=q.device), torch.arange(t, device=q.device),
                window=window, prefix_len=prefix_len))
        return "SDPA", lambda: sdpa(qt, kt, vt, scale=scale, enable_gqa=True,
                                    **mask_kw).transpose(1, 2)
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def mask_mod(b, h, qi, ki):        # K3's predicate (kernels.flash)
        m = ki <= qi
        if window is not None:
            m = m & (ki > qi - window)
        if prefix_len:
            m = m | ((ki < prefix_len) & (qi < prefix_len))
        return m

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    block_mask = create_block_mask(mask_mod, None, None, s, t, device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return "flex_attention", lambda: flex(qt, kt, vt, score_mod=score_mod,
                                          block_mask=block_mask, scale=scale,
                                          enable_gqa=True).transpose(1, 2)


def library_attention_bwd(q, k, v, dout, *, scale, softcap, window, prefix_len):
    """(name, fn): the backward through autograd of ``library_attention``'s
    call on these inputs -- the library yardstick of K3's backward, which
    the port never calls: fn returns the gradients of q, k and v (in the
    library's layout) for ``dout``."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    name, fwd = library_attention(*leaves, scale=scale, softcap=softcap, window=window,
                                  prefix_len=prefix_len)
    out = fwd()
    return name, lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def bwd_block_work(s: int, t: int, hd: int, group: int, window: int | None = None,
                   prefix_len: int = 0) -> dict:
    """Tile iterations per block of K3's bf16 backward kernels (causal, S x
    T, G = ``group`` query heads a KV head), counted from their loops as
    ``csrc/flash_attn_bwd.cu`` runs them: the Hopper dK/dV blocks (one
    query head) own 128 keys (64 at hd 256) and loop over the 64-query
    tiles that see them (``query_range``), the dQ blocks own 128 queries
    and loop over 64-key tiles (``key_range``); the mma.sync kernel has
    64-key and 64-query blocks, and its dK/dV block (one KV head) walks the
    G query heads.
    Returns {kernel: (longest, average)}."""
    def q_range(k0, k1):
        begin, end = k0, (min(s, k1 - 1 + window) if window else s)
        if k0 < prefix_len:
            begin, end = 0, max(end, min(prefix_len, s))
        return begin, end

    def k_range(q0, q1):
        end, begin = min(t, q1), (max(0, q0 - window + 1) if window else 0)
        if q0 < prefix_len:
            end, begin = max(end, min(prefix_len, t)), 0
        return begin, end

    def tiles(r, size):
        return max(0, -(-r[1] // size) - r[0] // size) if r[0] < r[1] else 0

    hopper = hd in k3.BWD_HOPPER_HEAD_DIMS
    kb, qb = ((64 if hd > 128 else 128), 128) if hopper else (64, 64)
    heads = 1 if hopper else group
    dkdv = [heads * tiles(q_range(k0, min(k0 + kb, t)), 64) for k0 in range(0, t, kb)]
    dq = [tiles(k_range(q0, min(q0 + qb, s)), 64) for q0 in range(0, s, qb)]
    return {"dkdv": (max(dkdv), sum(dkdv) / len(dkdv)), "dq": (max(dq), sum(dq) / len(dq))}


def bound_ratio(err: torch.Tensor, bound: torch.Tensor) -> float:
    """max over elements of |err| / bound, an element within its bound at
    or below 1: one with no error counts 0 where its bound is 0 too (a
    bound of one term, such as dV under a window of one key, is 0 where an
    input element is exactly 0, which a seeded draw can give)."""
    err = err.abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


def _cache_leaves(cache: dict) -> list:
    """The tensors of a cache tree (nested dicts)."""
    return [t for v in cache.values()
            for t in (_cache_leaves(v) if isinstance(v, dict) else [v])]


def k3_error(q, k, v, got, want, kw: dict) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / K3's error bound over the
    elements): K3 is within tolerance when the second is at most 1."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / k3.error_bound(q, k, v, want, **kw)).max())


def kernel_resources(text: str) -> list[tuple[str, int, int]]:
    """(mangled name, registers, spill store + load bytes) of each kernel
    in an ``nvcc -Xptxas -v`` log."""
    out, kern, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kern, spill = m.group(1), 0
        elif kern and "bytes spill" in line:
            spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", line))
        elif kern and "Used" in line:
            out.append((kern, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            kern = None
    return out


def sass_functions(lib: Path) -> dict[str, list[str]]:
    """``cuobjdump -sass`` of a built library: each function's SASS lines
    (instructions and their encodings, runs of blanks made one), keyed by
    its mangled name."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = m.group(1)
            out[key] = []
        elif key and line.strip():
            out[key].append(" ".join(line.split()))
    return out


def hopper_resources(text: str) -> list[tuple[str, int, int]]:
    """(kernel hd= [causal=] softcap=, registers, spill bytes) of each
    instantiation of K3's Hopper kernels (the forward's
    ``flash_fwd_wgmma_kernel``, the backward's ``dkdv_wgmma_kernel`` and
    ``dq_wgmma_kernel``) in an ``nvcc -Xptxas -v`` log."""
    out = []
    for name, regs, spill in kernel_resources(text):
        m = re.search(r"([a-z_]+_wgmma_kernel)ILi(\d+)E((?:Lb\dE)+)", name)
        if m:
            flags = re.findall(r"Lb(\d)E", m.group(3))
            keys = ("causal", "softcap")[-len(flags):]
            out.append((f"{m.group(1)} hd={m.group(2)} "
                        + " ".join(f"{k}={f}" for k, f in zip(keys, flags)), regs, spill))
    return out


def k3_kernel_names(calls, part: str = K3_FWD_NAME) -> list[tuple[str, ...] | None]:
    """The device kernels of K3 (those whose name holds ``part``) that each
    of ``calls`` ran, read by the profiler: each call synchronises and is
    preceded by a marker kernel, and the kernels between marker i and
    marker i + 1 on the device's clock are call i's (the host's clock can
    be milliseconds off the device records); their distinct names, sorted.
    None where the profiler saw none, and for every call when a marker's
    record was lost.  Each call runs once before the session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
    groups: list[set[str]] = []
    for _, name in sorted((e.time_range.start, e.name) for e in prof.events()
                          if e.device_type == DeviceType.CUDA):
        if MARKER_KERNEL in name:
            groups.append(set())
        elif part in name and groups:
            groups[-1].add(re.sub(r"[<(].*", "", name).split("::")[-1])
    if len(groups) != len(calls):
        return [None] * len(calls)
    return [tuple(sorted(g)) or None for g in groups]


def max_err(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    d = (a - b).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


class Smoke:
    """The phases, in order; ``kernels`` collects the kernels line."""

    def __init__(self):
        self.dev = torch.device("cuda")
        self.rng = np.random.default_rng(0)
        self.kernels: dict[str, dict] = {}
        self.sharded: dict[tuple, dict] = {}
        self.k3_bwd: dict[str, dict] = {}
        self.k3_bwd_kernels: dict[str, dict] = {}
        self.train: dict[str, dict] = {}
        self.ranks: dict[str, dict] = {}
        self.tp_launches: dict[str, int] = {}
        self.k3_bwd_tp: dict[str, dict] = {}
        self.k1_bytes: dict[str, float] = {}

    # ------------------------------------------------------------ phase 1
    def build_kernels(self) -> None:
        t0 = time.perf_counter()
        logs = build.build_all()
        log(f"[build] nvcc sm_90a for {', '.join(build.SOURCES)} in "
            f"{time.perf_counter() - t0:.1f} s ({build.nvcc()})")
        for name, text in logs.items():
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
            if regs:
                log(f"[build] {name}: {len(regs)} kernels, registers "
                    f"{min(regs)}-{max(regs)} per thread, {spills} bytes spilled")
            for line in text.splitlines():   # ptxas warnings, wgmma serialisation
                if re.search(r"warning|Performance Loss", line, re.I):
                    log(f"[build] {name}: {line.strip()}")
        for kern, regs, spill in hopper_resources(logs.get("flash_attn", "")
                                                  + logs.get("flash_attn_bwd", "")):
            log(f"[build] K3 Hopper kernel {kern}: {regs} registers per thread at "
                f"launch (consumers raise theirs to 240 with setmaxnreg), "
                f"{spill} bytes spilled")
        for name, text in logs.items():
            for kern, regs, spill in kernel_resources(text):
                if spill:
                    log(f"[build] {name}: {kern} spills {spill} bytes ({regs} registers)")
        # K3's backward Hopper kernels run their products on wgmma: each
        # instantiation's SASS must hold HGMMA instructions
        hgmma = {}
        for fn, lines in sass_functions(build.library_path("flash_attn_bwd")).items():
            m = re.search(r"([a-z_]+_wgmma_kernel)ILi(\d+)ELb(\d)E", fn)
            if m:
                hgmma[f"{m.group(1)} hd={m.group(2)} softcap={m.group(3)}"] = sum(
                    "HGMMA" in line for line in lines)
        log(f"[build] HGMMA instructions in K3's backward Hopper kernels: {json.dumps(hgmma)}")
        if len(hgmma) != 4 * len(k3.BWD_HOPPER_HEAD_DIMS) or not all(hgmma.values()):
            raise AssertionError(f"K3's backward Hopper kernels without wgmma: {hgmma}")
        k1._lib()
        k2._lib()
        k3._lib()
        k3._bwd_lib()
        # which K3 kernel each (dtype, hd) takes, read by the profiler in its
        # first session of the process (a second session where it lost a
        # record); each must be K3_KERNEL_OF's
        gen = torch.Generator(device=self.dev).manual_seed(0)
        combos = list(K3_KERNEL_OF)
        inputs = [self._qkv(gen, getattr(torch, dtype), 1, 200, 4, 2, hd)
                  for dtype, hd in combos]
        for _ in range(2):
            names = k3_kernel_names([lambda x=x: k3.flash_attention(*x) for x in inputs])
            if None not in names:
                break
        log("[K3 kernels] " + "; ".join(
            f"{dtype} hd={hd}: {', '.join(name or ['not seen by the profiler'])}"
            for (dtype, hd), name in zip(combos, names)))
        wrong = [f"{dtype} hd={hd}: {name}" for (dtype, hd), name in zip(combos, names)
                 if name != (K3_KERNEL_OF[dtype, hd],)]
        if wrong:
            raise AssertionError(f"K3 launched another kernel than csrc/flash_attn.cu's "
                                 f"dispatch names (or the profiler missed it): {wrong}")
        # the same for K3's backward (G = 2), the kernels line's head_dims
        combos = list(K3_BWD_KERNELS_OF)
        calls = []
        for dtype, hd in combos:
            q, k, v = self._qkv(gen, getattr(torch, dtype), 1, 200, 4, 2, hd)
            out, lse = k3.flash_attention(q, k, v, return_lse=True)
            calls.append(lambda x=(q, k, v, out, torch.randn_like(out), lse):
                         k3.flash_attention_bwd(*x))
        for _ in range(3):
            names = k3_kernel_names(calls, K3_BWD_NAME)
            if None not in names:
                break
        for (dtype, hd), name in zip(combos, names):
            self.k3_bwd_kernels.setdefault(str(hd), {})[dtype] = ", ".join(
                name or ["not seen by the profiler"])
        log(f"[K3 bwd kernels] G=2: {json.dumps(self.k3_bwd_kernels)}")
        wrong = [f"{dtype} hd={hd}: {name}" for (dtype, hd), name in zip(combos, names)
                 if name != k3_bwd_kernels(dtype, hd, 2)]
        if wrong:
            raise AssertionError(f"K3's backward launched other kernels than "
                                 f"csrc/flash_attn_bwd.cu's dispatch names (or the profiler "
                                 f"missed them): {wrong}")
        del calls

    # ---------------------------------------------------- phase 2 and 3
    def _small_state(self, geometry, lat, dtype):
        """Packed state with random populations of order 0.1 at every slot
        (solid ones included: bounce-back must read the right one)."""
        tiling = tile_geometry(geometry, 4)
        t, n = tiling.num_tiles, tiling.nodes_per_tile
        types = np.full((t + 1, n), SOLID, np.uint8)
        types[:t] = tiling.node_types
        f = np.zeros((t + 1, lat.q, n))
        f[:t] = self.rng.uniform(0.02, 0.1, size=(t, lat.q, n))
        return tiling, (torch.as_tensor(f, dtype=dtype, device=self.dev),
                        torch.as_tensor(types, device=self.dev))

    def _cases(self):
        for dtype in (torch.float64, torch.float32):
            for model in (C.LBGK, C.LBMRT):
                for fluid in (C.INCOMPRESSIBLE, C.QUASI_COMPRESSIBLE):
                    for force in (None, (1e-4, -2e-4, 3e-4)):
                        yield dtype, "D3Q19", C.CollisionConfig(model, fluid, 0.7), force
            for fluid in (C.INCOMPRESSIBLE, C.QUASI_COMPRESSIBLE):
                yield dtype, "D2Q9", C.CollisionConfig(C.LBGK, fluid, 0.7), (1e-4, 0.0, 0.0)

    def check_k1_small(self) -> None:
        walled = geo.duct_wrap(geo.random_spheres(box=32, porosity=0.6,
                                                  diameter=8, seed=1))
        periodic = geo.random_spheres(box=32, porosity=0.6, diameter=8, seed=2)
        flat = geo.channel2d(32, 32)
        geoms = {"D3Q19": [("walled", walled, (False,) * 3),
                           ("periodic", periodic, (True,) * 3)],
                 "D2Q9": [("channel2d", flat, (True, False, False))]}
        worst, count = {}, 0
        for dtype, lname, cfg, force in self._cases():
            lat = get_lattice(lname)
            for gname, g, per in geoms[lname]:
                tiling, (f, types) = self._small_state(g, lat, dtype)
                nbrs = torch.as_tensor(k1.build_neighbor_table(tiling, per),
                                       device=self.dev)
                fluid = (types != SOLID)[:, None, :].expand_as(f)
                modes = k1.MODES if cfg.model == C.LBGK and force is None \
                    else ("full",)
                for mode in modes:
                    args = (f, types, nbrs, lat, cfg, 4, force, mode)
                    got = k1.stream_collide_tiles(*args)
                    torch.cuda.synchronize()
                    want = k1.stream_collide_tiles_ref(*args)
                    err = max_err(got, want, fluid if mode == "full" else None)
                    tag = f"{mode}/{dtype}"
                    worst[tag] = max(worst.get(tag, 0.0), err)
                    count += 1
                    if not err <= TOL[dtype] or got[-1].any():
                        raise AssertionError(
                            f"K1 {lname} {gname} {mode} {cfg} force={force} "
                            f"{dtype}: max |err| {err:.3e} > {TOL[dtype]:.0e}")
        log(f"[K1 vs plain] {count} cases within tolerance; worst |err| by "
            f"mode/dtype: {json.dumps(worst)}")

    def check_k2_small(self) -> None:
        g = geo.duct_wrap(geo.random_spheres(box=32, porosity=0.6, diameter=8,
                                             seed=1))
        worst, count = {}, 0
        for dtype, lname, cfg, force in self._cases():
            lat = get_lattice(lname)
            tiling, (f, types) = self._small_state(
                g if lname == "D3Q19" else geo.channel2d(32, 32), lat, dtype)
            fq = f[:-1].movedim(0, 1).contiguous()               # (Q, T, n)
            solid = types[:-1] == SOLID
            got = k2.collide_tiles(fq, solid, lat, cfg, force)
            torch.cuda.synchronize()
            want = k2.collide_tiles_ref(fq, solid, lat, cfg, force)
            err = max_err(got, want, ~solid[None].expand_as(fq))
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
            count += 1
            if not err <= TOL[dtype] or got[:, solid].any():
                raise AssertionError(f"K2 {lname} {cfg} force={force} {dtype}: "
                                     f"max |err| {err:.3e}")
        log(f"[K2 vs plain] {count} cases within tolerance; worst |err|: "
            f"{json.dumps(worst)}")

    # ------------------------------------------------------------ phase 4
    def _engine(self, case, dtype: str, **kw):
        cfg = LBMConfig(
            collision=C.CollisionConfig(tau=0.6), dtype=dtype,
            boundaries=case.boundaries, periodic=case.periodic, **kw)
        return SparseTiledLBM(case.geometry, cfg, device=self.dev)

    def _main_run(self, eng, steps: int) -> tuple[float, dict]:
        """The counted run: counters zeroed just before, read just after."""
        launcher.reset_launch_counts()
        seconds = launcher.timed_run(eng, steps)
        return seconds, launcher.launch_counts()

    def profile_steps(self, eng, sec_per_step: float, steps: int = 10) -> None:
        """Where a fused step's time goes: ``torch.profiler`` over ``steps``
        steps (after 2 warm-up steps in the same session) — device ops per
        step, device busy time (union of kernel and memory-op intervals),
        K1's part of it (every launch traced), and the host's top-level
        torch ops per step.  The idle share is against the unprofiled step
        time ``sec_per_step``."""
        dev, host_ops, k1_us, _ = traced(lambda: eng.run(steps), lambda: eng.run(2),
                                      f"{steps} {eng.cfg.dtype} steps")
        if not dev:
            log(f"[profile {eng.cfg.dtype}] the profiler saw no device time: "
                "device busy share not measured")
            return
        step_ms = sec_per_step * 1e3
        busy_ms = busy_us(dev) / 1e3 / steps
        log(f"[profile {eng.cfg.dtype}] per step: {len(dev) / steps:.1f} device "
            f"ops, device busy {busy_ms:.4f} ms of {step_ms:.4f} ms (idle share "
            f"{1 - busy_ms / step_ms:.3f}), K1 {sum(k1_us) / 1e3 / steps:.4f} "
            f"ms per launch ({steps} of {steps} launches traced), "
            f"{len(host_ops) / steps:.1f} top-level host torch ops")

    def run_fused(self, case, dtype: str) -> None:
        t0 = time.perf_counter()
        eng = self._engine(case, dtype, backend="fused")
        setup = time.perf_counter() - t0
        eng.run(WARM)
        eng.reset()
        seconds, launches = self._main_run(eng, STEPS)
        if launches["stream_collide_tiles"] != STEPS or launches["nebb_boundary_pass"] != STEPS:
            raise AssertionError(f"K1 and the NEBB pass launched {launches} times in "
                                 f"{STEPS} steps")
        f = eng.f
        if not bool(torch.isfinite(f).all()):
            raise AssertionError("non-finite state after the fused run")
        fmax = float(f.abs().max())
        sec = seconds / STEPS
        nf, q, itemsize = eng.n_fluid_nodes, eng.lat.q, eng.dtype.itemsize
        gbs = 2 * q * nf * itemsize / sec / 1e9
        log(f"[main fused {dtype}] spheres scale 4: {eng.tiling.num_tiles} tiles "
            f"({len(np.unique(eng.backend._bc.tiles.cpu().numpy()))} with boundary nodes), "
            f"{nf} fluid nodes, eta_t {eng.tiling.tile_utilisation:.3f}, set-up "
            f"{setup:.1f} s; {STEPS} steps in {seconds:.4f} s = {sec * 1e3:.4f} "
            f"ms/step, {eng.mflups(sec):.1f} MFLUPS, Eqn-10 {gbs:.1f} GB/s = "
            f"{gbs * 1e9 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s; launches "
            f"{json.dumps(launches)}; mass {eng.total_mass():.6f}, max |f| {fmax:.4f}")
        self.profile_steps(eng, sec)
        self.sharded[(dtype, 1)] = {"ms_per_step": sec * 1e3, "mflups": eng.mflups(sec),
                                    "eqn10_share": gbs * 1e9 / HBM_BYTES_PER_S}

        # K1 at the main path's shapes, on the run's own state
        b = eng.backend
        out = b.other(f)
        args = (f, b._types, b._nbrs, eng.lat, eng.cfg.collision, 4, None, "full")
        got = k1.stream_collide_tiles(*args, out=out).clone()
        torch.cuda.synchronize()
        want = k1.stream_collide_tiles_ref(*args)
        fluid = (b._types != SOLID)[:, None, :].expand_as(f)
        err = max_err(got, want, fluid)
        del want
        if not err <= TOL[eng.dtype]:
            raise AssertionError(f"K1 vs plain at full size: {err:.3e}")
        # the NEBB pass on K1's output: the kernel into ``out``, the plain
        # version into K1's copy
        self.nebb_full(eng, f, out, got, launches["nebb_boundary_pass"], dtype)
        del got
        ms = time_ms(lambda: k1.stream_collide_tiles(*args, out=out), 50,
                     label=f"K1 {dtype}")
        plain_ms = time_ms(lambda: k1.stream_collide_tiles_ref(*args), 3, 1,
                           label=f"K1 plain {dtype}")
        t, n = eng.tiling.num_tiles, eng.tiling.nodes_per_tile
        flops, nbytes = k1.stream_collide_cost(t, eng.lat, eng.cfg.collision, itemsize, n)
        bms, by = bound_ms(nbytes, flops, eng.dtype)
        self.k1_bytes[dtype] = nbytes
        name = "stream_collide_tiles" + ("" if dtype == "float64" else f"[{dtype}]")
        self.kernels[name] = {
            "name": name, "route": "cuda", "source": f"{SOURCE}/stream_collide.cu",
            "replaces": "src/repro/kernels/stream_collide.py:206",
            "launches": launches["stream_collide_tiles"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}
        log(f"[K1 {dtype} full size] |err| {err:.3e}, {ms:.4f} ms/launch "
            f"(bound {bms:.4f} ms by {by}, {bms / ms:.3f} of it), plain "
            f"{plain_ms:.2f} ms")

    def nebb_full(self, eng, f, k1_out, k1_copy, launches: int, dtype: str) -> None:
        """The NEBB pass at the main path's shapes, on K1's output of the
        run's own state (in ``k1_out`` and a copy of it): the kernel against
        its plain version, each timed, beside its bound by bytes."""
        b = eng.backend
        args = (eng.lat, eng.cfg.collision, eng.cfg.force, b._specs, b._bc)
        got = nebb.nebb_boundary_pass(f, k1_out, *args)
        torch.cuda.synchronize()
        want = nebb.nebb_boundary_pass_ref(f, k1_copy, *args)
        err = max_err(got, want)
        if not err <= TOL[eng.dtype]:
            raise AssertionError(f"NEBB kernel vs plain at full size: {err:.3e}")
        ms = time_ms(lambda: nebb.nebb_boundary_pass(f, k1_out, *args), 50,
                     label=f"NEBB {dtype}")
        plain_ms = time_ms(lambda: nebb.nebb_boundary_pass_ref(f, k1_copy, *args), 5,
                           label=f"NEBB plain {dtype}")
        nodes = int(b._bc.src.shape[1])
        flops, nbytes = nebb.nebb_pass_cost(nodes, eng.lat, eng.cfg.collision,
                                            f.element_size())
        bms, by = bound_ms(nbytes, flops, eng.dtype)
        name = "nebb_boundary_pass" + ("" if dtype == "float64" else f"[{dtype}]")
        self.kernels[name] = {
            "name": name, "route": "cuda", "source": f"{SOURCE}/nebb_pass.cu",
            "replaces": None, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "nodes": nodes}
        log(f"[NEBB {dtype} full size] {nodes} boundary nodes: |err| {err:.3e}, "
            f"{ms:.4f} ms/launch (bound {bms:.4f} ms by {by}, {bms / ms:.3f} of it), "
            f"plain {plain_ms:.2f} ms")

    def run_rw_only(self, case, dtype: str) -> None:
        eng = self._engine(case, dtype, backend="fused", kernel_mode="rw_only")
        eng.run(WARM)
        eng.reset()
        seconds, launches = self._main_run(eng, STEPS)
        if launches["stream_collide_tiles"] != STEPS:
            raise AssertionError(f"K1 rw_only launched {launches}")
        b, f = eng.backend, eng.f
        out = b.other(f)
        args = (f, b._types, b._nbrs, eng.lat, eng.cfg.collision, 4, None, "rw_only")
        got = k1.stream_collide_tiles(*args, out=out).clone()
        torch.cuda.synchronize()
        want = k1.stream_collide_tiles_ref(*args)
        bits = torch.int64 if eng.dtype == torch.float64 else torch.int32
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError(f"K1 rw_only {dtype} differs from its plain "
                                 f"version: max |err| {max_err(got, want)}")
        err = max_err(got, want)
        del got, want
        t = eng.tiling.num_tiles
        med = interleaved_ms({"kernel": lambda: k1.stream_collide_tiles(*args, out=out),
                              "copy_": lambda: out[:t].copy_(f[:t])})
        ms, lib_ms = med["kernel"], med["copy_"]
        plain_ms = time_ms(lambda: k1.stream_collide_tiles_ref(*args), 5,
                           label=f"K1 rw_only plain {dtype}")
        flops, nbytes = k1.stream_collide_cost(t, eng.lat, eng.cfg.collision,
                                               f.element_size(), f.shape[2], "rw_only")
        bms, by = bound_ms(nbytes, flops, eng.dtype)
        sec = seconds / STEPS
        log(f"[main fused rw_only {dtype}] {STEPS} steps in {seconds:.4f} s, "
            f"{nbytes / sec / 1e9:.1f} GB/s moved; design "
            f"{rw_only_design(f, out, nbytes // 2)}; "
            f"kernel {ms:.4f} ms/launch, copy_ {lib_ms:.4f} ms (medians of "
            f"{ROUNDS} rounds x {REPS} launches in turns), kernel/copy_ "
            f"{ms / lib_ms:.4f}; bound {bms:.4f} ms by {by}: kernel {bms / ms:.4f} "
            f"of it, copy_ {bms / lib_ms:.4f}")
        name = "stream_collide_tiles[rw_only]" + ("" if dtype == "float64"
                                                  else f"[{dtype}]")
        self.kernels[name] = {
            "name": name, "route": "cuda",
            "source": f"{SOURCE}/stream_collide.cu",
            "replaces": "src/repro/kernels/stream_collide.py:231",
            "launches": launches["stream_collide_tiles"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}

    def fused_vs_gather(self, case) -> None:
        t0 = time.perf_counter()
        eng_g = self._engine(case, "float64", backend="gather",
                             layout_scheme="paper", use_kernel=True)
        setup = time.perf_counter() - t0
        eng_f = self._engine(case, "float64", backend="fused")
        _, launches_f = self._main_run(eng_f, PARITY_STEPS)
        _, launches_g = self._main_run(eng_g, PARITY_STEPS)
        if launches_f["stream_collide_tiles"] != PARITY_STEPS \
                or launches_g["collide_tiles"] != PARITY_STEPS:
            raise AssertionError(f"launches fused {launches_f} gather {launches_g}")
        fluid = ~eng_f._solid[None]
        cf = eng_f.backend.canonical(eng_f.f)
        cg = eng_g.backend.canonical(eng_g.f)
        err = max_err(cf, cg, fluid.expand_as(cf))
        if not err <= TOL[torch.float64] or not bool(torch.isfinite(cf).all()):
            raise AssertionError(f"fused vs gather+K2: {err:.3e}")
        log(f"[fused vs gather+K2 float64] {PARITY_STEPS} steps at full size: "
            f"max |err| {err:.3e} at fluid slots (<= 1e-12); gather set-up "
            f"{setup:.1f} s; launches fused {json.dumps(launches_f)}, gather "
            f"{json.dumps(launches_g)}")
        del eng_f, cf

        # K2 at the gather path's shapes: a post-streaming (Q, T, n) state
        lat, cfg = eng_g.lat, eng_g.cfg.collision
        f_in = torch.take(eng_g.f, eng_g.backend._gather).reshape(eng_g.f.shape)
        solid = eng_g._solid
        got = k2.collide_tiles(f_in, solid, lat, cfg)
        torch.cuda.synchronize()
        want = k2.collide_tiles_ref(f_in, solid, lat, cfg)
        err2 = max_err(got, want, ~solid[None].expand_as(got))
        del got, want
        if not err2 <= TOL[torch.float64]:
            raise AssertionError(f"K2 vs plain at full size: {err2:.3e}")
        ms = time_ms(lambda: k2.collide_tiles(f_in, solid, lat, cfg), 50,
                     label="K2 float64")
        plain_ms = time_ms(lambda: k2.collide_tiles_ref(f_in, solid, lat, cfg),
                           3, 1, label="K2 plain float64")
        q, t, n = f_in.shape
        flops, nbytes = k2.collide_cost(t * n, lat, cfg, f_in.element_size())
        bms, by = bound_ms(nbytes, flops, f_in.dtype)
        self.kernels["collide_tiles"] = {
            "name": "collide_tiles", "route": "cuda", "source": f"{SOURCE}/collide.cu",
            "replaces": "src/repro/kernels/collide.py:127",
            "launches": launches_g["collide_tiles"], "max_abs_err": err2,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}
        log(f"[K2 float64 full size] |err| {err2:.3e}, {ms:.4f} ms/launch (bound "
            f"{bms:.4f} ms by {by}, {bms / ms:.3f} of it), plain {plain_ms:.2f} ms")

    def main_path(self) -> None:
        t0 = time.perf_counter()
        case = launcher.make_case("spheres", 4)
        log(f"[main] spheres scale 4 geometry {case.geometry.shape} in "
            f"{time.perf_counter() - t0:.1f} s")
        for dtype in ("float64", "float32"):
            self.run_fused(case, dtype)
            torch.cuda.empty_cache()
        for dtype in ("float64", "float32"):
            self.run_rw_only(case, dtype)
            torch.cuda.empty_cache()
        self.fused_vs_gather(case)
        log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ----------------------------------------------------------- phase 4b
    def _owned_parity(self, eng, single) -> tuple[float, bool]:
        """(max |sharded - single| over the owned tiles' fluid slots, whether
        every owned tile is bit for bit equal), on the canonical states."""
        want = single.backend.canonical(single.f)
        bits = torch.int64 if eng.dtype == torch.float64 else torch.int32
        err, bitwise = 0.0, True
        for d, dev, b, f in zip(eng.slab_ids, eng.devices, eng.backends, eng.f):
            rows, g_rows = (torch.as_tensor(x, device=dev)
                            for x in eng.plan.owned_rows(d, single.tiling))
            got = b.canonical(f)[:, rows]
            ref = want[:, g_rows]
            bitwise &= torch.equal(got.contiguous().view(bits), ref.contiguous().view(bits))
            err = max(err, max_err(got, ref, (~single._solid[g_rows])[None].expand_as(got)))
        return err, bitwise

    def sharded_fused(self, case, dtype: str, slabs: int, single) -> None:
        """The sharded fused engine at full size against the single fused
        engine ``single`` (at step ``SHARD_PARITY_STEPS`` from t = 0), then
        timed from t = 0."""
        tag = f"[sharded fused {dtype} D={slabs}]"
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = ShardedLBM(case.geometry, single.cfg, slabs=slabs, devices=self.dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        _, launches = self._main_run(eng, SHARD_PARITY_STEPS)
        if launches["stream_collide_tiles"] != slabs * SHARD_PARITY_STEPS:
            raise AssertionError(f"{tag} K1 launched {launches} times in "
                                 f"{SHARD_PARITY_STEPS} steps of {slabs} slabs")
        err, bitwise = self._owned_parity(eng, single)
        if not err <= TOL[eng.dtype] or not all(
                bool(torch.isfinite(f).all()) for f in eng.f):
            raise AssertionError(f"{tag} owned tiles vs the single engine after "
                                 f"{SHARD_PARITY_STEPS} steps: max |err| {err:.3e}")

        # K1 per slab at the slab's shapes, on the run's own state
        k_err, plain_ms, rows = 0.0, 0.0, []
        for b, f in zip(eng.backends, eng.f):
            args = (f, b._types, b._nbrs, eng.lat, eng.cfg.collision, 4, None, "full")
            got = k1.stream_collide_tiles(*args, out=b.other(f)).clone()
            torch.cuda.synchronize()
            want = k1.stream_collide_tiles_ref(*args)
            fluid = (b._types != SOLID)[:, None, :].expand_as(f)
            k_err = max(k_err, max_err(got, want, fluid))
            del got, want, fluid
            plain_ms += time_ms(lambda: k1.stream_collide_tiles_ref(*args), 3, 1)
            rows.append(args)
        if not k_err <= TOL[eng.dtype]:
            raise AssertionError(f"{tag} K1 per slab vs plain: {k_err:.3e}")

        def k1_step():
            for b, args in zip(eng.backends, rows):
                k1.stream_collide_tiles(*args, out=b.other(args[0]))

        k1_ms = time_ms(k1_step, 50)
        t = sum(b.tiling.num_tiles for b in eng.backends)
        costs = [k1.stream_collide_cost(b.tiling.num_tiles, eng.lat, eng.cfg.collision,
                                        eng.dtype.itemsize) for b in eng.backends]
        bms, by = bound_ms(sum(c[1] for c in costs), sum(c[0] for c in costs), eng.dtype)
        del rows

        # the timed run from t = 0 (the case diverges near step 170); the peak
        # memory is the engine's run, not the plain versions' checks above
        eng.run(WARM)
        eng.reset()
        torch.cuda.reset_peak_memory_stats()
        seconds, launches = self._main_run(eng, STEPS)
        if launches["stream_collide_tiles"] != slabs * STEPS:
            raise AssertionError(f"{tag} K1 launched {launches} times in {STEPS} "
                                 f"steps of {slabs} slabs")
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        sec = seconds / STEPS
        nf = eng.n_fluid_nodes
        share = 2 * eng.lat.q * nf * eng.dtype.itemsize / sec / HBM_BYTES_PER_S
        ex_ms = time_ms(eng.exchange, 50)
        obs.set_device_annotations(True)
        try:
            dev, _, k1_us, scope_us = traced(
                lambda: eng.run(10), lambda: eng.run(2),
                f"10 sharded {dtype} steps of {slabs} slabs",
                scopes=("lbm.phase.halo",))
        finally:
            obs.set_device_annotations(False)
        if dev:
            halo_ms = scope_us["lbm.phase.halo"] / 1e3 / 10
            busy_ms = busy_us(dev) / 1e3 / 10
            prof = (f"profiled: halo exchange {halo_ms:.4f} ms device time per "
                    f"step, K1 {sum(k1_us) / 1e3 / 10:.4f} ms per step "
                    f"({len(k1_us)} of {10 * slabs} launches traced), device "
                    f"busy {busy_ms:.4f} ms of {sec * 1e3:.4f} (idle share "
                    f"{1 - busy_ms / (sec * 1e3):.3f})")
        else:
            halo_ms = float("nan")
            prof = "profiler saw no device time: exchange device time not measured"
        self.sharded[(dtype, slabs)] = {
            "ms_per_step": sec * 1e3, "mflups": eng.mflups(sec), "eqn10_share": share,
            "exchange_ms": ex_ms, "halo_ms": halo_ms}
        if dtype == "float64" or slabs == max(SHARD_SLABS):
            name = f"stream_collide_tiles[{'' if dtype == 'float64' else dtype + ' '}" \
                f"sharded D={slabs}]"
            self.kernels[name] = {
                "name": name, "route": "cuda", "source": f"{SOURCE}/stream_collide.cu",
                "replaces": "src/repro/kernels/stream_collide.py:206",
                "launches": launches["stream_collide_tiles"], "max_abs_err": k_err,
                "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": None, "per": f"step: {slabs} launches, one per slab"}
        log(f"{tag} spheres scale 4: slabs of {[b.tiling.num_tiles for b in eng.backends]} "
            f"tiles ({t} with halos, {t / single.tiling.num_tiles:.4f} of the single "
            f"engine's), {sum(b._bc is not None for b in eng.backends)} slabs with "
            f"boundary nodes; set-up {setup:.1f} s; owned tiles vs the single engine "
            f"after {SHARD_PARITY_STEPS} steps: max |err| {err:.3e}, "
            f"{'bit for bit' if bitwise else 'NOT bit for bit'}; K1 per slab vs plain "
            f"|err| {k_err:.3e}; {STEPS} steps in {seconds:.4f} s = {sec * 1e3:.4f} "
            f"ms/step, {eng.mflups(sec):.1f} MFLUPS, Eqn-10 share {share:.3f}; K1 "
            f"launches {launches['stream_collide_tiles']} = {slabs} x {STEPS}; K1 of "
            f"one step (all slabs) {k1_ms:.4f} ms (bound {bms:.4f} ms by {by}, "
            f"{bms / k1_ms:.3f} of it), plain {plain_ms:.2f} ms; {prof}; peak "
            f"device memory of the timed run {peak:.2f} GiB above the "
            f"{resident / 2**30:.2f} GiB resident before the engine was built")
        log(f"{tag} halo: {eng.halo_bytes_per_step()} B per step by the reference's "
            f"count (padded to the widest layer), {eng.halo_bytes_moved_per_step()} "
            f"B moved by the port's exchange in {len(eng.hops)} hops; the exchange "
            f"alone {ex_ms:.4f} ms (CUDA events, median of 50)")

    def sharded_gather(self) -> None:
        """Gather + K2 sharded against the single gather + K2 engine at
        spheres scale 1, D = 4, float64."""
        slabs = max(SHARD_SLABS)
        case = launcher.make_case("spheres", 1)
        single = self._engine(case, "float64", layout_scheme="paper", use_kernel=True)
        eng = ShardedLBM(case.geometry, single.cfg, slabs=slabs, devices=self.dev)
        single.run(SHARD_PARITY_STEPS)
        _, launches = self._main_run(eng, SHARD_PARITY_STEPS)
        if launches["collide_tiles"] != slabs * SHARD_PARITY_STEPS:
            raise AssertionError(f"sharded gather: K2 launched {launches}")
        err, bitwise = self._owned_parity(eng, single)
        if not err <= TOL[torch.float64]:
            raise AssertionError(f"sharded gather + K2 vs single: {err:.3e}")
        # K2 per slab at the slab's post-streaming shapes
        lat, cfg = eng.lat, eng.cfg.collision
        k_err, plain_ms, ins = 0.0, 0.0, []
        for b, f in zip(eng.backends, eng.f):
            f_in = b._stream(f)
            got = k2.collide_tiles(f_in, b._solid, lat, cfg)
            torch.cuda.synchronize()
            want = k2.collide_tiles_ref(f_in, b._solid, lat, cfg)
            k_err = max(k_err, max_err(got, want, ~b._solid[None].expand_as(got)))
            plain_ms += time_ms(lambda: k2.collide_tiles_ref(f_in, b._solid, lat, cfg), 3, 1)
            ins.append((f_in, b._solid))
        if not k_err <= TOL[torch.float64]:
            raise AssertionError(f"K2 per slab vs plain: {k_err:.3e}")
        ms = time_ms(lambda: [k2.collide_tiles(x, s, lat, cfg) for x, s in ins], 50)
        costs = [k2.collide_cost(x.shape[1] * x.shape[2], lat, cfg, x.element_size())
                 for x, _ in ins]
        bms, by = bound_ms(sum(c[1] for c in costs), sum(c[0] for c in costs), torch.float64)
        name = f"collide_tiles[sharded D={slabs}]"
        self.kernels[name] = {
            "name": name, "route": "cuda", "source": f"{SOURCE}/collide.cu",
            "replaces": "src/repro/kernels/collide.py:127",
            "launches": launches["collide_tiles"], "max_abs_err": k_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "per": f"step: {slabs} launches, one per slab"}
        log(f"[sharded gather+K2 float64 D={slabs}] spheres scale 1: owned tiles vs "
            f"the single gather + K2 engine after {SHARD_PARITY_STEPS} steps max "
            f"|err| {err:.3e} ({'bit for bit' if bitwise else 'NOT bit for bit'}); "
            f"K2 launches {launches['collide_tiles']} = {slabs} x "
            f"{SHARD_PARITY_STEPS}; K2 per slab vs plain |err| {k_err:.3e}; K2 of one "
            f"step (all slabs) {ms:.4f} ms (bound {bms:.4f} ms by {by}), plain "
            f"{plain_ms:.2f} ms")

    def sharded_main(self) -> None:
        case = launcher.make_case("spheres", 4)
        for dtype in ("float64", "float32"):
            single = self._engine(case, dtype, backend="fused")
            single.run(SHARD_PARITY_STEPS)
            for slabs in SHARD_SLABS:
                self.sharded_fused(case, dtype, slabs, single)
                torch.cuda.empty_cache()
            del single
            torch.cuda.empty_cache()
        self.sharded_gather()
        torch.cuda.empty_cache()
        log("[sharded summary] spheres scale 4 fused, ms/step | MFLUPS | Eqn-10 share "
            "| exchange ms (alone, CUDA events) | halo ms (profiled); D = 1 is phase 4's "
            "single engine: " + "; ".join(
                f"{dtype} D={d}: " + " | ".join(
                    f"{r[k]:.4f}" if k in r else "-"
                    for k in ("ms_per_step", "mflups", "eqn10_share", "exchange_ms",
                              "halo_ms"))
                for (dtype, d), r in sorted(self.sharded.items())))

    # ------------------------------------------------------------ phase 5
    def check_k1_bt_grid(self) -> None:
        """(a) K1 over B*T tiles with the ensembles' replicated tables."""
        walled = geo.duct_wrap(geo.random_spheres(box=32, porosity=0.6,
                                                  diameter=8, seed=1))
        periodic = geo.random_spheres(box=32, porosity=0.6, diameter=8, seed=2)
        worst, count = {}, 0
        for dtype in ("float64", "float32"):
            for model in (C.LBGK, C.LBMRT):
                for gname, g, per in (("walled", walled, (False,) * 3),
                                      ("periodic", periodic, (True,) * 3)):
                    cfg = LBMConfig(collision=C.CollisionConfig(model, tau=0.7),
                                    dtype=dtype, periodic=per, backend="fused")
                    eng = SparseTiledLBM(g, cfg, device=self.dev)
                    b = eng.backend
                    types, nbrs, _ = b._ensemble_tables(ENS_BATCH)
                    t, q, n = eng.tiling.num_tiles, eng.lat.q, 64
                    singles = [self._small_state(g, eng.lat, eng.dtype)[1][0]
                               for _ in range(ENS_BATCH)]
                    f = torch.cat([x[:t] for x in singles] + [singles[0][t:]])
                    args = (types, nbrs, eng.lat, cfg.collision, 4, None, "full")
                    got = k1.stream_collide_tiles(f, *args)
                    torch.cuda.synchronize()
                    want = k1.stream_collide_tiles_ref(f, *args)
                    fluid = (types != SOLID)[:, None, :].expand_as(f)
                    err = max_err(got, want, fluid)
                    bits = torch.int64 if eng.dtype == torch.float64 else torch.int32
                    for i, x in enumerate(singles):
                        one = k1.stream_collide_tiles(x, b._types, b._nbrs, *args[2:])
                        if not torch.equal(got[i * t:(i + 1) * t].view(bits),
                                           one[:t].view(bits)):
                            raise AssertionError(
                                f"K1 over {ENS_BATCH}*T tiles, replica {i}, {gname} "
                                f"{model} {dtype}: not bit for bit a single launch")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    count += 1
                    if not err <= TOL[eng.dtype] or got[-1].any():
                        raise AssertionError(f"K1 over {ENS_BATCH}*T tiles {gname} "
                                             f"{model} {dtype}: |err| {err:.3e}")
        log(f"[K1 B*T grid] B = {ENS_BATCH}: {count} cases within tolerance of the "
            f"plain version (worst {json.dumps(worst)}) and bit for bit equal to "
            f"{ENS_BATCH} single-replica launches")

    def sim_service(self, case, dtype: str) -> None:
        """(b) The service at full size."""
        args = argparse.Namespace(collision="lbgk", tau=0.6, dtype=dtype,
                                  backend="fused", split_stream=False)
        cfg = sim_serve.case_config(case, args)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc = SimService(slots=SIM_SLOTS, device=self.dev)
        for i in range(SIM_SESSIONS):
            svc.submit(case.geometry, cfg, steps=SIM_STEPS + i * SIM_STAGGER)
        start_steps = sim_serve.warm_and_snapshot(svc)   # builds the group
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        (group,) = svc.groups.values()
        ens, eng = group.ensemble, group.entry.engine
        rec = obs.SpanRecorder()                # host spans only: no sync
        k1.stream_collide_tiles.launches = 0
        nebb.nebb_boundary_pass.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with obs.use(trace=rec):
            start.record()
            finished = svc.run()
            stop.record()
            stop.synchronize()
        launches = k1.stream_collide_tiles.launches
        nebb_launches = nebb.nebb_boundary_pass.launches
        wall = start.elapsed_time(stop) / 1e3
        group_steps = len(rec.find("sim.group.step"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != group_steps or nebb_launches != group_steps \
                or len(finished) != SIM_SESSIONS:
            raise AssertionError(f"K1 launched {launches} times and the NEBB kernel "
                                 f"{nebb_launches} in {group_steps} group steps; "
                                 f"{len(finished)} sessions finished")
        drifts = [s.result["mass_drift"] for s in sorted(finished, key=lambda s: s.sid)]
        if not all(np.isfinite(drifts)):
            raise AssertionError(f"non-finite mass drift: {drifts}")
        out = sim_serve.report(svc, finished, wall, SIM_SLOTS, start_steps)
        step_ms = wall / group_steps * 1e3
        log(f"[sim service {dtype}] spheres scale 4, {SIM_SLOTS} slots, "
            f"{SIM_SESSIONS} sessions of {SIM_STEPS}..."
            f"{SIM_STEPS + (SIM_SESSIONS - 1) * SIM_STAGGER} steps: set-up and warm "
            f"step {setup:.1f} s; run {wall:.4f} s (CUDA events) over {group_steps} "
            f"group steps = {step_ms:.4f} ms per service step, "
            f"{out['aggregate_mflups']} aggregate MFLUPS; K1 launches {launches}; "
            f"peak device memory {peak:.2f} GiB; mass drift per session "
            f"{json.dumps([float(f'{d:.3e}') for d in drifts])}")

        # K1 over the service's B*T tiles, on its state after the run: each
        # replica's rows bit for bit a single launch over that replica's
        # state with the engine's (T, 27) tables, held against the plain
        # version on the same input
        b = eng.backend
        types, nbrs, bc = b._ensemble_tables(SIM_SLOTS)
        kargs = (ens.f, types, nbrs, eng.lat, cfg.collision, 4, None, "full")
        got = k1.stream_collide_tiles(*kargs, out=ens._spare)
        t = eng.tiling.num_tiles
        bits = torch.int64 if eng.dtype == torch.float64 else torch.int32
        fluid = (b._types[:t] != SOLID)[:, None, :].expand(t, *ens.f.shape[1:])
        single = (b._types, b._nbrs, *kargs[3:])
        err = 0.0
        for i in range(SIM_SLOTS):
            x = torch.cat([ens.f[i * t:(i + 1) * t], ens.f[-1:]])
            one = k1.stream_collide_tiles(x, *single)
            if not torch.equal(got[i * t:(i + 1) * t].view(bits), one[:t].view(bits)):
                raise AssertionError(
                    f"K1 over {SIM_SLOTS}*T tiles {dtype}, replica {i}: not bit for "
                    f"bit a single launch (max |err| "
                    f"{max_err(got[i * t:(i + 1) * t], one[:t]):.3e})")
            del one
            want = k1.stream_collide_tiles_ref(x, *single)
            err = max(err, max_err(got[i * t:(i + 1) * t], want[:t], fluid))
            del x, want
        if not err <= TOL[eng.dtype] or got[-1].any():
            raise AssertionError(f"K1 over {SIM_SLOTS}*T tiles {dtype} vs its plain "
                                 f"version: |err| {err:.3e}")
        log(f"[K1 B={SIM_SLOTS} {dtype} check] on the service's state after the "
            f"run: every replica's rows bit for bit a single launch over that "
            f"replica; max |err| against the plain version {err:.3e}")

        # the NEBB pass over every replica's boundary nodes, on that K1
        # output: the kernel against its plain version, and timed
        nargs = (eng.lat, cfg.collision, cfg.force, b._specs, bc)
        want = nebb.nebb_boundary_pass_ref(ens.f, got.clone(), *nargs)
        nebb.nebb_boundary_pass(ens.f, got, *nargs)
        nebb_err = max_err(got, want)
        del want
        if not nebb_err <= TOL[eng.dtype]:
            raise AssertionError(f"NEBB kernel over {SIM_SLOTS} replicas {dtype} vs its "
                                 f"plain version: |err| {nebb_err:.3e}")
        nebb_ms = time_ms(lambda: nebb.nebb_boundary_pass(ens.f, got, *nargs), 50,
                          label=f"NEBB B={SIM_SLOTS} {dtype}")
        flops, nbytes = nebb.nebb_pass_cost(SIM_SLOTS * int(bc.src.shape[1]), eng.lat,
                                            cfg.collision, eng.dtype.itemsize)
        nebb_bms, _ = bound_ms(nbytes, flops, eng.dtype)
        name = "nebb_boundary_pass" + ("" if dtype == "float64" else f"[{dtype}]")
        self.kernels[name].update({
            "bt_batch": SIM_SLOTS, "bt_ms": nebb_ms, "bt_bound_ms": nebb_bms,
            "bt_launches": nebb_launches, "bt_max_abs_err": nebb_err})
        log(f"[NEBB B={SIM_SLOTS} {dtype}] {SIM_SLOTS} x {bc.src.shape[1]} nodes: "
            f"|err| {nebb_err:.3e}, {nebb_ms:.4f} ms/launch (bound {nebb_bms:.4f} ms, "
            f"{nebb_bms / nebb_ms:.3f} of it); {nebb_launches} launches in the run")

        # K1 at B = 4 timed on the service's buffers, and profiler passes
        ms = time_ms(lambda: k1.stream_collide_tiles(*kargs, out=ens._spare), 50,
                     label=f"K1 B={SIM_SLOTS} {dtype}")
        bt = SIM_SLOTS * t
        flops, nbytes = k1.stream_collide_cost(bt, eng.lat, eng.cfg.collision,
                                               eng.dtype.itemsize, eng.tiling.nodes_per_tile)
        bms, by = bound_ms(nbytes, flops, eng.dtype)
        ens_ms = time_ms(lambda: ens.run(1), 20, label=f"ensemble step {dtype}")
        prof, ens_busy_ms = self.profile_ensemble(ens, step_ms)
        name = "stream_collide_tiles" + ("" if dtype == "float64" else f"[{dtype}]")
        self.kernels[name].update({
            "bt_batch": SIM_SLOTS, "bt_ms": ms, "bt_bound_ms": bms,
            "bt_bound_by": by, "bt_launches": launches, "bt_max_abs_err": err})
        log(f"[K1 B={SIM_SLOTS} {dtype}] {bt} tiles: {ms:.4f} ms/launch = "
            f"{ms / bt * 1e6:.4f} ns per tile (bound {bms:.4f} ms by {by}, "
            f"{bms / ms:.3f} of it); single-engine K1 "
            f"{self.kernels[name]['ms']:.4f} ms for {t} tiles = "
            f"{self.kernels[name]['ms'] / t * 1e6:.4f} ns per "
            f"tile; per tile B={SIM_SLOTS} / single "
            f"{ms / bt / (self.kernels[name]['ms'] / t):.4f}; "
            f"NEBB pass over {SIM_SLOTS} x {bc.src.shape[1]} nodes {prof}; the ensemble step "
            f"alone {ens_ms:.4f} ms (CUDA events, median of 20), the service's "
            f"own work {step_ms - ens_ms:.4f} ms per service step")
        registry = svc.registry
        del svc, group, ens, got, kargs, types, nbrs, bc, fluid
        torch.cuda.empty_cache()
        log(f"[sim service {dtype} profile] " + self.profile_service(
            registry, case, cfg, step_ms, ens_busy_ms))

    def profile_ensemble(self, ens, step_ms: float,
                         steps: int = 5) -> tuple[str, float]:
        """Device time of ``steps`` ensemble steps under ``torch.profiler``
        (after 2 warm-up steps in the same session): K1 per launch, the
        rest (the NEBB pass) per step, and the device busy time per step,
        which it also returns (ms)."""
        dev, _, k1_us, _ = traced(lambda: ens.run(steps), lambda: ens.run(2),
                               f"{steps} ensemble steps")
        if not dev:
            return "not measured (the profiler saw no device time)", float("nan")
        rest = sum(b - a for a, b, nm in dev if K1_KERNEL not in nm)
        busy_ms = busy_us(dev) / 1e3 / steps
        return (f"{rest / 1e3 / steps:.4f} ms device time per step in "
                f"{(len(dev) - len(k1_us)) / steps:.0f} ops; profiled: K1 "
                f"{sum(k1_us) / 1e3 / steps:.4f} ms per launch ({steps} of "
                f"{steps} launches traced), device busy {busy_ms:.4f} ms per "
                f"ensemble step, {1 - busy_ms / step_ms:.3f} of the "
                f"{step_ms:.4f} ms service step idle"), busy_ms

    def profile_service(self, registry, case, cfg, step_ms: float,
                        ens_busy_ms: float) -> str:
        """The service's run again, on a new service over the same registry
        and submissions, under ``torch.profiler`` (its warm-up step in the
        same session): device busy per group step against the unprofiled
        service step, and the device time of the finishes and seats (the
        busy time beyond the group steps' ensemble steps).  Each profiler
        pass builds its service anew in its warm-up, the last one freed
        first."""
        state: dict = {}

        def warm():
            state.clear()
            torch.cuda.empty_cache()
            svc = SimService(slots=SIM_SLOTS, registry=registry)
            for i in range(SIM_SESSIONS):
                svc.submit(case.geometry, cfg, steps=SIM_STEPS + i * SIM_STAGGER)
            sim_serve.warm_and_snapshot(svc)
            state.update(svc=svc, rec=obs.SpanRecorder())

        def run():
            with obs.use(trace=state["rec"]):
                state["svc"].run()

        dev, _, k1_us, _ = traced(run, warm, "the service's run")
        steps = len(state["rec"].find("sim.group.step"))
        state.clear()
        if not dev:
            return "not measured (the profiler saw no device time)"
        if len(k1_us) != steps:
            raise AssertionError(f"K1 launched {len(k1_us)} times in the profiled "
                                 f"service's {steps} group steps")
        busy_ms = busy_us(dev) / 1e3
        seat_finish_ms = busy_ms - steps * ens_busy_ms
        return (f"profiled service run: {len(dev)} device ops, device busy "
                f"{busy_ms / steps:.4f} ms per group step ({steps} of {steps} "
                f"K1 launches traced), {1 - busy_ms / steps / step_ms:.3f} of "
                f"the {step_ms:.4f} ms service step idle; finishes and seats "
                f"{seat_finish_ms:.2f} ms of device time in the run = "
                f"{seat_finish_ms / steps:.4f} ms per group step")

    def sim_parity(self) -> None:
        """(c) Ensembles, split streaming and the dense oracle on the card."""
        case = launcher.make_case("spheres", 1)
        kw = dict(collision=C.CollisionConfig(tau=0.6), dtype="float64",
                  boundaries=case.boundaries)
        cfg = LBMConfig(backend="fused", **kw)
        eng = SparseTiledLBM(case.geometry, cfg, device=self.dev)
        ens = eng.ensemble(ENS_BATCH)
        feq = eng._initial_feq()
        worst = 0.0
        fluid = ~eng._solid[None]
        singles = []
        for b in range(ENS_BATCH):
            single = SparseTiledLBM(case.geometry, cfg, device=self.dev)
            single.f = single.backend.initial_state(feq * (1.0 + 0.01 * (b + 1)))
            ens.set_replica(b, feq * (1.0 + 0.01 * (b + 1)))
            singles.append(single)
        ens.run(20)
        for b, single in enumerate(singles):
            single.run(20)
            want = single.backend.canonical(single.f)
            worst = max(worst, max_err(ens.replica_canonical(b), want,
                                       fluid.expand_as(want)))
        if not worst <= TOL[torch.float64]:
            raise AssertionError(f"fused ensemble vs single engines: {worst:.3e}")
        g_kw = dict(kw, layout_scheme="paper")
        mono = SparseTiledLBM(case.geometry, LBMConfig(**g_kw), device=self.dev)
        split = SparseTiledLBM(case.geometry, LBMConfig(split_stream=True, **g_kw),
                               device=self.dev)
        mono.run(PARITY_STEPS)
        split.run(PARITY_STEPS)
        if not torch.equal(mono.f, split.f):
            raise AssertionError("split-stream gather engine differs from the "
                                 "monolithic one: max |err| "
                                 f"{max_err(mono.f, split.f):.3e}")
        duct = launcher.make_case("duct", 1)
        d_cfg = LBMConfig(collision=C.CollisionConfig(tau=0.6), dtype="float64",
                          boundaries=duct.boundaries, layout_scheme="paper")
        sparse = SparseTiledLBM(duct.geometry, d_cfg, device=self.dev)
        dense = DenseLBM(np.pad(duct.geometry, [
            (0, sparse.tiling.shape[i] - duct.geometry.shape[i]) for i in range(3)]),
            d_cfg, device=self.dev)
        sparse.run(PARITY_STEPS)
        dense.step(PARITY_STEPS)
        rho_s, u_s = sparse.fields_dense()
        rho_d, u_d = (x.cpu().numpy() for x in dense.macroscopics())
        fl = dense.node_type != SOLID
        d_err = max(np.abs(np.where(fl, rho_s - rho_d, 0)).max(),
                    np.abs(np.where(fl[None], u_s - u_d, 0)).max())
        if not d_err <= TOL[torch.float64]:
            raise AssertionError(f"DenseLBM vs sparse engine: {d_err:.3e}")
        log(f"[sim parity float64] spheres scale 1: {ENS_BATCH} fused replicas vs "
            f"single engines after 20 steps max |err| {worst:.3e}; split-stream "
            f"gather bit for bit the monolithic one after {PARITY_STEPS} steps "
            f"(index bytes per step {split.index_bytes_per_step()} vs "
            f"{mono.index_bytes_per_step()}); duct DenseLBM vs sparse after "
            f"{PARITY_STEPS} steps max |err| {d_err:.3e}")

    def sim_checkpoint(self) -> None:
        """(d) Checkpoint after 20 steps, restore into a new service, finish:
        every session's final state bit for bit an uninterrupted run's."""

        class Recording(SimService):
            """Keeps each session's state as it finishes."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.final = {}

            def _finish(self, group, slot):
                sess = group.active[slot]
                self.final[sess.sid] = group.ensemble.replica_canonical(slot).clone()
                super()._finish(group, slot)

        case = launcher.make_case("spheres", 1)
        cfg = LBMConfig(collision=C.CollisionConfig(tau=0.6), dtype="float64",
                        boundaries=case.boundaries, backend="fused")

        def submit(svc):
            for steps in (30, 35, 40):
                svc.submit(case.geometry, cfg, steps=steps)

        whole = Recording(slots=2, device=self.dev)
        submit(whole)
        whole.run()
        with tempfile.TemporaryDirectory() as root:
            first = Recording(slots=2, checkpoint_root=root, device=self.dev)
            submit(first)
            first.step(20)
            path = first.checkpoint()
            del first
            again = Recording.restore(root, slots=2, device=self.dev)
            finished = again.run()
        if sorted(again.final) != sorted(whole.final) or len(finished) != 3:
            raise AssertionError(f"restored run finished {sorted(again.final)}")
        for sid, f in whole.final.items():
            if not torch.equal(again.final[sid], f):
                raise AssertionError(f"session {sid} differs after the checkpoint "
                                     f"round trip: {max_err(again.final[sid], f):.3e}")
        log(f"[sim checkpoint float64] spheres scale 1, 2 slots, 3 sessions: "
            f"checkpoint at service step 20 ({Path(path).name}), restored and "
            f"finished; every session's final state bit for bit the "
            f"uninterrupted run's")

    def sim_main(self) -> None:
        self.check_k1_bt_grid()
        case = launcher.make_case("spheres", 4)
        for dtype in ("float64", "float32"):
            self.sim_service(case, dtype)
            torch.cuda.empty_cache()
        self.sim_parity()
        self.sim_checkpoint()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 6
    def _qkv(self, gen, dtype, b, s, h, kvh, hd):
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=self.dev).to(dtype)
        return randn(b, s, h, hd), randn(b, s, kvh, hd), randn(b, s, kvh, hd)

    def check_k3_matrix(self) -> None:
        gen = torch.Generator(device=self.dev).manual_seed(0)
        worst, count = {}, 0
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 2):
                for h, kvh in ((4, 4), (4, 2), (24, 2)):
                    for hd in (16, 64, 128, 256):
                        for s in (64, 129, 200, 2048):
                            q, k, v = self._qkv(gen, dtype, b, s, h, kvh, hd)
                            for cap in (None, 30.0):
                                for causal in (True, False):
                                    kw = dict(softcap=cap, causal=causal)
                                    got = k3.flash_attention(q, k, v, **kw)
                                    torch.cuda.synchronize()
                                    want = k3.flash_attention_ref(q, k, v, **kw)
                                    err, ratio = k3_error(q, k, v, got, want, kw)
                                    tag = str(dtype).split(".")[1]
                                    worst[tag] = max(worst.get(tag, 0.0), ratio)
                                    count += 1
                                    if not ratio <= 1.0 or got.shape != q.shape:
                                        raise AssertionError(
                                            f"K3 {dtype} B={b} H={h} KVH={kvh} hd={hd} "
                                            f"S=T={s} softcap={cap} causal={causal}: "
                                            f"max |err| {err:.3e}, {ratio:.3f} of "
                                            "the bound at the worst element")
                            del q, k, v, got, want
        log(f"[K3 vs plain] {count} cases within tolerance; worst |err| / "
            f"bound over elements, by dtype: {json.dumps(worst)}")

    def check_k3_masks(self) -> None:
        """K3 with a window and with a prefix (the masks of gemma2's local
        layers and of paligemma) against its plain version, element by
        element within ``error_bound``."""
        gen = torch.Generator(device=self.dev).manual_seed(1)
        worst, count = {}, 0
        for dtype, hd in K3_MASK_KERNELS:
            for s in K3_MASK_LENGTHS:
                q, k, v = self._qkv(gen, dtype, 1, s, 4, 2, hd)
                for window, prefix in K3_MASKS:
                    window = s if window == "S" else window      # >= S: no window
                    prefix = s + 1 if prefix == "S" else prefix  # >= S: all of it
                    for cap in (None, 50.0):
                        kw = dict(softcap=cap, window=window, prefix_len=prefix)
                        got = k3.flash_attention(q, k, v, **kw)
                        torch.cuda.synchronize()
                        want = k3.flash_attention_ref(q, k, v, **kw)
                        err, ratio = k3_error(q, k, v, got, want, kw)
                        tag = f"{str(dtype).split('.')[1]} hd={hd}"
                        worst[tag] = max(worst.get(tag, 0.0), ratio)
                        count += 1
                        if not ratio <= 1.0:
                            raise AssertionError(
                                f"K3 {tag} S=T={s} window={window} prefix={prefix} "
                                f"softcap={cap}: max |err| {err:.3e}, {ratio:.3f} of "
                                "the bound at the worst element")
                del q, k, v, got, want
        log(f"[K3 window/prefix vs plain] {count} cases within tolerance; worst "
            f"|err| / bound over elements: {json.dumps(worst)}")

    def check_k3_hd80(self) -> None:
        """K3 at hd 80 (zamba2's shared attention block: the Hopper kernel
        with its 16-column tail chunk in bf16, the FMA kernel in float32)
        against its plain version, element by element within
        ``error_bound``: at lengths one short of, on and past the 128-row
        blocks and 128-key tiles, GQA, two batches and zamba2's heads,
        causal and not, with windows, prefixes and softcap 50, so that
        every template branch (causal x softcap, masked and unmasked
        tiles) runs."""
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev).manual_seed(2)
        worst, count = {}, 0
        for dtype in (torch.float32, torch.bfloat16):
            for s in K3_HD80_LENGTHS:
                heads = K3_HD80_HEADS + (((1, 32, 32),) if s == 2048 else ())
                for b, h, kvh in heads:
                    q, k, v = self._qkv(gen, dtype, b, s, h, kvh, 80)
                    for (causal, window, prefix), with_cap in K3_HD80_MASKS:
                        for cap in (None, 50.0) if with_cap else (None,):
                            kw = dict(causal=causal, window=window, prefix_len=prefix,
                                      softcap=cap)
                            got = k3.flash_attention(q, k, v, **kw)
                            torch.cuda.synchronize()
                            want = k3.flash_attention_ref(q, k, v, **kw)
                            err, ratio = k3_error(q, k, v, got, want, kw)
                            tag = str(dtype).split(".")[1]
                            worst[tag] = max(worst.get(tag, 0.0), ratio)
                            count += 1
                            if not ratio <= 1.0 or got.shape != q.shape:
                                raise AssertionError(
                                    f"K3 {tag} hd=80 B={b} H={h} KVH={kvh} S=T={s} "
                                    f"causal={causal} window={window} prefix={prefix} "
                                    f"softcap={cap}: max |err| {err:.3e}, {ratio:.3f} of "
                                    "the bound at the worst element")
                    del q, k, v, got, want
        log(f"[K3 hd=80 vs plain] {count} cases within tolerance in "
            f"{time.perf_counter() - t0:.1f} s; worst |err| / bound over elements, by "
            f"dtype: {json.dumps(worst)}")

    # ------------------------------------------------------------ phase 7
    def serve_main(self, run: "ServeRun") -> None:
        cfg = get_config(run.arch)
        if run.param_dtype and run.param_dtype != cfg.param_dtype:
            log(f"[serve {run.arch}] param_dtype {cfg.param_dtype} -> {run.param_dtype}: "
                f"{cfg.param_count()[0]:,} parameters in float32 and their bf16 copy "
                f"for compute take {cfg.param_count()[0] * 6 / 1e9:.1f} GB, more than "
                "the card's 80 GB; in bfloat16 the weights are read as they are")
            cfg = dataclasses.replace(cfg, param_dtype=run.param_dtype)
        t0 = time.perf_counter()
        model = CausalLM(cfg, device=self.dev, seed=0).requires_grad_(False)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        eng = ServeEngine(model, run.slots, run.max_len, cache_dtype=torch.float32)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, run.prompt).astype(np.int32)
                   for _ in range(run.requests)]
        # warm-up outside the counted run: cuBLAS handles, the bf16 weight
        # copies, the first K3 launch
        model.prefill(torch.as_tensor(prompts[0][:64], device=self.dev)[None],
                      128, torch.float32)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=run.new))
        torch.cuda.reset_peak_memory_stats()
        k3.flash_attention.launches = 0
        k3.flash_attention.mask_launches = {"window": 0, "prefix": 0}
        t0 = time.perf_counter()
        finished = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k3.flash_attention.launches
        masks = dict(k3.flash_attention.mask_launches)
        phases = eng.k3_launches            # read around each phase's calls
        peak = torch.cuda.max_memory_allocated() / 2**30
        # layers whose prefill K3 must run with a window (gemma2's local
        # layers, when the prompt is longer than the window) or a prefix
        mask = model_mask(cfg)
        windowed = (cfg.n_layers // 2 if mask == "window"
                    and run.prompt > cfg.local_window else 0)
        prefixed = cfg.n_layers if mask == "prefix" else 0
        want_masks = {"window": run.requests * windowed, "prefix": run.requests * prefixed}
        calls = attention_calls(cfg)
        if launches != run.requests * calls or phases != {
                "prefill": launches, "decode": 0} or masks != want_masks:
            raise AssertionError(f"K3 launched {launches} times ({phases} by "
                                 f"phase, {masks} with a mask), expected "
                                 f"{run.requests} prefills x {calls} attention layers "
                                 f"({want_masks} with a mask), none in decode")
        if len(finished) != run.requests or any(len(r.out_tokens) != run.new
                                                for r in finished):
            raise AssertionError("a request did not finish with "
                                 f"{run.new} tokens: {[len(r.out_tokens) for r in finished]}")
        logits, _ = model.decode_step(
            torch.as_tensor([[r.out_tokens[-1]] for r in finished[:run.slots]],
                            device=self.dev), eng.cache, run.prompt + run.new)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits after the serving run")
        pre_ms, dec_ms = eng.phase_ms["prefill"], eng.phase_ms["decode"]
        per_request, per_step = pre_ms / run.requests, dec_ms / eng.decode_steps
        mask_note = "".join(f", {n} with a {m}" for m, n in masks.items() if n)
        log(f"[serve {run.arch}] {model.param_count():,} parameters ({cfg.param_dtype} "
            f"params, {cfg.dtype} compute, float32 cache), init {setup:.1f} s; "
            f"{run.requests} requests x {run.prompt} prompt tokens, {run.new} new, "
            f"{run.slots} slots, max_len {run.max_len}: prefill {eng.tokens['prefill']} "
            f"tokens in {pre_ms:.2f} ms = {eng.tokens['prefill'] / pre_ms * 1e3:.1f} "
            f"tok/s ({per_request:.3f} ms/request); decode {eng.tokens['decode']} "
            f"tokens in {eng.decode_steps} steps, {dec_ms:.2f} ms = "
            f"{eng.tokens['decode'] / dec_ms * 1e3:.1f} tok/s ({per_step:.4f} "
            f"ms/step); run wall {wall:.2f} s; K3 launches {launches} (prefill "
            f"{phases['prefill']}, decode {phases['decode']}{mask_note}); peak "
            f"device memory {peak:.2f} GiB; first tokens {finished[0].out_tokens[:6]}; "
            "logits after the run finite")
        if calls:
            self.prefill_vs_plain(model, run, prompts[0])
        if cfg.family == "moe":
            self.moe_prefill_repeats(model, run, prompts[0])
        if cfg.family == "ssm":
            self.wkv_chunked_vs_exact(model, run, prompts[0])
        self.profile_serve(model, eng, run, prompts[0], per_request, per_step)
        if calls:
            self.k3_main_shapes(model, cfg, run, prompts[0],
                                {"causal": launches, **masks},
                                {name: n / run.requests for name, n in phases.items()})

    def prefill_vs_plain(self, model, run, prompt) -> None:
        """A sanity check of the whole prefill: one request's logits with
        K3 against the same prefill with K3's plain version in its place
        (every layer's attention, its window and prefix included), within
        5e-2 of the largest logit.  The two differ by bf16 roundings (K3
        rounds p for p.v, or to TF32 at hd 80), carried through the layers.
        A control logs the gap of the plain version with the model's mask
        dropped (its window or prefix, or for a causal model the causal
        mask): what this check would see of a K3 that lost it (gemma2's lost
        window shows far above the limit, paligemma's lost prefix below it).
        The element-wise ``error_bound`` checks at the main shapes and in the
        mask matrix are what hold K3's masks."""
        toks = torch.as_tensor(prompt, device=self.dev)[None]
        plain = k3.flash_attention_ref
        mask = model_mask(model.cfg)
        moe = model.cfg.family == "moe"

        def unmasked(q, k, v, **kw):
            lost = ({"causal": False} if mask == "causal"
                    else {"window": None, "prefix_len": 0})
            return plain(q, k, v, **{**kw, **lost})

        def prefill_with(attend=None, routes=None):
            """The prefill's logits, K3 replaced by ``attend``; for a MoE
            model, each layer's routing appended to ``routes`` when it is
            empty, else replayed from it in layer order."""
            kernel, route = k3.flash_attention, moe_mod.route
            replay = iter(list(routes)) if routes else None

            def routing(router, tokens, cfg):
                if replay is not None:
                    return next(replay)
                out = route(router, tokens, cfg)
                routes.append(out)
                return out

            if attend is not None:
                k3.flash_attention = attend         # what attention calls
            if routes is not None:
                moe_mod.route = routing             # what moe_ffn calls
            try:
                return model.prefill(toks, run.max_len, torch.float32)[0]
            finally:
                k3.flash_attention, moe_mod.route = kernel, route

        # a MoE model's top-k routing is discontinuous: the plain version's
        # roundings can send a token to another expert, which no tolerance
        # on the logits covers, so the plain prefills replay K3's routing
        routes = [] if moe else None
        got = prefill_with(routes=routes)
        want = prefill_with(plain, routes)
        top = want.abs().max()
        rel = float((got - want).abs().max() / top)
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        lost = float((prefill_with(unmasked, routes) - want).abs().max() / top)
        how = free = ""
        if moe:
            own = float((prefill_with(plain) - got).abs().max() / top)
            how = " with K3's routing replayed"
            free = (f"; with the plain version routing its own tokens: {own:.3e} "
                    "(routing flips)")
        log(f"[serve {run.arch} vs plain] prefill logits of one request: max "
            f"|K3 - plain| = {rel:.3e} of max |logit| ({float(top):.3f}){how}; "
            f"same greedy token: {same}; control, the plain version without the "
            f"{mask} mask: {lost:.3e} of max |logit|{free}")
        if not rel <= 5e-2:
            raise AssertionError(f"{run.arch}: prefill logits with K3 differ from "
                                 f"the plain version's by {rel:.3e} of their largest")

    def moe_prefill_repeats(self, model, run, prompt) -> None:
        """The MoE combine gathers each token's k expert outputs back in
        token order and sums them in a fixed order (no atomics): two
        identical prefills must give bit-identical logits and caches."""
        toks = torch.as_tensor(prompt, device=self.dev)[None]
        (a, ca), (b, cb) = (model.prefill(toks, run.max_len, torch.float32)
                            for _ in range(2))
        same = torch.equal(a, b) and all(
            torch.equal(x, y) for g in ca for x, y in zip(ca[g].values(), cb[g].values()))
        log(f"[serve {run.arch} MoE repeat] two identical prefills: logits and "
            f"caches bit for bit equal: {same}")
        if not same:
            raise AssertionError(f"{run.arch}: two identical prefills differ "
                                 f"(max |logit diff| {float((a - b).abs().max()):.3e})")

    def wkv_chunked_vs_exact(self, model, run, prompt) -> None:
        """One full-width layer's chunked WKV (layer 0 of a prefill, its
        float32 r/k/v/w/u as the model computes them) against the exact
        step scan on the same inputs.  The reference's tolerance
        (tests/test_rwkv_chunked.py) is 1e-5 relative; the gap is reported:
        the intra-chunk factorisation clips its exponents at +-60, which
        the decays of real widths may reach.  Both must be finite."""
        from repro_torch.models import rwkv6

        toks = torch.as_tensor(prompt, device=self.dev)[None]
        seen = []
        chunked = rwkv6.wkv6_chunked

        def first(*args):
            if not seen:
                seen.append(args)
            return chunked(*args)

        rwkv6.wkv6_chunked = first
        try:
            model.prefill(toks, run.max_len, torch.float32)
        finally:
            rwkv6.wkv6_chunked = chunked
        r, k, v, w, u, state = seen[0]
        o1, s1 = chunked(r, k, v, w, u, state)
        o2, s2 = rwkv6.wkv6_steps(r, k, v, w, u, state)
        rel_o = float((o1 - o2).abs().max() / o2.abs().max())
        rel_s = float((s1 - s2).abs().max() / s2.abs().max())
        finite = all(bool(torch.isfinite(t).all()) for t in (o1, o2, s1, s2))
        log(f"[serve {run.arch} WKV chunked vs exact] layer 0, B=1 S={r.shape[1]} "
            f"H={r.shape[2]} K={r.shape[3]}, float32: max |chunked - exact| / max "
            f"|exact| = {rel_o:.3e} (outputs), {rel_s:.3e} (final state); within the "
            f"reference's 1e-5: {max(rel_o, rel_s) <= 1e-5}; min decay "
            f"{float(w.min()):.3e}, largest chunk decay exponent "
            f"{float(-torch.log(w).reshape(1, -1, 32, *w.shape[2:]).sum(2).max()):.2f}")
        if not finite:
            raise AssertionError(f"{run.arch}: the chunked or exact WKV is not finite")

    def profile_serve(self, model, eng, run, prompt, prefill_ms, step_ms) -> None:
        """Device time of one prefill and 5 decode steps under
        ``torch.profiler``: device busy (union of kernel and memory-op
        intervals) and K3's part of it.  The idle share is against the
        unprofiled times of the counted run (``prefill_ms`` per request,
        ``step_ms`` per decode step)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        toks = torch.as_tensor(prompt, device=self.dev)[None]
        step_toks = torch.zeros(run.slots, 1, dtype=torch.int64, device=self.dev)
        for phase, fn, reps, unprofiled in (
                ("prefill", lambda: model.prefill(toks, run.max_len, torch.float32),
                 1, prefill_ms),
                ("decode", lambda: model.decode_step(step_toks, eng.cache,
                                                     run.prompt + run.new), 5, step_ms)):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                stop.record()
                stop.synchronize()
            ms = start.elapsed_time(stop) / reps
            dev = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in prof.events() if e.device_type == DeviceType.CUDA)
            if not dev:
                log(f"[profile serve {run.arch} {phase}] the profiler saw no device "
                    "time: device busy share not measured")
                continue
            busy, end = 0.0, -1.0
            for a, b, _ in dev:
                busy += max(0.0, b - max(a, end))
                end = max(end, b)
            k3_ms = sum(b - a for a, b, n in dev if "flash_fwd" in n) / 1e3 / reps
            busy_ms = busy / 1e3 / reps
            host_ops = [e for e in prof.events() if e.device_type == DeviceType.CPU
                        and e.name.startswith("aten::") and e.cpu_parent is None]
            host_ms = sum(e.cpu_time_total for e in host_ops) / 1e3 / reps
            log(f"[profile serve {run.arch} {phase}] per call: {len(dev) / reps:.0f} "
                f"device ops, device busy {busy_ms:.4f} ms of {unprofiled:.4f} ms "
                f"unprofiled (idle share {1 - busy_ms / unprofiled:.3f}; "
                f"{ms:.4f} ms under the profiler), K3 {k3_ms:.4f} ms = "
                f"{k3_ms / unprofiled:.3f} of the call; {len(host_ops) / reps:.0f} "
                f"top-level host torch ops taking {host_ms:.2f} ms of host time "
                f"(profiled)")

    def k3_main_shapes(self, model, cfg, run, prompt, launches: dict,
                       per_request: dict) -> None:
        """K3 on the q/k/v of the first launch of each mask kind in one
        prefill of one of the run's prompts (the first layer; gemma2's local
        and global layers of its first pair), against its plain version and
        the library yardstick: ``scaled_dot_product_attention`` with the
        same mask or, where a softcap applies, ``flex_attention``.  The
        launch of the model's own mask (``model_mask``) fills the run's
        entry of the kernels line."""
        toks = torch.as_tensor(prompt, device=self.dev)[None]
        calls, kernel = {}, k3.flash_attention

        def recording(q, k, v, **kw):
            calls.setdefault(call_mask(kw), (q, k, v, kw))
            return kernel(q, k, v, **kw)

        # the wrapper counts on the module's name, this function, while it
        # stands in: those counts are not the run's
        recording.launches, recording.mask_launches = 0, {"window": 0, "prefix": 0}
        k3.flash_attention = recording
        try:
            model.prefill(toks, run.max_len, torch.float32)
        finally:
            k3.flash_attention = kernel
        for mask, (q, k, v, kw) in calls.items():
            got = k3.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = k3.flash_attention_ref(q, k, v, **kw)
            err, ratio = k3_error(q, k, v, got, want, kw)
            if not ratio <= 1.0:
                raise AssertionError(f"K3 vs plain at {run.arch}'s main shapes ({mask}): "
                                     f"max |err| {err:.3e}, {ratio:.3f} of the bound")
            lib_name, lib_fn = library_attention(q, k, v, scale=kw["scale"],
                                                 softcap=kw["softcap"], window=kw["window"],
                                                 prefix_len=kw["prefix_len"])
            lib_err, lib_ratio = k3_error(q, k, v, lib_fn(), want, kw)
            if not lib_ratio <= 1.0:
                raise AssertionError(f"{lib_name} vs K3's plain version at {run.arch}'s "
                                     f"main shapes ({mask}): max |err| {lib_err:.3e}, "
                                     f"{lib_ratio:.3f} of K3's bound")
            del got, want
            s, hq, hd = q.shape[1], q.shape[2], q.shape[3]
            shape = (f"{run.arch} {mask} S={s} H={hq} KVH={k.shape[2]} hd={hd} "
                     f"{q.dtype}" + (f" window={kw['window']}" if kw["window"] else "")
                     + (f" prefix={kw['prefix_len']}" if kw["prefix_len"] else "")
                     + (f" softcap={kw['softcap']}" if kw["softcap"] else ""))
            ms = time_ms(lambda: k3.flash_attention(q, k, v, **kw), 50,
                         label=f"K3 {shape}")
            plain_ms = time_ms(lambda: k3.flash_attention_ref(q, k, v, **kw), 20,
                               label="K3 plain")
            lib_ms = time_ms(lib_fn, 50, label=lib_name)
            flops, nbytes = k3.flash_attention_cost(          # the visible pairs
                q.shape[0], s, k.shape[1], hq, k.shape[2], hd, q.element_size(),
                window=kw["window"], prefix_len=kw["prefix_len"])
            bms, by = bound_ms(nbytes, flops, q.dtype)
            if mask == model_mask(cfg):
                key = kernel_entry(cfg)
                self.kernels[key] = {
                    "name": key, "route": "cuda", "source": f"{SOURCE}/flash_attn.cu",
                    "replaces": "src/repro/kernels/flash.py:70",
                    "launches": launches[mask], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms, "model": run.arch,
                    "launches_per_request": per_request}
            log(f"[K3 {shape}] |err| {err:.3e} ({ratio:.3f} of the bound), {ms:.4f} "
                f"ms/launch = {flops / ms / 1e9:.1f} TFLOP/s over the visible pairs "
                f"(bound {bms:.4f} ms by {by}, {bms / ms:.4f} of it), plain "
                f"{plain_ms:.3f} ms, {lib_name} {lib_ms:.4f} ms (|err| {lib_err:.3e}, "
                f"{lib_ratio:.3f} of K3's bound; K3 takes {ms / lib_ms:.2f}x "
                f"{lib_name}'s time)")
            del q, k, v, lib_fn
        calls.clear()

    # ------------------------------------------------------------ phase 8
    def kernel_line_bwd(self) -> None:
        """K3's backward in the kernels line: its launches in starcoder2's
        timed training steps, its numbers at starcoder2's layer shape, and
        each width's kernel with its numbers at the other layers."""
        t = self.k3_bwd["starcoder2-3b"]
        run = self.train["starcoder2-3b"]
        self.kernels["flash_attention_bwd"] = {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": f"{SOURCE}/flash_attn_bwd.cu",
            "replaces": "src/repro/models/attention.py:254",
            "launches": run["bwd_launches"], "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "model": "starcoder2-3b",
            "launches_per_step": run["bwd_launches"] / run["steps"],
            "launches_per_step_by_model": {arch: r["bwd_launches"] / r["steps"]
                                           for arch, r in self.train.items()},
            "head_dims": self.k3_bwd_kernels,
            "layers": {arch: {key: r[key] for key in ("hd", "kernels", "ms", "library",
                                                      "library_ms", "bound_ms", "max_abs_err")}
                       for arch, r in self.k3_bwd.items()}}

    def check_k3_bwd_matrix(self) -> None:
        """K3's backward kernel against its plain version on float64
        copies of the inputs, element by element within
        ``error_bound_bwd``, for dQ, dK and dV, from the lse of K3's
        forward."""
        gen = torch.Generator(device=self.dev).manual_seed(2)
        worst, count = {}, 0
        for dtype in (torch.float32, torch.bfloat16):
            for hd in k3.BWD_HEAD_DIMS:
                for group in K3_BWD_GROUPS:
                    for s in K3_BWD_LENGTHS:
                        q, k, v = self._qkv(gen, dtype, 1, s, 2 * group, 2, hd)
                        dout = torch.randn(q.shape, generator=gen, device=self.dev).to(dtype)
                        for window, prefix, cap in K3_BWD_MASKS:
                            kw = dict(softcap=cap, window=window, prefix_len=prefix)
                            out, lse = k3.flash_attention(q, k, v, return_lse=True, **kw)
                            got = k3.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
                            torch.cuda.synchronize()
                            want = k3.flash_attention_bwd_ref(
                                *(x.double() for x in (q, k, v, out, dout)), **kw)
                            bounds = k3.error_bound_bwd(q, k, v, out, dout, want, **kw)
                            tag = f"{str(dtype).split('.')[1]} hd={hd}"
                            for name, g, w, bd in zip(("dq", "dk", "dv"), got, want, bounds):
                                d = (g.to(w.dtype) - w).abs()
                                ratio = bound_ratio(d, bd)
                                worst[tag] = max(worst.get(tag, 0.0), ratio)
                                if not ratio <= 1.0:
                                    raise AssertionError(
                                        f"K3 bwd {tag} G={group} S=T={s} window={window} "
                                        f"prefix={prefix} softcap={cap}: {name} max |err| "
                                        f"{float(d.max()):.3e}, {ratio:.3f} of the bound")
                            count += 1
                        del q, k, v, dout, out, lse, got, want, bounds
        log(f"[K3 bwd vs plain] {count} cases (dq, dk, dv each) within "
            f"error_bound_bwd; worst |err| / bound over elements: {json.dumps(worst)}")

    def k3_bwd_main_shapes(self) -> None:
        """K3's backward kernel at the layers of ``K3_BWD_LAYERS`` (bf16,
        causal; gemma2's with its window and softcap, paligemma's with its
        prefix):
        against its plain version (the kernels line's max_abs_err:
        starcoder2's) element by element within ``error_bound_bwd`` and
        norm-wise within ``K3_BWD_NORM_REL``, with planted faults that must
        fail one of the two (the plain version's gradients of a wrong
        function), timed (median of 50 launches) beside its operations
        bound (10 hd flops per visible (query, key) pair and head, at the
        dense bf16 peak), the plain version and the library yardstick,
        which the port never calls: the backward through autograd of
        ``scaled_dot_product_attention(is_causal=True)``, or of
        ``flex_attention`` where the softcap applies, timed in turns with
        the kernel; its kernels' device time from a profiler pass, and the
        longest and average block's tile iterations."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        gen = torch.Generator(device=self.dev).manual_seed(3)
        for arch, (b, s, prefix) in K3_BWD_LAYERS.items():
            cfg = get_config(arch)
            h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
            kw = dict(scale=cfg.query_scale or hd ** -0.5, softcap=cfg.attn_softcap,
                      window=cfg.local_window, prefix_len=prefix)
            q, k, v = self._qkv(gen, torch.bfloat16, b, s, h, kvh, hd)
            dout = torch.randn(q.shape, generator=gen, device=self.dev).to(torch.bfloat16)
            out, lse = k3.flash_attention(q, k, v, return_lse=True, **kw)
            got = k3.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            torch.cuda.synchronize()
            want = k3.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
            bounds = k3.error_bound_bwd(q, k, v, out, dout, want, **kw)

            def held(outs, names=("dq", "dk", "dv")):
                """{name: (worst |x - plain| / bound, ||x - plain|| / ||plain||)}"""
                res = {}
                for name, x in zip(names, outs):
                    i = ("dq", "dk", "dv").index(name)
                    w = want[i].float()
                    d = x.float() - w
                    res[name] = (bound_ratio(d, bounds[i]), float(d.norm() / w.norm()))
                return res

            got_held = held(got)
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            ratio = max(r for r, _ in got_held.values())
            norm = max(n for _, n in got_held.values())
            del got
            if not (ratio <= 1.0 and norm <= K3_BWD_NORM_REL):
                raise AssertionError(f"K3 bwd vs plain at {arch}'s layer shape: max |err| "
                                     f"{err:.3e}; worst / bound, norm-wise distance: "
                                     f"{got_held} (norm-wise limit {K3_BWD_NORM_REL})")
            # planted faults: the first query head's dO zeroed (dK and dV
            # over G - 1 heads of KV head 0, or none where G = 1; that
            # head's dQ zero), and dQ without each row's own 64-key tile
            dropped = dout.clone()
            dropped[:, :, 0] = 0
            faults = {"head 0 dropped": held(
                k3.flash_attention_bwd_ref(q, k, v, out, dropped, **kw))}
            del dropped
            dq_whole, dq_fault = k3_bwd_dq_faults(q, k, v, out, dout, **kw)
            rebuilt = held([dq_whole], ("dq",))["dq"]
            if not (rebuilt[0] <= 1.0 and rebuilt[1] <= K3_BWD_NORM_REL):
                raise AssertionError(f"k3_bwd_dq_faults' whole dQ is not the plain "
                                     f"version's at {arch}'s layer shape: {rebuilt}")
            faults["diagonal key tile dropped"] = held([dq_fault], ("dq",))
            del dq_whole, dq_fault, want, bounds
            missed = [(f, name) for f, res in faults.items() for name, (r, n) in res.items()
                      if r <= 1.0 and n <= K3_BWD_NORM_REL]
            log(f"[K3 bwd {arch} checks] kernel: worst |err| / bound, ||err|| / ||plain|| "
                f"{json.dumps(got_held)} (norm-wise limit {K3_BWD_NORM_REL}); planted "
                f"faults: {json.dumps(faults)}")
            if missed:
                raise AssertionError(f"K3 bwd checks at {arch}'s layer shape pass planted "
                                     f"faults: {missed}")
            lib_name, lib_fn = library_attention_bwd(q, k, v, dout, **kw)

            def kernel():
                return k3.flash_attention_bwd(q, k, v, out, dout, lse, **kw)

            times = interleaved_ms({"kernel": kernel, "library": lib_fn})
            ms = time_ms(kernel, 50, label=f"K3 bwd {arch}")
            plain_ms = time_ms(lambda: k3.flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw),
                               3, warm=1, label="K3 bwd plain")
            # the profiler can lose the records of a session's first kernels,
            # so each kernel's time is the mean over the launches it traced;
            # every kernel the dispatch names must be traced (a pass that
            # lost one is repeated, 3 at most), and no other
            expect = k3_bwd_kernels("bfloat16", hd, h // kvh)
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(8):
                        kernel()
                    torch.cuda.synchronize()
                traced_us = {}
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA and K3_BWD_NAME in e.name:
                        part = re.sub(r"[<(].*", "", e.name).split("::")[-1]
                        traced_us.setdefault(part, []).append(
                            e.time_range.end - e.time_range.start)
                if tuple(sorted(traced_us)) == expect:
                    break
            if tuple(sorted(traced_us)) != expect:
                raise AssertionError(f"K3 bwd at {arch}'s layer shape: the profiler traced "
                                     f"{sorted(traced_us)}, the dispatch names {expect}")
            split = {part: float(np.mean(us)) / 1e3 for part, us in traced_us.items()}
            window = kw["window"] if kw["window"] and kw["window"] < s else None
            work = bwd_block_work(s, s, hd, h // kvh, window=window, prefix_len=prefix)
            flops, nbytes = k3.flash_attention_bwd_cost(b, s, s, h, kvh, hd, q.element_size(),
                                                        window=kw["window"],
                                                        prefix_len=prefix)
            bms, by = bound_ms(nbytes, flops, torch.bfloat16)
            shape = (f"B={b} S={s} H={h} KVH={kvh} hd={hd} bf16 causal"
                     + (f" window={kw['window']}" if kw["window"] else "")
                     + (f" prefix={prefix}" if prefix else "")
                     + (f" softcap={kw['softcap']}" if kw["softcap"] else ""))
            log(f"[K3 bwd {arch} {shape}] |err| {err:.3e} ({ratio:.3f} of the bound, "
                f"norm-wise {norm:.3e}); {ms:.4f} ms/launch = {flops / ms / 1e9:.1f} TFLOP/s "
                f"(bound {bms:.4f} ms by {by}, {bms / ms:.4f} of it); in turns with "
                f"{lib_name}'s backward: kernel {times['kernel']:.4f} ms, {lib_name} "
                f"{times['library']:.4f} ms (the kernel takes "
                f"{times['kernel'] / times['library']:.2f}x its time); plain {plain_ms:.3f} "
                f"ms; by kernel (profiled, ms): "
                + ", ".join(f"{k_} {v_:.4f} ({len(traced_us[k_])} of 8 traced)"
                            for k_, v_ in split.items())
                + "; tile iterations per block (longest, average): "
                + ", ".join(f"{k_} {m_} / {a_:.1f}" for k_, (m_, a_) in work.items()))
            self.k3_bwd[arch] = {"hd": hd, "kernels": ", ".join(expect), "err": err, "max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                                 "library": lib_name, "library_ms": times["library"]}
            del q, k, v, dout, out, lse, lib_fn

    def train_main(self, run: "TrainRun") -> None:
        """``make_train_step`` on ``TokenPipeline`` batches at full width:
        ``run.warm`` steps, then ``run.timed`` between CUDA events.  Per
        step K3's forward must launch twice per attention call (each
        checkpointed body runs again in the backward) and its backward
        once; a window applies only where it hides keys (gemma2's 4096 at S
        4096 does not); each of paligemma's forward launches applies its
        prefix."""
        cfg = get_config(run.arch)
        if run.layers:
            cfg = dataclasses.replace(cfg, n_layers=run.layers)
        t0 = time.perf_counter()
        model = CausalLM(cfg, device=self.dev, seed=0)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        audio, vlm = cfg.family == "audio", cfg.family == "vlm"
        if audio:
            self.audio_serve_check(model, cfg)
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq,
                          global_batch=run.batch, seed=0,
                          num_codebooks=cfg.num_codebooks if audio else 0,
                          prefix_tokens=cfg.prefix_tokens if vlm else 0,
                          d_model=cfg.d_model)
        pipe = TokenPipeline(data)
        steps = run.warm + run.timed
        opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps + 1)
        step_fn = make_train_step(model, opt_cfg)
        opt = init_state(dict(model.named_parameters()))
        batches = [pipe.next() for _ in range(steps + 1)]   # made before the timing
        metrics = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(run.warm):
            opt, m = step_fn(opt, batches[i], i)
            metrics.append(m)
        torch.cuda.synchronize()
        k3.flash_attention.launches = k3.flash_attention_bwd.launches = 0
        k3.flash_attention.mask_launches.update(window=0, prefix=0)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(run.warm, steps):
            opt, m = step_fn(opt, batches[i], i)
            metrics.append(m)
        stop.record()
        stop.synchronize()
        fwd, bwd = k3.flash_attention.launches, k3.flash_attention_bwd.launches
        masks = dict(k3.flash_attention.mask_launches)
        step_ms = start.elapsed_time(stop) / run.timed
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        if not all(np.isfinite(losses + norms)):
            raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
        calls = attention_calls(cfg)
        positions = run.seq + (cfg.prefix_tokens if vlm else 0)
        windowed = (cfg.n_layers // 2 if cfg.layer_pattern == "local_global"
                    and cfg.local_window < positions else 0)
        got = {"forward": fwd, "backward": bwd, **masks}
        want = {"forward": 2 * calls * run.timed, "backward": calls * run.timed,
                "window": 2 * windowed * run.timed,
                "prefix": 2 * calls * run.timed if vlm else 0}
        if got != want:
            raise AssertionError(f"K3 launches in {run.timed} steps of {run.arch}: {got}, "
                                 f"expected {want}")
        tokens = run.batch * run.seq
        flops, n_active, attn = train_flops(cfg, run.batch, positions)
        share = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
        unc = {"ssm": "; not counted: the chunked WKV's own products",
               "hybrid": "; not counted: the chunked SSD's own products"}.get(cfg.family, "")
        depth = f", depth cut to {cfg.n_layers} layers" if run.layers else ""
        log(f"[train {run.arch}] {model.param_count():,} parameters{depth} (float32, "
            f"AdamW m/v float32, {cfg.dtype} compute, each scanned body checkpointed), "
            f"init {setup:.1f} s; {run.batch} x {positions} positions per step "
            f"({tokens} text tokens): {step_ms:.2f} ms/step = {tokens / step_ms * 1e3:.1f} "
            f"tok/s over {run.timed} timed steps after {run.warm}; (6 x {n_active:,} active "
            f"parameters x positions + attention {attn:.3e}{unc}) = {flops:.3e} flops per "
            f"step = {share:.4f} of the dense bf16 peak; peak device memory {peak:.2f} GiB "
            f"of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; K3 "
            f"launches per step: forward {fwd / run.timed:.0f} (2 x {calls} attention "
            f"calls), backward {bwd / run.timed:.0f}, with a window "
            f"{masks['window'] / run.timed:.0f}, with a prefix "
            f"{masks['prefix'] / run.timed:.0f}; losses {[round(x, 4) for x in losses]}, "
            f"grad norms {[round(x, 4) for x in norms]}")
        self.train[run.arch] = {"bwd_launches": bwd, "fwd_launches": fwd,
                                "step_ms": step_ms, "steps": run.timed}
        self.profile_train(step_fn, opt, batches[-1], steps, run, step_ms)
        if cfg.family == "hybrid":
            self.ssd_decay_range(model, cfg, batches[-1])

    # ------------------------------------------------------------ phase 9
    def ep_at_deepseek_width(self) -> None:
        """Expert parallelism (``moe_ffn_ep``) at deepseek-moe-16b's layer
        width (d 2048, 64 routed experts top-6 of d_ff 1408, 2 shared), M =
        4 ``LocalComm`` ranks on this card, 4096 tokens a rank, float32
        (TF32 off), against ``moe_ffn`` on the same 16,384 tokens with the
        ranks' routing replayed (a product over other rows can round a
        logit differently and flip a top-6 choice): at a capacity factor of
        2.0, where neither drops a pair (asserted), outputs within 1e-5 of
        the largest and the aux within 1e-6 relative; then each path's drop
        fraction at the config's 1.25."""
        cfg = get_config("deepseek-moe-16b")
        m_ranks, n_tok = 4, 4096
        gen = torch.Generator(device=self.dev).manual_seed(7)
        moe = moe_mod.MoE(cfg.d_model, cfg.d_ff, cfg.moe, cfg.mlp, device=self.dev)
        moe.reset_parameters(gen)
        p = {**moe.weights(torch.float32), **moe.experts.weights(torch.float32)}
        e_loc = cfg.moe.n_experts // m_ranks
        ps = [{**p, **{k: p[k][r * e_loc:(r + 1) * e_loc] for k in ("up", "gate", "down")}}
              for r in range(m_ranks)]
        xs = [torch.randn(1, n_tok, cfg.d_model, generator=gen, device=self.dev)
              for _ in range(m_ranks)]
        comm = LocalComm(1, m_ranks)
        routes, orig = [], moe_mod.route

        def recording(router, tokens, mcfg):
            routes.append(orig(router, tokens, mcfg))
            return routes[-1]

        def replayed(router, tokens, mcfg):
            return tuple(torch.cat(parts) for parts in zip(*routes[-m_ranks:]))

        for cf in (2.0, cfg.moe.capacity_factor):
            mcfg = dataclasses.replace(cfg.moe, capacity_factor=cf)
            stats = {}
            with torch.no_grad():
                moe_mod.route = recording
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs, auxs = moe_mod.moe_ffn_ep(ps, xs, mcfg, cfg.mlp, comm, stats=stats)
                    ep_s = time.perf_counter() - t0
                    moe_mod.route = replayed
                    x = torch.cat(xs, dim=1)
                    want, want_aux = moe_mod.moe_ffn(p, x, mcfg, cfg.mlp)
                finally:
                    moe_mod.route = orig
                _, _, top_e = replayed(None, None, None)
                _, _, keep = moe_mod.dispatch(top_e.sort(-1)[0].reshape(-1), mcfg.n_experts,
                                              moe_mod.capacity(mcfg, x.shape[1]))
            ep_drop = (stats["dropped_send"] + stats["dropped_local"]) / stats["pairs"]
            plain_drop = 1.0 - float(keep.float().mean())
            err = max_err(torch.cat(outs, dim=1), want)
            scale = float(want.abs().max())
            aux_err = abs(float(auxs[0]) - float(want_aux)) / abs(float(want_aux))
            log(f"[ep deepseek width cf {cf}] {m_ranks} LocalComm ranks x {n_tok} tokens, "
                f"float32: dropped pairs: EP {ep_drop:.6f} (at the send buffers "
                f"{stats['dropped_send']}, at the experts {stats['dropped_local']} of "
                f"{stats['pairs']}), moe_ffn {plain_drop:.6f}; max |EP - moe_ffn| {err:.3e} "
                f"(largest |out| {scale:.3e}); aux {float(auxs[0]):.8f} vs "
                f"{float(want_aux):.8f} (rel {aux_err:.2e}); EP forward {ep_s * 1e3:.1f} ms "
                "host time, first call")
            if cf == 2.0:
                if ep_drop or plain_drop:
                    raise AssertionError(f"capacity factor 2.0 dropped pairs: EP {ep_drop}, "
                                         f"moe_ffn {plain_drop}")
                if err > 1e-5 * scale or aux_err > 1e-6:
                    raise AssertionError(f"EP vs moe_ffn: {err} (scale {scale}), aux {aux_err}")
        del moe, ps, p, xs, outs, want

    def ranked_train(self) -> None:
        """deepseek-moe-16b at full width and 4 layers through the ranked
        path (``repro_torch.dist.zero``) on W = the visible cards, mesh 1 x
        W, and unsharded in this process, both through the launcher's loop
        (``tools.train_ranks.measure``/``measure_rank``): 2 warm-up and 3
        timed steps on the global batch of max(2, W) x 4096 tokens, then
        one profiled.  K3 must launch 2 x 4 and its backward 4 times a
        timed step on every rank.  Step 0's loss and grad norm are held to
        the unsharded step's: at W = 1 within 1e-6 relative (one rank
        splits nothing: the step is the same arithmetic, and an H100 read
        them bit for bit); at W > 1 the loss within 1e-3 and the grad norm
        within 1e-2 (the partial sums over "model" round in bf16 and the
        expert capacities count each rank's sequence shard; with every rank
        on its own rows, before tensor parallelism, this step read 3.3e-5
        and 5.3e-4 at W = 4 on four H100s)."""
        w = torch.cuda.device_count()
        run = RankRun("deepseek-moe-16b", data=1, model=w, batch=max(2, w), seq=4096,
                      warm=2, timed=3, layers=4)
        results = measure(run)
        summary = rank_summary(run, results)
        log(summary["line"])
        calls = 4
        for r in results:
            got = (r["k3_fwd"], r["k3_bwd"])
            if got != (2 * calls * run.timed, calls * run.timed):
                raise AssertionError(f"rank {r['rank']}: K3 launches {got} in {run.timed} steps")
        torch.cuda.reset_peak_memory_stats()
        one = measure_rank(run)
        gc.collect()
        torch.cuda.empty_cache()
        log(rank_summary(run._replace(data=1, model=1), [one],
                         label="unsharded deepseek-moe-16b, same loop")["line"])
        ranked, plain = results[0].get("profile") or {}, one.get("profile") or {}
        if ranked.get("kernels") and plain.get("kernels"):
            names = sorted(set(ranked["kernels"]) | set(plain["kernels"]),
                           key=lambda n: -abs(ranked["kernels"].get(n, 0.0)
                                              - plain["kernels"].get(n, 0.0)))
            def ms(side, n):
                return f"{side[n]:.3f}" if n in side else "below its 12 longest"

            log("[ranks deepseek-moe-16b vs one card] profiled step, rank 0 vs unsharded, "
                "kernel time in ms (each side's 12 longest kernels): " + "; ".join(
                    f"{n}: {ms(ranked['kernels'], n)} vs {ms(plain['kernels'], n)}"
                    for n in names))
        tol_loss, tol_gn = (1e-6, 1e-6) if w == 1 else (1e-3, 1e-2)
        loss, gn = one["losses"][0], one["grad_norms"][0]
        r_loss, r_gn = results[0]["losses"][0], results[0]["grad_norms"][0]
        d_loss, d_gn = abs(r_loss - loss) / abs(loss), abs(r_gn - gn) / abs(gn)
        log(f"[ranks deepseek-moe-16b vs one card] step 0 on the same {run.batch} x "
            f"{run.seq} tokens: loss {r_loss!r} ranked vs {loss!r} unsharded (rel "
            f"{d_loss:.2e}, tolerance {tol_loss:g}), grad norm {r_gn!r} vs {gn!r} (rel "
            f"{d_gn:.2e}, tolerance {tol_gn:g}); ms/step {results[0]['step_ms']!r} ranked "
            f"vs {one['step_ms']!r} unsharded")
        if not (d_loss <= tol_loss and d_gn <= tol_gn):
            raise AssertionError("the ranked step differs from the unsharded one")
        self.ranks = {"deepseek-moe-16b": {**summary, "loss_rel": d_loss, "gn_rel": d_gn,
                                           "unsharded_ms": one["step_ms"]}}

    # ----------------------------------------------------------- phase 10
    def tp_ranks_of(self, module, prefix: str, cfg) -> list:
        """TP_RANKS copies of ``module`` (named ``prefix.*`` as in a model)
        cut to each model rank's shards under the rules of a 1 x TP_RANKS
        mesh, each marked with its ``tp.Rank`` over one ``LocalComm``."""
        import copy

        comm = LocalComm(1, TP_RANKS)
        specs = param_specs({f"{prefix}.{n}": p.shape for n, p in module.named_parameters()},
                            tp.rules_for(cfg, 1, TP_RANKS))
        out = []
        for m in range(TP_RANKS):
            part = copy.deepcopy(module)
            tp.shard_module_(part, prefix, specs, m, TP_RANKS)
            rank = tp.Rank(comm, m, TP_RANKS, tp.rules_for(cfg, 1, TP_RANKS))
            for sub in part.modules():
                if isinstance(sub, (transformer.DenseBlock, transformer.MoEBlock)):
                    sub.tp = rank
                if isinstance(sub, moe_mod.MoE):
                    sub.comm = comm
            out.append(part)
        return out

    @staticmethod
    def norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return float((a.float() - b.float()).norm() / b.float().norm())

    def tp_check(self, what: str, got: dict, plain: dict, ref: dict) -> None:
        """Each output's (and gradient's) sharded bf16 and unsharded bf16
        distances to float32, norm-wise; the first within TP_RATIO of the
        second."""
        worst = 0.0
        parts = []
        for name in ref:
            d_tp, d_u = self.norm_rel(got[name], ref[name]), self.norm_rel(plain[name], ref[name])
            ratio = d_tp / max(d_u, 1e-30)
            worst = max(worst, ratio)
            parts.append(f"{name} {d_tp:.3e} vs {d_u:.3e}")
            if not ratio <= TP_RATIO:
                raise AssertionError(f"{what} {name}: sharded bf16 {d_tp:.3e} from float32, "
                                     f"unsharded bf16 {d_u:.3e} (ratio {ratio:.3f} > "
                                     f"{TP_RATIO})")
        log(f"[tp {what}] ||bf16 - float32|| / ||float32||, sharded vs unsharded: "
            + "; ".join(parts) + f"; worst ratio {worst:.3f} (allowed {TP_RATIO})")

    def tp_block_chatglm3(self) -> None:
        cfg = get_config("chatglm3-6b")
        gen = torch.Generator(device=self.dev).manual_seed(11)
        block = transformer.DenseBlock(cfg, device=self.dev)
        block.reset_parameters(gen)
        ranks = self.tp_ranks_of(block, "layers.0", cfg)
        b, s = 1, 4096
        acfg = transformer.attn_cfg_for(cfg, None)
        x = torch.randn(b, s, cfg.d_model, generator=gen, device=self.dev)
        dout = torch.randn(b, s, cfg.d_model, generator=gen, device=self.dev)
        pos = torch.arange(s, device=self.dev)[None]
        names = [n for n, _ in block.named_parameters()]

        def unsharded(dtype):
            xi = x.detach().to(dtype).clone().requires_grad_()
            out = block(xi, acfg, pos)
            out.backward(dout.to(dtype))
            grads = {n: p.grad.clone() for n, p in block.named_parameters()}
            block.zero_grad(set_to_none=True)
            return {"out": out.detach(), "dx": xi.grad, **grads}

        ref, plain = unsharded(torch.float32), unsharded(torch.bfloat16)
        xs = [c.detach().requires_grad_() for c in x.to(torch.bfloat16).chunk(TP_RANKS, 1)]
        k3.flash_attention.launches = k3.flash_attention_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = transformer.body_forward(ranks, xs, acfg, pos, sp=True)
        sum((o * g).sum() for o, g in
            zip(outs, dout.to(torch.bfloat16).chunk(TP_RANKS, 1))).backward()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        launches = (k3.flash_attention.launches, k3.flash_attention_bwd.launches)
        if launches != (TP_RANKS, TP_RANKS):
            raise AssertionError(f"chatglm3 TP block: K3 launches {launches}")
        specs = param_specs({f"layers.0.{n}": p.shape for n, p in block.named_parameters()},
                            tp.rules_for(cfg, 1, TP_RANKS))
        comm = LocalComm(1, TP_RANKS)
        got = {"out": torch.cat([o.detach() for o in outs], 1),
               "dx": torch.cat([t.grad for t in xs], 1)}
        for n in names:
            got[n] = tp.whole(comm, [dict(r.named_parameters())[n].grad for r in ranks],
                              specs[f"layers.0.{n}"], grads=True)
        mode = transformer.kv_mode(ranks[0])
        log(f"[tp chatglm3-6b block] B {b} x S {s}, {TP_RANKS} LocalComm ranks on the card, "
            f"H {cfg.n_heads // TP_RANKS} a rank, KV {mode} (2 KV heads: each rank holds "
            f"{cfg.n_kv_heads * cfg.hd // TP_RANKS} of their {cfg.n_kv_heads * cfg.hd} "
            f"columns, gathers them; rank m reads KV head "
            f"{[r.tp.m * (cfg.n_heads // TP_RANKS) // (cfg.n_heads // cfg.n_kv_heads) for r in ranks]}), the "
            f"sequence split in {TP_RANKS}; forward and backward {host * 1e3:.1f} ms host "
            f"time, first call; K3 forward {launches[0]}, backward {launches[1]} launches")
        self.tp_check("chatglm3-6b block", got, plain, ref)
        del block, ranks, xs, outs, got, plain, ref

    def tp_moe_moonshot(self) -> None:
        cfg = get_config("moonshot-v1-16b-a3b")
        mcfg = dataclasses.replace(cfg.moe, capacity_factor=2.0)
        gen = torch.Generator(device=self.dev).manual_seed(12)
        moe = moe_mod.MoE(cfg.d_model, cfg.d_ff, mcfg, cfg.mlp, device=self.dev)
        moe.reset_parameters(gen)
        moe.requires_grad_(False)
        ranks = self.tp_ranks_of(moe, "layers.moe_layers.0.moe", cfg)
        comm = LocalComm(1, TP_RANKS)
        rank_of = [tp.Rank(comm, m, TP_RANKS) for m in range(TP_RANKS)]
        b, s = 1, 2048
        x = torch.randn(b, s, cfg.d_model, generator=gen, device=self.dev)
        routes, orig = [], moe_mod.route
        stats, ep = {}, moe_mod.moe_ffn_ep

        def recording(router, tokens, c):
            routes.append(orig(router, tokens, c))
            return routes[-1]

        def replayed(router, tokens, c):
            return tuple(torch.cat(parts) for parts in zip(*routes[:TP_RANKS]))

        with torch.no_grad():
            moe_mod.route = recording
            moe_mod.moe_ffn_ep = lambda *a, **k: ep(*a, **k, stats=stats)
            try:
                outs, auxs = moe_mod.moe_ranks(ranks, list(x.to(torch.bfloat16).chunk(
                    TP_RANKS, 1)), rank_of, sp=True)
                moe_mod.route = replayed
                plain, _ = moe(x.to(torch.bfloat16))
                ref, ref_aux = moe(x)
            finally:
                moe_mod.route, moe_mod.moe_ffn_ep = orig, ep
        dropped = stats["dropped_send"] + stats["dropped_local"]
        if dropped:
            raise AssertionError(f"moonshot TP MoE at capacity factor 2.0 dropped {dropped}")
        aux_rel = abs(float(auxs[0]) - float(ref_aux)) / abs(float(ref_aux))
        log(f"[tp moonshot-v1-16b-a3b MoE] B {b} x S {s}, {TP_RANKS} LocalComm ranks: each "
            f"rank routes its {s // TP_RANKS} positions to {mcfg.n_experts // TP_RANKS} "
            f"experts a rank (no pair of {stats['pairs']} dropped), the shared experts over "
            f"ff ({cfg.d_ff * mcfg.n_shared // TP_RANKS} columns a rank); aux {float(auxs[0])!r}"
            f" vs float32 {float(ref_aux)!r} (rel {aux_rel:.2e})")
        self.tp_check("moonshot-v1-16b-a3b MoE", {"out": torch.cat(outs, 1)},
                      {"out": plain}, {"out": ref})
        del moe, ranks, outs, plain, ref

    def tp_prefill_moonshot(self) -> None:
        """The slice's main path on the card (module docstring, 10(c))."""
        cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=2)
        one = CausalLM(cfg, device=self.dev, seed=0).requires_grad_(False)
        comm = LocalComm(1, TP_RANKS)
        ranks = tp.split_ranks(one, comm)
        gen = torch.Generator(device=self.dev).manual_seed(13)
        s, max_len, steps = 2048, 2048 + 8, 4
        toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=self.dev)
        calls, attend, routes, orig = [], attn_mod._attend, [], moe_mod.route

        def recording(q, k, v, acfg):
            if not calls:
                calls.append((q, k, v, dict(scale=acfg.scale, softcap=acfg.softcap,
                                            causal=True, window=acfg.window,
                                            prefix_len=acfg.prefix_len)))
            return attend(q, k, v, acfg)

        def routing(router, tokens, c):
            routes.append(orig(router, tokens, c))
            return routes[-1]

        attn_mod._attend, moe_mod.route = recording, routing
        k3.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            logits, caches = prefill_ranks(ranks, [toks] * TP_RANKS, max_len, torch.float32)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            launches = k3.flash_attention.launches
            n_pre = len(routes)
            got, fed, same = [logits[0]], [], all(torch.equal(t, logits[0]) for t in logits)
            for i in range(steps):
                fed.append(got[-1].argmax(-1))
                step, caches = decode_ranks(ranks, [fed[-1]] * TP_RANKS, caches, s + i)
                same = same and all(torch.equal(t, step[0]) for t in step)
                got.append(step[0])
        finally:
            attn_mod._attend, moe_mod.route = attend, orig
        if launches != TP_RANKS * cfg.n_layers:
            raise AssertionError(f"TP prefill launched K3 {launches} times, expected "
                                 f"{TP_RANKS * cfg.n_layers}")
        # the unsharded model replays the ranks' routing: in prefill each
        # rank routed its sequence shard, in decode every rank every token
        groups = [routes[i:i + TP_RANKS] for i in range(0, len(routes), TP_RANKS)]
        replay = [tuple(torch.cat(p) for p in zip(*g)) for g in groups[:n_pre // TP_RANKS]]
        replay += [g[0] for g in groups[n_pre // TP_RANKS:]]

        compute = one.dtype

        def unsharded(dtype):
            it = iter(replay)
            moe_mod.route, one.dtype = (lambda router, tokens, c: next(it)), dtype
            try:
                out, cache = one.prefill(toks, max_len, torch.float32)
                outs = [out]
                for i in range(steps):
                    out, cache = one.decode_step(fed[i], cache, s + i)
                    outs.append(out)
            finally:
                moe_mod.route, one.dtype = orig, compute
            return outs

        plain, ref = unsharded(torch.bfloat16), unsharded(torch.float32)
        names = ["prefill"] + [f"decode {i}" for i in range(steps)]
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        tokens = []
        for name, t, u, r in zip(names, got, plain, ref):
            a, want = int(t.argmax()), int(r.argmax())
            top2 = r.flatten().topk(2).values
            margin = float(top2[0] - top2[1])
            err_u = float((u - r).abs().max())
            tokens.append(f"{name} {a} vs {want} (float32 top-2 margin {margin:.3e}, "
                          f"unsharded bf16 max |err| {err_u:.3e})")
            if a != want and margin > 2 * err_u:
                raise AssertionError(f"TP {name}: greedy token {a}, float32's {want} by a "
                                     f"margin {margin:.3e} > 2 x {err_u:.3e}")
        log(f"[tp moonshot-v1-16b-a3b prefill] full width, {cfg.n_layers} layers (dense + "
            f"MoE), {TP_RANKS} LocalComm ranks on the card: a {s}-token prefill "
            f"{pre_ms:.1f} ms host time (first call), {steps} decode steps fed the TP "
            f"greedy tokens; K3 launches {launches} ({cfg.n_layers} a rank); logits equal on "
            f"every rank: {same}, finite: {finite}; greedy TP vs float32: "
            + "; ".join(tokens))
        if not (same and finite):
            raise AssertionError("the TP serving logits are off")
        self.tp_check("moonshot-v1-16b-a3b serving logits", dict(zip(names, got)),
                      dict(zip(names, plain)), dict(zip(names, ref)))
        q, k, v, kw = calls[0]
        got = k3.flash_attention(q, k, v, **kw)
        ref = k3.flash_attention_ref(q, k, v, **kw)
        err, ratio = k3_error(q, k, v, got, ref, kw)
        if not ratio <= 1.0:
            raise AssertionError(f"K3 at the TP shape: |err| {err:.3e}, {ratio:.3f} of the "
                                 "bound")
        lib_name, lib_fn = library_attention(q, k, v, scale=kw["scale"],
                                             softcap=kw["softcap"], window=kw["window"],
                                             prefix_len=kw["prefix_len"])
        ms = time_ms(lambda: k3.flash_attention(q, k, v, **kw), 50,
                     label="K3 moonshot TP rank S=2048 H=KVH=4 hd=128")
        plain_ms = time_ms(lambda: k3.flash_attention_ref(q, k, v, **kw), 20,
                           label="K3 plain")
        lib_ms = time_ms(lib_fn, 50, label=lib_name)
        hq, hd = q.shape[2], q.shape[3]
        flops, nbytes = k3.flash_attention_cost(q.shape[0], q.shape[1], k.shape[1], hq,
                                                k.shape[2], hd, q.element_size())
        bms, by = bound_ms(nbytes, flops, q.dtype)
        blocks = q.shape[0] * hq * -(-q.shape[1] // 128)
        self.kernels["flash_attention_tp"] = {
            "name": "flash_attention_tp", "route": "cuda", "source": f"{SOURCE}/flash_attn.cu",
            "replaces": "src/repro/kernels/flash.py:70", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms, "model": cfg.name,
            "launches_per_request": {"prefill": launches / TP_RANKS, "decode": 0}}
        log(f"[K3 moonshot TP rank] {tuple(q.shape)} {q.dtype}: |err| {err:.3e} "
            f"({ratio:.3f} of the bound), {ms:.4f} ms/launch (bound {bms:.4f} ms by {by}, "
            f"{bms / ms:.4f} of it), plain {plain_ms:.3f} ms, {lib_name} {lib_ms:.4f} ms "
            f"(K3 takes {ms / lib_ms:.2f}x); {blocks} blocks of 128 rows a launch on "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
        del one, ranks, logits, caches, calls, got, ref, plain

    # ----------------------------------------------------------- phase 11
    def tp_family(self, arch: str, layers: int) -> None:
        """The families placed across ranks in this slice on TP_RANKS
        ``LocalComm`` ranks on the card (module docstring, phase 11)."""
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        one = CausalLM(cfg, device=self.dev, seed=0)
        if cfg.family == "hybrid":         # the LoRA's b starts at 0: draw it
            gen = torch.Generator(device=self.dev).manual_seed(14)
            with torch.no_grad():
                for lora in one.layers["lora"]:
                    for delta in lora.values():
                        delta.b.normal_(0.0, 0.02, generator=gen)
        comm = LocalComm(1, TP_RANKS)
        ranks = tp.split_ranks(one, comm)
        gen = torch.Generator(device=self.dev).manual_seed(15)
        vlm, audio = cfg.family == "vlm", cfg.family == "audio"
        s = TP_FAMILY_SEQ
        text = s - (cfg.prefix_tokens if vlm else 0)
        k = (cfg.num_codebooks,) if audio else ()
        toks = torch.randint(0, cfg.vocab_size, (1, text + 1) + k, generator=gen,
                             device=self.dev)
        tokens, labels = toks[:, :-1].contiguous(), toks[:, 1:].clone()
        labels[:, -1] = -1
        prefix = (torch.randn(1, cfg.prefix_tokens, cfg.d_model, generator=gen,
                              device=self.dev) if vlm else None)
        calls, attend = [], attn_mod._attend

        def recording(q, k_, v, acfg):
            if not calls:
                calls.append((q.detach(), k_.detach(), v.detach(),
                              dict(scale=acfg.scale, softcap=acfg.softcap, causal=True,
                                   window=acfg.window, prefix_len=acfg.prefix_len)))
            return attend(q, k_, v, acfg)

        # training: the ranks' forward and backward, then the unsharded model
        # in bf16 and in float32 on the same weights
        attn_calls = attention_calls(cfg)
        attn_mod._attend = recording
        k3.flash_attention.launches = k3.flash_attention_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            outs = loss_ranks(ranks, [tokens] * TP_RANKS, [labels] * TP_RANKS,
                              None if prefix is None else [prefix] * TP_RANKS)
            sum(o[0] for o in outs).backward()
        finally:
            attn_mod._attend = attend
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        launches = (k3.flash_attention.launches, k3.flash_attention_bwd.launches)
        want = (2 * attn_calls * TP_RANKS, attn_calls * TP_RANKS)
        if launches != want:
            raise AssertionError(f"{arch} TP train: K3 launches {launches}, expected {want}")
        specs = param_specs({n: p.shape for n, p in one.named_parameters()},
                            tp.rules_for(cfg, 1, TP_RANKS))
        got = {"loss": outs[0][0].detach()}
        for n, _ in one.named_parameters():
            got[n] = tp.whole(comm, [dict(r.named_parameters())[n].grad for r in ranks],
                              specs[n], grads=True)
        for r in ranks:
            r.zero_grad(set_to_none=True)
        compute = one.dtype

        def unsharded_train(dtype):
            one.dtype = dtype
            try:
                loss, _ = one.loss(tokens, labels, prefix_embeds=prefix)
                loss.backward()
            finally:
                one.dtype = compute
            res = {"loss": loss.detach(), **{n: p.grad.clone()
                                             for n, p in one.named_parameters()}}
            one.zero_grad(set_to_none=True)
            return res

        plain, ref = unsharded_train(torch.bfloat16), unsharded_train(torch.float32)
        zero = sorted(n for n in ref if n != "loss" and float(ref[n].norm()) == 0.0)
        for d in (got, plain, ref):
            for n in zero:
                d.pop(n)
        # the loss is one number: held to float32's within 1e-3 relative
        # (phase 9's bound for a ranked step), the gradients norm-wise
        losses = {n: float(d.pop("loss")) for n, d in (("tp", got), ("plain", plain),
                                                       ("ref", ref))}
        loss_rel = abs(losses["tp"] - losses["ref"]) / abs(losses["ref"])
        if not loss_rel <= 1e-3:
            raise AssertionError(f"{arch} TP train loss {losses['tp']!r}, float32's "
                                 f"{losses['ref']!r} (rel {loss_rel:.2e} > 1e-3)")
        log(f"[tp {arch} train] full width, {layers} layers, {TP_RANKS} LocalComm ranks on "
            f"the card, B 1 x S {s} (the sequence split in {TP_RANKS}): forward and backward "
            f"{host * 1e3:.1f} ms host time, first call; K3 forward {launches[0]}, backward "
            f"{launches[1]} launches; loss {losses['tp']!r} vs unsharded bf16 "
            f"{losses['plain']!r}, float32 {losses['ref']!r} (rel {loss_rel:.2e}, "
            f"tolerance 1e-3); {len(got)} gradients held"
            + (f" (float32's zero: {zero})" if zero else ""))
        self.tp_check(f"{arch} train", got, plain, ref)
        del got, plain, ref, outs
        if calls:
            self.k3_tp_shape(arch, cfg, *calls[0])
        calls.clear()

        # serving: the ranks' prefill and greedy decode steps against the
        # unsharded model fed the same tokens
        one.requires_grad_(False)
        for r in ranks:
            r.requires_grad_(False)
        max_len, steps = s + 8, 4
        k3.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill_ranks(ranks, [tokens] * TP_RANKS, max_len, torch.float32,
                                       None if prefix is None else [prefix] * TP_RANKS)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        pre_launches = k3.flash_attention.launches
        if pre_launches != attn_calls * TP_RANKS:
            raise AssertionError(f"{arch} TP prefill launched K3 {pre_launches} times, "
                                 f"expected {attn_calls * TP_RANKS}")
        if calls:
            raise AssertionError("recording left on")
        outs, fed, same = [logits[0]], [], all(torch.equal(t, logits[0]) for t in logits)
        for i in range(steps):
            fed.append(outs[-1][:, -1:].argmax(-1))
            step, caches = decode_ranks(ranks, [fed[-1]] * TP_RANKS, caches, s + i)
            same = same and all(torch.equal(t, step[0]) for t in step)
            outs.append(step[0])
        shapes = {tuple(v.shape) for c in caches[:1] for v in _cache_leaves(c)}

        def unsharded_serve(dtype):
            one.dtype = dtype
            try:
                out, cache = one.prefill(tokens, max_len, torch.float32, prefix_embeds=prefix)
                res = [out]
                for i in range(steps):
                    out, cache = one.decode_step(fed[i], cache, s + i)
                    res.append(out)
            finally:
                one.dtype = compute
            return res

        plain, ref = unsharded_serve(torch.bfloat16), unsharded_serve(torch.float32)
        names = ["prefill"] + [f"decode {i}" for i in range(steps)]
        finite = all(bool(torch.isfinite(t).all()) for t in outs)
        greedy = []
        for name, t, u, r in zip(names, outs, plain, ref):
            v = cfg.vocab_size
            for row, (a, w, rr, uu) in enumerate(zip(t.reshape(-1, v).argmax(-1),
                                                      r.reshape(-1, v).argmax(-1),
                                                      r.reshape(-1, v), u.reshape(-1, v))):
                top2 = rr.topk(2).values
                margin, err_u = float(top2[0] - top2[1]), float((uu - rr).abs().max())
                if int(a) != int(w) and margin > 2 * err_u:
                    raise AssertionError(f"{arch} TP {name} row {row}: greedy token {int(a)}, "
                                         f"float32's {int(w)} by a margin {margin:.3e} > 2 x "
                                         f"{err_u:.3e}")
                greedy.append(int(a) == int(w))
        log(f"[tp {arch} serve] {TP_RANKS} LocalComm ranks: a {s}-position prefill "
            f"{pre_ms:.1f} ms host time (first call; K3 launches {pre_launches}, "
            f"{attn_calls} a rank) and {steps} greedy decode steps; logits equal on every "
            f"rank: {same}, finite: {finite}; greedy TP tokens equal float32's in "
            f"{sum(greedy)} of {len(greedy)} (the others within twice the unsharded bf16 "
            f"model's own error of a tie); a rank's cache leaves {sorted(shapes)}")
        if not (same and finite):
            raise AssertionError(f"the {arch} TP serving logits are off")
        self.tp_check(f"{arch} serving logits", dict(zip(names, outs)),
                      dict(zip(names, plain)), dict(zip(names, ref)))
        key = f"flash_attention_tp_{arch.split('-')[0]}"
        if key in self.kernels:
            self.kernels[key]["launches"] = pre_launches
            self.kernels[key]["launches_per_request"] = {"prefill": pre_launches / TP_RANKS,
                                                         "decode": 0}
        self.tp_launches[arch] = pre_launches
        del one, ranks, logits, caches, outs, plain, ref

    def k3_tp_shape(self, arch: str, cfg, q, k, v, kw) -> None:
        """K3 and its backward at one rank's shape of ``arch`` under tensor
        parallelism (the first attention call of the ranks' training
        forward), each against its plain version and timed (medians, behind
        a spin kernel) beside SDPA's and its bound; the forward fills a
        kernels-line entry."""
        got = k3.flash_attention(q, k, v, **kw)
        want = k3.flash_attention_ref(q, k, v, **kw)
        err, ratio = k3_error(q, k, v, got, want, kw)
        if not ratio <= 1.0:
            raise AssertionError(f"K3 at {arch}'s TP rank shape: |err| {err:.3e}, "
                                 f"{ratio:.3f} of the bound")
        lib_name, lib_fn = library_attention(q, k, v, scale=kw["scale"], softcap=kw["softcap"],
                                             window=kw["window"], prefix_len=kw["prefix_len"])
        s, hq, hd = q.shape[1], q.shape[2], q.shape[3]
        label = (f"{arch} TP rank S={s} H={hq} KVH={k.shape[2]} hd={hd}"
                 + (f" prefix={kw['prefix_len']}" if kw["prefix_len"] else ""))
        ms = time_ms(lambda: k3.flash_attention(q, k, v, **kw), 50, label=f"K3 {label}")
        lib_ms = time_ms(lib_fn, 50, label=lib_name)
        plain_ms = time_ms(lambda: k3.flash_attention_ref(q, k, v, **kw), 20,
                           label="K3 plain")
        shape = (q.shape[0], s, k.shape[1], hq, k.shape[2], hd, q.element_size())
        flops, nbytes = k3.flash_attention_cost(*shape, prefix_len=kw["prefix_len"])
        bms, by = bound_ms(nbytes, flops, q.dtype)
        key = f"flash_attention_tp_{arch.split('-')[0]}"
        self.kernels[key] = {
            "name": key, "route": "cuda", "source": f"{SOURCE}/flash_attn.cu",
            "replaces": "src/repro/kernels/flash.py:70", "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms, "model": arch}
        log(f"[K3 {label}] {q.dtype}: |err| {err:.3e} ({ratio:.3f} of the bound), {ms:.4f} "
            f"ms/launch (bound {bms:.4f} ms by {by}, {bms / ms:.4f} of it), plain "
            f"{plain_ms:.3f} ms, {lib_name} {lib_ms:.4f} ms (K3 takes {ms / lib_ms:.2f}x)")
        dout = torch.randn(q.shape, device=self.dev, generator=torch.Generator(
            device=self.dev).manual_seed(16)).to(q.dtype)
        bkw = {n: kw[n] for n in ("scale", "softcap", "window", "prefix_len")}
        out, lse = k3.flash_attention(q, k, v, return_lse=True, **bkw)
        grads = k3.flash_attention_bwd(q, k, v, out, dout, lse, **bkw)
        wants = k3.flash_attention_bwd_ref(q, k, v, out, dout, **bkw)
        bounds = k3.error_bound_bwd(q, k, v, out, dout, wants, **bkw)
        worst = max(bound_ratio(g.float() - w.float(), bd)
                    for g, w, bd in zip(grads, wants, bounds))
        norm = max(float((g.float() - w.float()).norm() / w.float().norm())
                   for g, w in zip(grads, wants))
        if not (worst <= 1.0 and norm <= K3_BWD_NORM_REL):
            raise AssertionError(f"K3 bwd at {arch}'s TP rank shape: {worst:.3f} of the "
                                 f"bound, norm-wise {norm:.3e}")
        lib_name, lib_bwd = library_attention_bwd(q, k, v, dout, **bkw)
        b_ms = time_ms(lambda: k3.flash_attention_bwd(q, k, v, out, dout, lse, **bkw), 50,
                       label=f"K3 bwd {label}")
        b_lib = time_ms(lib_bwd, 20, label=f"{lib_name} backward")
        b_flops, b_bytes = k3.flash_attention_bwd_cost(*shape, prefix_len=kw["prefix_len"])
        b_bms, b_by = bound_ms(b_bytes, b_flops, q.dtype)
        self.k3_bwd_tp[arch] = {"ms": b_ms, "library_ms": b_lib, "bound_ms": b_bms,
                                "bound_by": b_by, "shape": label, "worst_of_bound": worst}
        log(f"[K3 bwd {label}] worst |err| / bound {worst:.3f}, norm-wise {norm:.3e} (limit "
            f"{K3_BWD_NORM_REL}); {b_ms:.4f} ms/launch, {lib_name}'s backward {b_lib:.4f} ms "
            f"(the kernel takes {b_ms / b_lib:.2f}x); bound {b_bms:.4f} ms by {b_by} "
            f"({b_bms / b_ms:.4f} of it)")
        del got, want, out, lse, grads, wants, bounds, dout

    def tp_families(self) -> None:
        """Phase 11: each family of ``TP_FAMILIES`` across TP_RANKS ranks,
        then the ranked 1 x 1 step with microbatches and int8."""
        for arch, layers in TP_FAMILIES:
            t1 = time.perf_counter()
            self.tp_family(arch, layers)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"[tp {arch}] {time.perf_counter() - t1:.1f} s")
        if "flash_attention_bwd" in self.kernels:
            self.kernels["flash_attention_bwd"]["tp_layers"] = self.k3_bwd_tp
        self.micro_int8_ranked_1x1()

    def micro_int8_ranked_1x1(self) -> None:
        """A ranked 1 x 1 step (``dist.zero.ranked_lm``, one NCCL rank,
        spawned) with microbatches and int8 compression against the
        unsharded step with the same microbatches and compressor, in this
        process: loss, grad norm and every parameter after the step bit for
        bit (``tools.train_ranks.step_digest``)."""
        run = RankRun("chatglm3-6b", 1, 1, 2, 1024, 0, 0, layers=2, microbatches=2,
                      compress="int8")
        t0 = time.perf_counter()
        ranked = spawn_ranks(step_digest, 1, 1, "cuda", run, timeout=600)[0]
        one = step_digest(run)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[ranks microbatches int8 1x1] chatglm3-6b at full width and 2 layers, 2 x 1024 "
            f"tokens in 2 microbatches, int8 compression: ranked 1 x 1 {ranked} vs unsharded "
            f"{one}; {time.perf_counter() - t0:.1f} s")
        if ranked != one:
            raise AssertionError("the ranked 1 x 1 step with microbatches and int8 is not the "
                                 "unsharded step bit for bit")

    def examples_main(self) -> None:
        """The four example twins, each in its own process (module
        docstring, 10(d))."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        for script, args, limit in EXAMPLES:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch" / script),
                                   *args], env=env, cwd=ROOT, capture_output=True,
                                  text=True, timeout=limit)
            lines = proc.stdout.strip().splitlines()
            last = lines[-1] if lines else ""
            nums = [float(v) for v in re.findall(
                r"[-+]?(?:\d+\.\d*|\d+|nan|inf)(?:e[-+]?\d+)?", last.replace(",", ""))]
            ok = proc.returncode == 0 and nums and all(np.isfinite(nums))
            log(f"[example {script}] exit {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s; last line: {last}")
            if not ok:
                raise AssertionError(f"examples/torch/{script}: exit {proc.returncode}, "
                                     f"last line {last!r}\n{proc.stderr[-2000:]}")

    def ssd_decay_range(self, model, cfg, batch) -> None:
        """The largest dt A of one forward over a training batch, over every
        Mamba2 layer and head: ``ssd_chunked`` takes log(a) of a = exp(-dt
        A), which underflows to 0 in float32 (log -inf) once dt A passes
        ~103 (ROADMAP §3)."""
        nh = model.layers["mamba"][0].ssm.a_log.shape[0]
        worst = []

        def hook(layer, args):
            ssm = layer.ssm
            h = rms_norm(args[0], layer.norm, cfg.norm_eps)     # the layer's pre-norm
            proj = h @ ssm.cast("in_proj", h.dtype)[:, -nh:]
            dt = torch.nn.functional.softplus(proj.float() + ssm.dt_bias.float())
            worst.append(float((dt * torch.exp(ssm.a_log.float())).max()))

        handles = [layer.register_forward_pre_hook(hook) for layer in model.layers["mamba"]]
        with torch.no_grad():
            model.forward_hidden(torch.as_tensor(batch["tokens"], device=self.dev))
        for handle in handles:
            handle.remove()
        if len(worst) != cfg.n_layers:
            raise AssertionError(f"the dt x A hooks saw {len(worst)} of {cfg.n_layers} "
                                 "Mamba2 layers")
        log(f"[train {cfg.name} SSD] largest dt x A over {len(worst)} Mamba2 layers of "
            f"one forward after the timed steps: {max(worst):.2f} (float32 exp(-dt A) "
            "underflows to 0 past ~103)")

    def profile_train(self, step_fn, opt, batch, step, run, step_ms) -> None:
        """One train step under ``torch.profiler``: the device idle share
        against the unprofiled step time, and K3's forward and backward
        shares of the device's busy time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_fn(opt, batch, step)
            torch.cuda.synchronize()
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events() if e.device_type == DeviceType.CUDA)
        if not dev:
            log(f"[profile train {run.arch}] the profiler saw no device time: idle "
                "share not measured")
            return
        busy_ms = busy_us(dev) / 1e3
        fwd_ms = sum(b - a for a, b, n in dev if K3_FWD_NAME in n) / 1e3
        bwd_ms = sum(b - a for a, b, n in dev if K3_BWD_NAME in n) / 1e3
        parts = {}
        for a, b, n in dev:
            if K3_BWD_NAME in n:
                part = re.sub(r"[<(].*", "", n).split("::")[-1]
                parts[part] = parts.get(part, 0.0) + (b - a) / 1e3
        log(f"[profile train {run.arch}] one step: {len(dev)} device ops, device busy "
            f"{busy_ms:.2f} ms of {step_ms:.2f} ms unprofiled (idle share "
            f"{1 - busy_ms / step_ms:.4f}); K3 forward {fwd_ms:.2f} ms = "
            f"{fwd_ms / busy_ms:.4f} and backward {bwd_ms:.2f} ms = {bwd_ms / busy_ms:.4f} "
            "of device busy time (backward by kernel, ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + ")")

    def audio_serve_check(self, model, cfg) -> None:
        """musicgen's model-level prefill and decode steps with (B, 1, K)
        tokens (``ServeEngine`` refuses the audio family, ROADMAP F6): the
        logits must be finite and (B, 1, K, V)."""
        b, prompt, k, v = 2, 1024, cfg.num_codebooks, cfg.vocab_size
        gen = torch.Generator(device=self.dev).manual_seed(0)
        toks = torch.randint(0, v, (b, prompt, k), generator=gen, device=self.dev)
        logits, cache = model.prefill(toks, prompt + 8, torch.float32)
        shapes = [tuple(logits.shape)]
        finite = bool(torch.isfinite(logits).all())
        for i in range(4):
            tok = logits[:, -1].argmax(-1)[:, None]             # (B, 1, K)
            logits, cache = model.decode_step(tok, cache, prompt + i)
            shapes.append(tuple(logits.shape))
            finite &= bool(torch.isfinite(logits).all())
        if not finite or set(shapes) != {(b, 1, k, v)}:
            raise AssertionError(f"musicgen prefill/decode logits {shapes}, finite {finite}")
        log(f"[serve {cfg.name}] model-level prefill of {b} x {prompt} x {k} tokens and 4 "
            f"decode steps with (B, 1, {k}) tokens: logits {shapes[0]}, finite")
        del cache, logits


    # ------------------------------------------------------- phase [dryrun]
    def dryrun_lbm(self, case) -> None:
        """(a) The dry-run of the main spheres case, one slab on the meta
        device (``ShardedLBM.count_step``), f64 and f32: its t_memory,
        t_compute and bound beside phase 3's measured ms a step.  K1's
        counted bytes must be those the kernels line's bound divides, and
        no measured step may beat its bound by more than 5 %."""
        for dtype in ("float64", "float32"):
            t0 = time.perf_counter()
            cfg = LBMConfig(collision=C.CollisionConfig(tau=0.6), dtype=dtype,
                            boundaries=case.boundaries, periodic=case.periodic,
                            backend="fused")
            eng = ShardedLBM(case.geometry, cfg, slabs=1, devices="meta")
            (c,) = eng.count_step()
            count_s = time.perf_counter() - t0
            _, k1_flops, k1_bytes = c.kernels["stream_collide_tiles"]
            if k1_bytes != self.k1_bytes[dtype]:
                raise AssertionError(f"[dryrun LBM {dtype}] K1 counted {k1_bytes} B, the "
                                     f"kernels line's bound divides {self.k1_bytes[dtype]} B")
            t_mem = c.bytes / HBM_BYTES_PER_S * 1e3
            t_cmp = c.flops / PEAK_FLOPS[eng.dtype] * 1e3
            bound, measured = max(t_mem, t_cmp), self.sharded[(dtype, 1)]["ms_per_step"]
            log(f"[dryrun LBM {dtype}] spheres scale 4 fused, one slab counted on the meta "
                f"device in {count_s:.1f} s: {c.flops:.6e} FLOPs, {c.bytes:.6e} B a step "
                f"(K1 {k1_bytes:.0f} B = the kernels line's, the NEBB pass "
                f"{c.bytes - k1_bytes:.6e} B in {sum(r[0] for n, r in c.by_op.items() if n != 'stream_collide_tiles')} "
                f"ops); t_memory {t_mem:.4f} ms, t_compute {t_cmp:.4f} ms, bound {bound:.4f} "
                f"ms; measured (phase 3) {measured:.4f} ms a step: bound / measured "
                f"{bound / measured:.4f}")
            if bound / measured > DRYRUN_SLACK:
                raise AssertionError(f"[dryrun LBM {dtype}] the measured step ({measured:.4f} "
                                     f"ms) beats its counted bound ({bound:.4f} ms)")
            del eng, c

    def dryrun_lm(self) -> None:
        """(b) starcoder2-3b's training step at 2 x 4096 on one card: counted
        on the meta device (``launch.dryrun.count_cell`` on a 1 x 1 mesh),
        then a real step counted on the card under the same counter.  FLOPs
        and bytes agree to 1 % (every op that differs is named), the
        predicted peak is within 10 % of ``max_memory_allocated``, and the
        counted bound is no more than 5 % above the measured step.  (c) One
        decode step of ``ServeEngine(slots=4)`` on the same weights against
        the counted decode's t_memory."""
        arch, run = "starcoder2-3b", TRAIN_RUNS[0]
        cfg = get_config(arch)
        one = MeshSpec((1, 1), ("data", "model"))
        t0 = time.perf_counter()
        meta = count_cell(arch, "train", one, shape=ShapeSpec("train", "train", run.seq,
                                                                run.batch), verbose=False)
        meta_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = CausalLM(cfg, seed=0)
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        opt = init_state(params)
        step_fn = make_train_step(model, AdamWConfig())
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq,
                                        global_batch=run.batch, seed=0))
        batches = [pipe.next() for _ in range(4)]
        opt, _ = step_fn(opt, batches[0], 0)              # warm-up: kernels loaded
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for i in (1, 2):
            start.record()
            opt, _ = step_fn(opt, batches[i], i)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        step_ms = float(np.median(times))
        torch.cuda.reset_peak_memory_stats()
        with Counter() as real:
            real.resident([list(params.values()), opt["m"], opt["v"]])
            opt, _ = step_fn(opt, batches[3], 3)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        diffs = differences(meta["by_op"], real.by_op)
        rel_f = abs(meta["flops_per_device"] - real.flops) / real.flops
        rel_b = abs(meta["bytes_per_device"] - real.bytes) / real.bytes
        rel_p = abs(meta["hbm_need"] - peak) / peak
        bound = max(meta["t_compute"], meta["t_memory"]) * 1e3
        log(f"[dryrun train {arch}] {run.batch} x {run.seq}, one card: counted on meta in "
            f"{meta_s:.1f} s: {meta['flops_per_device']:.6e} FLOPs, "
            f"{meta['bytes_per_device']:.6e} B, peak {meta['hbm_need'] / 2**30:.3f} GiB; "
            f"the card's step under the counter: {real.flops:.6e} FLOPs ({rel_f:.2e} apart), "
            f"{real.bytes:.6e} B ({rel_b:.2e} apart), counter peak {real.peak / 2**30:.3f} "
            f"GiB, max_memory_allocated {peak / 2**30:.3f} GiB (the meta peak {rel_p:.3f} "
            f"apart); ops that differ: {diffs or 'none'}; t_compute "
            f"{meta['t_compute'] * 1e3:.2f} ms, t_memory {meta['t_memory'] * 1e3:.2f} ms, "
            f"measured {step_ms:.2f} ms a step (median of {len(times)}): bound / measured "
            f"{bound / step_ms:.4f}; useful FLOPs ratio {meta['useful_flops_ratio']:.4f}")
        if rel_f > 0.01 or rel_b > 0.01:
            raise AssertionError(f"[dryrun train] meta and card counts differ: {diffs}")
        if rel_p > 0.10:
            raise AssertionError(f"[dryrun train] peak {meta['hbm_need']} vs {peak}")
        if bound / step_ms > DRYRUN_SLACK:
            raise AssertionError(f"[dryrun train] step {step_ms} ms beats its bound {bound}")
        del opt, step_fn, params, real
        gc.collect()
        torch.cuda.empty_cache()

        # (c) a decode step of the server on the same weights
        model.requires_grad_(False)
        serve = SERVE_RUNS[0]
        eng = ServeEngine(model, serve.slots, serve.max_len)
        rng = np.random.default_rng(5)
        for rid in range(serve.slots):
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, serve.prompt,
                                                            dtype=np.int32),
                               max_new_tokens=serve.new))
        eng.step()                                  # admits every slot, one decode
        eng.step()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            start.record()
            eng.step()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        dec_ms = float(np.median(times))
        dec = count_cell(arch, "decode", one, shape=ShapeSpec(
            "decode", "decode", serve.max_len, serve.slots), cache_dtype=eng.cache_dtype,
            verbose=False)
        t_mem = dec["t_memory"] * 1e3
        log(f"[dryrun decode {arch}] ServeEngine(slots={serve.slots}), max_len "
            f"{serve.max_len}, {str(eng.cache_dtype)[6:]} cache: counted "
            f"{dec['bytes_per_device']:.6e} B, {dec['flops_per_device']:.6e} FLOPs a step, "
            f"t_memory {t_mem:.4f} ms, t_compute {dec['t_compute'] * 1e3:.4f} ms; measured "
            f"{dec_ms:.4f} ms a step (median of 5 engine steps): t_memory / measured "
            f"{t_mem / dec_ms:.4f}")
        if t_mem / dec_ms > DRYRUN_SLACK:
            raise AssertionError(f"[dryrun decode] step {dec_ms} ms beats t_memory {t_mem}")
        del eng, model

    def dryrun_main(self) -> None:
        t1 = time.perf_counter()
        self.dryrun_lbm(launcher.make_case("spheres", 4))
        gc.collect()
        torch.cuda.empty_cache()
        self.dryrun_lm()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[dryrun] phase in {time.perf_counter() - t1:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # flex_attention's compiled kernels (the gemma2 library yardstick) go
    # under the checkout's build/, as K1-K3's do
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "torchinductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    smoke.build_kernels()
    smoke.check_k1_small()
    smoke.check_k2_small()
    smoke.main_path()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    smoke.sharded_main()
    log(f"[sharded] phase in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    smoke.sim_main()
    log(f"[sim] phase in {time.perf_counter() - t1:.1f} s")
    smoke.check_k3_matrix()
    smoke.check_k3_masks()
    smoke.check_k3_hd80()
    for run in SERVE_RUNS:
        t1 = time.perf_counter()
        smoke.serve_main(run)
        gc.collect()                     # free this model before the next one
        torch.cuda.empty_cache()
        log(f"[serve {run.arch}] phase in {time.perf_counter() - t1:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left allocated")
    t1 = time.perf_counter()
    smoke.check_k3_bwd_matrix()
    smoke.k3_bwd_main_shapes()
    for run in TRAIN_RUNS:
        smoke.train_main(run)
        gc.collect()
        torch.cuda.empty_cache()
    smoke.kernel_line_bwd()
    log(f"[train] phase in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    smoke.ep_at_deepseek_width()
    gc.collect()
    torch.cuda.empty_cache()
    smoke.ranked_train()
    log(f"[ranks] phase in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    for part in (smoke.tp_block_chatglm3, smoke.tp_moe_moonshot, smoke.tp_prefill_moonshot):
        part()
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[tp] phase in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    smoke.examples_main()
    log(f"[examples] phase in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    smoke.tp_families()
    log(f"[tp families] phase in {time.perf_counter() - t1:.1f} s")
    smoke.dryrun_main()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
