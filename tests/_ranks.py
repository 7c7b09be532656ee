"""Helpers of the port's multi-rank tests: a program run as W ranks (gloo
on the CPU, NCCL on cards), one subprocess each, under one timeout (a rank
that misses a collective would otherwise hang the others until the
backend's own timeout)."""
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.launch.train import free_address

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(prog: str, world: int, *args, timeout: float = 120) -> None:
    """Run ``prog`` (``python -c``, from the repository root) as ranks
    0..world-1; each gets argv ``rank world tcp-address *args`` and must
    print ``RANK_OK``."""
    addr = free_address()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(r), str(world), addr,
                               *map(str, args)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in so, f"rank {r}:\n{so[-2000:]}\n{se[-4000:]}"


# ------------------------------------------------- training across gloo ranks
def smoke_cfg(arch: str):
    """The arch's smoke config in float32, at a capacity factor that
    drops no (token, choice) pair for a MoE."""
    import dataclasses

    from repro_torch.configs import get_smoke

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
BATCH, SEQ, STEPS = 4, 32, 3


def pipeline(cfg, rank: int = 0, ranks: int = 1):
    from repro_torch.data.tokens import DataConfig, TokenPipeline

    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH, seed=0), shard=rank, num_shards=ranks)


def trajectory(model, cfg, out: Path, ckpt: str, resume: str | None = None,
               rank: int = 0, ranks: int = 1) -> dict:
    """The run every test holds a mesh to: the step-0 loss and whole
    gradients of one backward; ``STEPS`` AdamW steps (metrics); a
    checkpoint to ``out/ckpt`` at step ``STEPS``; step ``STEPS`` (metrics)
    and the whole parameters after it.  With ``resume`` (a checkpoint dir
    of another mesh), a model restored from it takes step ``STEPS`` too
    (metrics, parameters after).  Across ranks the whole tensors are
    gathered and returned on rank 0 (None elsewhere)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.launch.train import save_checkpoint
    from repro_torch.optim.adamw import init_state

    place = model.placement
    pipe = pipeline(cfg, *_row(model))
    batches = [pipe.next() for _ in range(STEPS + 1)]
    b0 = batches[0]
    loss, _ = model.loss(torch.as_tensor(b0["tokens"]).long(), torch.as_tensor(b0["labels"]))
    loss.backward()
    if place is not None:
        place.sync_grads(dict(model.named_parameters()))
    loss = loss.detach()
    grads = {}
    for name, p in model.named_parameters():
        grads[name] = (p.grad if place is None else place.full(name, p.grad)).clone()
        p.grad = None
    if place is not None:
        dist.all_reduce(loss)
        loss /= ranks
    res = {"loss0": float(loss), "grads0": grads}

    opt, res["steps"] = _steps(model, init_state(dict(model.named_parameters())),
                               batches, 0, STEPS)
    save_checkpoint(CheckpointStore(str(out / ckpt)), STEPS, model, opt, {"step": STEPS},
                    wait=True)
    opt, res["last"] = _steps(model, opt, batches, STEPS, STEPS + 1)
    res["params"] = lm_params_to_reference(model)
    if resume is not None:
        if place is None:
            other = type(model)(cfg, device="cpu", seed=None)
        else:
            from repro_torch.dist.zero import ranked_lm

            other = ranked_lm(cfg, place.mesh, seed=None)
        res["resumed_last"], res["resumed_params"] = resumed_step(other, cfg, out / resume,
                                                                  rank, ranks)
    return res if rank == 0 else None


def _row(model):
    """(data row, data rows) of a model's rank: the batch goes over "data"."""
    place = model.placement
    return (0, 1) if place is None else (place.data_rank, place.data)


def _steps(model, opt, batches, first, last):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    step_fn = make_train_step(model, AdamWConfig(**OPT))
    metrics = []
    for i in range(first, last):
        opt, m = step_fn(opt, batches[i], i)
        metrics.append({k: float(v) for k, v in m.items()})
    return opt, metrics


def resumed_step(model, cfg, ckpt: Path, rank: int = 0, ranks: int = 1):
    """``model`` (no weights yet) restored from the checkpoint at step
    ``STEPS`` in ``ckpt``, then that step: (its metrics, the parameters
    after it, whole)."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.launch.train import restore_checkpoint
    from repro_torch.optim.adamw import init_state

    opt = init_state(dict(model.named_parameters()))
    extra = restore_checkpoint(CheckpointStore(str(ckpt)), STEPS, model, opt)
    assert extra["step"] == STEPS and int(opt["count"]) == STEPS
    pipe = pipeline(cfg, *_row(model))
    batches = [pipe.next() for _ in range(STEPS + 1)]
    _, metrics = _steps(model, opt, batches, STEPS, STEPS + 1)
    return metrics, lm_params_to_reference(model)


TRAIN_PROG = r"""
import sys, datetime
from pathlib import Path
import torch, torch.distributed as dist
sys.path.insert(0, "tests")
import _ranks as R
from repro_torch.dist.zero import ranked_lm
from repro_torch.launch.mesh import make_lm_mesh
rank, world, addr, out, arch, data, model = sys.argv[1:8]
rank, world, data, model, out = int(rank), int(world), int(data), int(model), Path(out)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
cfg = R.smoke_cfg(arch)
lm = ranked_lm(cfg, make_lm_mesh(data, model, "cpu"), seed=0)
res = R.trajectory(lm, cfg, out, f"ck_{data}x{model}", resume="ck_one", rank=rank,
                   ranks=world)
if rank == 0:
    torch.save(res, out / f"ranks_{data}x{model}.pt")
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import make_train_step
for kw in ({"microbatches": 2}, {"compressor": object()}):
    try:
        make_train_step(lm, AdamWConfig(), **kw)
    except ValueError:
        continue
    raise SystemExit(f"make_train_step across ranks took {kw}")
dist.destroy_process_group()
print("RANK_OK")
"""


# --------------------------------------- ranks for launch.train.spawn_ranks
def rank_and_size(mesh):
    """A rank function: (rank, mesh size)."""
    import torch.distributed as dist

    return dist.get_rank(), mesh.size()


def stall_on_rank_1(mesh):
    """A rank function where rank 1 never reaches the collective."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(600)
    dist.barrier()


def fail_on_rank_1(mesh):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
