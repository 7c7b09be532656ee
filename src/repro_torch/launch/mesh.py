"""Meshes over the visible cards (the port of ``repro.launch.mesh``).

* :func:`make_host_mesh`: the list of devices that
  :class:`repro_torch.dist.lbm.ShardedLBM` places its slabs on, slab d on
  ``mesh[d]``.
* :func:`make_lm_mesh`: the LM's ("data", "model") mesh over the ranks of a
  ``torch.distributed`` world, one rank per card (the reference's
  ``make_host_mesh(model_axis)``; the rules of ``repro_torch.dist.sharding``
  map onto its axes).

The reference's production meshes (TPU pods of 256 and 512 chips) serve
its dry-run and have no counterpart yet.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def make_host_mesh(slabs: int | None = None, device="cuda") -> list[torch.device]:
    """Devices for ``slabs`` slabs (default: one per visible card) in
    contiguous blocks over the visible cards, so neighbouring slabs share a
    card where there are more slabs than cards; ``device="cpu"`` puts every
    slab on the CPU (default: one slab)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (slabs or 1)
    cards = torch.cuda.device_count()
    slabs = slabs or cards
    return [torch.device("cuda", d * cards // slabs) for d in range(slabs)]



def make_lm_mesh(data: int, model: int, device="cuda") -> DeviceMesh:
    """The (data, model) ``DeviceMesh`` over this process's world of W =
    data x model ranks, rank d x model + m at (d, m).  The process group
    must be up (``init_process_group``): NCCL on the card, one rank per
    visible card (rank r on card r, made the current device), or gloo when
    the caller asks for the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_lm_mesh: call torch.distributed.init_process_group first")
    world, backend = dist.get_world_size(), dist.get_backend()
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks; the "
                         f"world has {world}")
    if dev.type == "cuda":
        if backend != "nccl":
            raise ValueError(f"ranks on the card communicate over NCCL, not {backend}")
        if world > torch.cuda.device_count():
            raise ValueError(f"{world} ranks need {world} cards; "
                             f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(dist.get_rank())
    elif backend != "gloo":
        raise ValueError(f"ranks on the CPU communicate over gloo, not {backend}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def mesh_chip_count(mesh: DeviceMesh) -> int:
    return mesh.size()
