"""Slab-to-device maps over the visible cards.

The port of ``repro.launch.mesh``'s host mesh.  A "mesh" here is the list
of devices that :class:`repro_torch.dist.lbm.ShardedLBM` places its slabs
on, slab d on ``mesh[d]``.  The reference's production meshes (TPU pods of
256 and 512 chips) serve its dry-run and have no counterpart yet.
"""
from __future__ import annotations

import torch

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

