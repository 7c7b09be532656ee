"""Meshes over the visible cards (the port of ``repro.launch.mesh``).

* :func:`make_host_mesh`: the list of devices that
  :class:`repro_torch.dist.lbm.ShardedLBM` places its slabs on, slab d on
  ``mesh[d]``.
* :func:`make_lm_mesh`: the LM's ("data", "model") mesh over the ranks of a
  ``torch.distributed`` world, one rank per card (the reference's
  ``make_host_mesh(model_axis)``; the rules of ``repro_torch.dist.sharding``
  map onto its axes).

* :func:`make_production_mesh`: the dry-run's production meshes, as a
  description only (:class:`MeshSpec`: no process group, no device): the
  reference's (16, 16) ("data", "model") of 256 chips and (2, 16, 16)
  ("pod", "data", "model") of 512, here as H100s, 8 to an NVLink node with
  "model" innermost (ranks r and r + 1 differ in "model").
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh described, not built: its shape, its axis names (the last
    innermost: consecutive ranks), and the cards a node holds."""
    shape: tuple
    axis_names: tuple
    cards_per_node: int = 8

    @property
    def chips(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape)

    def size(self) -> int:
        return self.chips

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def spans_nodes(self, axis: str) -> bool:
        """Whether the ranks along ``axis`` (the others fixed) sit in more
        than one node."""
        if axis not in self.axis_names:
            return False
        i = self.axis_names.index(axis)
        stride = math.prod(self.shape[i + 1:])
        return len({k * stride // self.cards_per_node for k in range(self.shape[i])}) > 1


def make_production_mesh(multi_pod: bool = False) -> MeshSpec:
    """The reference's production mesh as H100s: (16, 16) ("data",
    "model"), or (2, 16, 16) ("pod", "data", "model") with ``multi_pod``;
    8 cards a node, "model" innermost."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


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


def mesh_chip_count(mesh) -> int:
    """Cards of a ``DeviceMesh`` or a :class:`MeshSpec`."""
    return mesh.size()
