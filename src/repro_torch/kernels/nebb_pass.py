"""The fused backend's NEBB pass as one kernel, and its plain PyTorch version.

After K1 has stepped every tile from the pre-step packed state ``f_pre``
into ``out`` (both (B*T + 1, Q, n): B replicas of T tiles and one scratch
row), :func:`nebb_boundary_pass` redoes only the nodes of the declared
boundary types: it pulls each node's Q post-streaming values through the
node's source offsets, rebuilds the unknown populations by the node's
:class:`~repro_torch.core.boundary.BoundarySpec` (non-equilibrium
bounce-back), collides, and writes the node's slot of ``out``.  K1 pulls
those nodes through the same links and treats them as fluid; every other
slot keeps what K1 wrote.

On a CUDA tensor it launches the hand-written kernel ``csrc/nebb_pass.cu``
(one launch for every replica) or raises; on a CPU tensor it runs
:func:`nebb_boundary_pass_ref`; on the meta device it reports
:func:`nebb_pass_cost` to the active counter.  The kernel replaces no TPU
kernel: the JAX package runs its pass as plain ``jnp``
(``src/repro/core/backends.py:367-372``).  Bytes bound it, counted in the
32-byte sectors that a face's scattered values occupy: the design touches
only the boundary nodes, reads int32 tables and makes one launch a step
(the source's note).
"""
from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..core import collision as col
from ..core.boundary import apply_open_boundary
from ..core.lattice import Lattice
from ..obs.trace import phase_scope
from ..roofline import count
from . import build
from .collide import collide_block_ref, collision_args

KINDS = ("velocity", "pressure")
MAX_SPECS = 8                 # csrc/nebb_pass.cu: nebb::MAX_SPECS


@dataclasses.dataclass(frozen=True)
class BoundaryNodes:
    """The pass's tables over its N boundary nodes: numpy arrays on the
    host (``core.backends.boundary_pass_tables``), tensors after :meth:`to`.

    ``src`` holds each node's Q pull sources as offsets into ONE replica's
    packed (T, Q, n) rows (bounce-back and periodic edges folded in), laid
    out direction-major; replica b's sources are ``src + b * T * Q * n``.
    """

    tiles: np.ndarray | torch.Tensor    # (N,) int32 the node's tile
    slots: np.ndarray | torch.Tensor    # (N,) int32 its slot in the tile
    spec: np.ndarray | torch.Tensor     # (N,) uint8 index into the specs
    src: np.ndarray | torch.Tensor      # (Q, N) int32
    num_tiles: int                      # T: one replica's tiles

    def to(self, device: torch.device) -> "BoundaryNodes":
        return dataclasses.replace(self, **{
            k: torch.as_tensor(getattr(self, k), device=device)
            for k in ("tiles", "slots", "spec", "src")})

    def replicas(self, f: torch.Tensor) -> int:
        """B of a (B*T + 1, Q, n) state; raises where its rows are not that."""
        b, rest = divmod(f.shape[0] - 1, self.num_tiles)
        if rest or b < 1:
            raise ValueError(f"state of {f.shape[0]} rows is not B * {self.num_tiles} + 1")
        return b


def _per_replica(offsets: torch.Tensor, replicas: int, stride: int) -> torch.Tensor:
    """(K, N) offsets into one replica -> (K, B, N) int64 offsets into every
    replica's rows, replica b's ``b * stride`` further on."""
    base = torch.arange(replicas, device=offsets.device, dtype=torch.int64) * stride
    return offsets.long()[:, None, :] + base[None, :, None]


def replica_sources(bc: BoundaryNodes, replicas: int, q: int, n: int) -> torch.Tensor:
    """(Q, B, N) int64 pull sources of every replica's boundary nodes in
    the flat (B*T + 1) * Q * n state."""
    return _per_replica(bc.src, replicas, bc.num_tiles * q * n)


def nebb_boundary_pass_ref(f_pre, out, lat: Lattice, cfg: col.CollisionConfig,
                           force, specs, bc: BoundaryNodes) -> torch.Tensor:
    """Plain PyTorch version of :func:`nebb_boundary_pass`, in place on
    ``out``: ``apply_open_boundary`` per spec on the pulled post-streaming
    values, then the collision of K1's plain version (``collide_block_ref``),
    both elementwise, so that a node's result does not depend on how many
    nodes or replicas the pass holds."""
    q, n = out.shape[-2], out.shape[-1]
    b = bc.replicas(f_pre)
    f_in = torch.take(f_pre, replica_sources(bc, b, q, n))          # (Q, B, N)
    spec_idx = bc.spec.long()
    for k, spec in enumerate(specs):
        f_in = apply_open_boundary(f_in, spec_idx == k, spec, lat)
    solid = torch.zeros(f_in.shape[1:], dtype=torch.bool, device=f_in.device)
    f_out = torch.stack(collide_block_ref(list(f_in.unbind(0)), solid, lat, cfg, force))
    dst = ((bc.tiles.long() * (q * n) + bc.slots.long())[None]
           + (torch.arange(q, device=out.device) * n)[:, None])             # (Q, N)
    out.view(-1)[_per_replica(dst, b, bc.num_tiles * q * n).reshape(-1)] = f_out.reshape(-1)
    return out


def nebb_pass_cost(nodes: int, lat: Lattice, cfg: col.CollisionConfig,
                   itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``nodes`` (boundary node, replica)
    pairs: each node's Q values read and written once, its Q int32 sources,
    int32 tile and slot and uint8 spec read; the collision of every node
    (``model_flops_per_node``) and the rebuild's ~4 FLOPs a direction."""
    flops = nodes * (col.model_flops_per_node(cfg, lat) + 4 * lat.q)
    return float(flops), float(nodes * (lat.q * (2 * itemsize + 4) + 9))


def _spec_args(specs) -> tuple:
    """The specs as the C entry point takes them: (count, ints, doubles),
    four of each a spec."""
    if not 1 <= len(specs) <= MAX_SPECS:
        raise ValueError(f"the NEBB kernel takes 1 to {MAX_SPECS} boundary specs, "
                         f"got {len(specs)}")
    ints, vals = [], []
    for s in specs:
        if s.kind not in KINDS:
            raise ValueError(f"unknown boundary spec {s!r}")
        ints += [KINDS.index(s.kind), *(int(v) for v in s.normal)]
        vals += [*(float(v) for v in s.velocity), float(s.rho)]
    return (len(specs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_double * len(vals))(*vals))


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("nebb_pass")
    lib.repro_nebb_pass.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
        + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_double)]
        + [ctypes.c_int] * 3 + [ctypes.c_double] * 4 + [ctypes.c_void_p])
    lib.repro_nebb_pass.restype = ctypes.c_int
    return lib


def nebb_boundary_pass(f_pre, out, lat: Lattice, cfg: col.CollisionConfig, force,
                       specs, bc: BoundaryNodes) -> torch.Tensor:
    """The NEBB pass over ``bc``'s nodes of every replica, from the
    pre-step ``f_pre`` into ``out`` (K1's output), in place; B comes from
    the state's rows.  ``specs[k]`` is the spec of the nodes whose
    ``bc.spec`` is k."""
    with phase_scope("lbm.phase.boundary"):
        if out.device.type == "cpu":
            return nebb_boundary_pass_ref(f_pre, out, lat, cfg, force, specs, bc)
        _, q, n = f_pre.shape
        b, nodes = bc.replicas(f_pre), bc.src.shape[-1]
        if q != lat.q:
            raise ValueError(f"f_pre must be (B*T+1, Q={lat.q}, n), got {tuple(f_pre.shape)}")
        if f_pre.dtype not in build.LBM_DTYPES:
            raise TypeError(f"nebb_boundary_pass takes float32/float64, got {f_pre.dtype}")
        dev = f_pre.device
        build.check_tensor(f_pre, "f_pre", dev)
        build.check_tensor(out, "out", dev, f_pre.dtype, f_pre.shape)
        build.check_tensor(bc.src, "src", dev, torch.int32, (q, nodes))
        build.check_tensor(bc.tiles, "tiles", dev, torch.int32, (nodes,))
        build.check_tensor(bc.slots, "slots", dev, torch.int32, (nodes,))
        build.check_tensor(bc.spec, "spec", dev, torch.uint8, (nodes,))
        if dev.type != "meta" and out.data_ptr() == f_pre.data_ptr():
            raise ValueError("out must not alias f_pre")
        spec_args = _spec_args(specs)
        cost = nebb_pass_cost(b * nodes, lat, cfg, f_pre.element_size())
        if dev.type == "meta":
            count.kernel("nebb_boundary_pass", *cost)
            return out
        a_mat, args = collision_args(lat, cfg, force, f_pre)
        lib = _lib()
        # the launch function launches into the current card: make it the
        # tensor's, which may be another card
        with torch.cuda.device(dev):
            code = lib.repro_nebb_pass(
                *(build.ptr(x) for x in (f_pre, bc.src, bc.tiles, bc.slots, bc.spec,
                                         a_mat, out)),
                nodes, b, q, n, bc.num_tiles * q * n, build.DTYPE_CODES[f_pre.dtype],
                *spec_args, *args, build.stream(dev))
        build.check(lib, code, "nebb_boundary_pass")
        nebb_boundary_pass.launches += 1
        count.kernel("nebb_boundary_pass", *cost)
        return out


nebb_boundary_pass.launches = 0
