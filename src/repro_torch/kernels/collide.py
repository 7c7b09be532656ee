"""Collision kernel (K2) and its plain PyTorch version.

``collide_tiles(f, solid, lat, cfg, force)`` collides the post-streaming
state ``f`` (Q, T, n) with solid slots ``solid`` (T, n) and returns a new
(Q, T, n) tensor with solid slots zeroed — the contract of the reference's
``repro.kernels.ops.collide_tiles`` without its TPU lane packing.  On a CUDA
tensor it launches the hand-written kernel ``csrc/collide.cu`` (math in
``csrc/collide.cuh``); on a CPU tensor it runs :func:`collide_tiles_ref`.

:func:`collide_block_ref` is the reference's ``_collide_block`` in torch
ops (unrolled direction vectors, guarded 1/rho); the fused step's plain
version reuses it.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..core import collision as col
from ..core.lattice import Lattice
from ..roofline import count
from . import build


def _signed_sum(terms):
    """Sum of (+/-) terms without multiplies, skipping zeros."""
    acc = None
    for sign, v in terms:
        t = v if sign > 0 else -v
        acc = t if acc is None else acc + t
    return acc


def collide_block_ref(fs: list[torch.Tensor], solid: torch.Tensor, lat: Lattice,
                      cfg: col.CollisionConfig, force=None) -> list[torch.Tensor]:
    """Collision of Q same-shaped per-direction tensors ``fs``; returns the
    Q post-collision tensors, zero where ``solid``."""
    q = lat.q
    ex, ey, ez, w = lat.ex, lat.ey, lat.ez, lat.w
    rho = fs[0]
    for i in range(1, q):
        rho = rho + fs[i]
    jx = _signed_sum([(int(ex[i]), fs[i]) for i in range(q) if ex[i] != 0])
    jy = _signed_sum([(int(ey[i]), fs[i]) for i in range(q) if ey[i] != 0])
    jz = (_signed_sum([(int(ez[i]), fs[i]) for i in range(q) if ez[i] != 0])
          if ez.any() else torch.zeros_like(rho))

    quasi = cfg.fluid == col.QUASI_COMPRESSIBLE
    if quasi:
        inv_rho = 1.0 / torch.where(solid, torch.ones_like(rho), rho)
        ux, uy, uz = jx * inv_rho, jy * inv_rho, jz * inv_rho
    else:
        ux, uy, uz = jx, jy, jz
    if force is not None:
        fx, fy, fz = (float(v) for v in force)
        if quasi:
            ux = ux + (cfg.tau * fx) * inv_rho
            uy = uy + (cfg.tau * fy) * inv_rho
            uz = uz + (cfg.tau * fz) * inv_rho
        else:
            ux, uy, uz = ux + cfg.tau * fx, uy + cfg.tau * fy, uz + cfg.tau * fz
    u2 = ux * ux + uy * uy + uz * uz

    delta = []
    for i in range(q):
        terms = [(int(c[i]), u) for c, u in ((ex, ux), (ey, uy), (ez, uz)) if c[i]]
        if terms:
            eu = _signed_sum(terms)
            poly = 3.0 * eu + 4.5 * (eu * eu) - 1.5 * u2
        else:
            poly = -1.5 * u2
        wi = float(w[i])
        feq = wi * rho * (1.0 + poly) if quasi else wi * (rho + poly)
        delta.append(feq - fs[i])

    if cfg.model == col.LBGK:
        out = [fs[i] + delta[i] * (1.0 / cfg.tau) for i in range(q)]
    else:
        a_mat = col.collision_matrix(lat, cfg.tau, fs[0].dtype, fs[0].device)
        upd = torch.tensordot(a_mat, torch.stack(delta), dims=1)
        out = [fs[i] + upd[i] for i in range(q)]
    return [torch.where(solid, torch.zeros_like(o), o) for o in out]


def collide_tiles_ref(f: torch.Tensor, solid: torch.Tensor, lat: Lattice,
                      cfg: col.CollisionConfig, force=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`collide_tiles`."""
    return torch.stack(collide_block_ref(list(f.unbind(0)), solid, lat, cfg,
                                         force))


def collision_args(lat: Lattice, cfg: col.CollisionConfig, force, f):
    """The collision scalars every kernel entry point takes: the MRT matrix
    pointer (or None), the model flags and the constants in double."""
    mrt = cfg.model == col.LBMRT
    if mrt and lat.q != 19:
        raise NotImplementedError("MRT matrix defined for D3Q19 only")
    a_mat = col.collision_matrix(lat, cfg.tau, f.dtype, f.device) if mrt else None
    fx, fy, fz = (float(v) for v in force) if force is not None else (0.0,) * 3
    args = (int(mrt), int(cfg.fluid == col.QUASI_COMPRESSIBLE),
            int(force is not None), 1.0 / cfg.tau, cfg.tau * fx, cfg.tau * fy,
            cfg.tau * fz)
    return a_mat, args


def collide_cost(nodes: int, lat: Lattice, cfg: col.CollisionConfig,
                 itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K2 launch over ``nodes`` = T n slots: the
    collision of every slot (``model_flops_per_node``), the Q values of
    each read and written once and its solid flag read."""
    return (float(nodes * col.model_flops_per_node(cfg, lat)),
            float(2 * lat.q * nodes * itemsize + nodes))


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("collide")
    lib.repro_collide_tiles.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_double] * 4 + [ctypes.c_void_p])
    lib.repro_collide_tiles.restype = ctypes.c_int
    return lib


def collide_tiles(f: torch.Tensor, solid: torch.Tensor, lat: Lattice,
                  cfg: col.CollisionConfig, force=None) -> torch.Tensor:
    """Collide the (Q, T, n) state; K2 on the card, the plain version on
    the CPU; on the meta device the output's shape only, reporting
    :func:`collide_cost` to the active counter (``roofline.count``)."""
    if f.device.type == "cpu":
        return collide_tiles_ref(f, solid, lat, cfg, force)
    if f.dim() != 3 or f.shape[0] != lat.q:
        raise ValueError(f"f must be (Q={lat.q}, T, n), got {tuple(f.shape)}")
    if f.dtype not in build.LBM_DTYPES:
        raise TypeError(f"collide_tiles takes float32/float64, got {f.dtype}")
    build.check_tensor(f, "f", f.device)
    build.check_tensor(solid, "solid", f.device, torch.bool, f.shape[1:])
    out = torch.empty_like(f)
    m = f.shape[1] * f.shape[2]
    cost = collide_cost(m, lat, cfg, f.element_size())
    if f.device.type == "meta":
        count.kernel("collide_tiles", *cost)
        return out
    a_mat, args = collision_args(lat, cfg, force, f)
    lib = _lib()
    # the launch function launches into, and sets attributes on, the
    # current card: make it the tensor's, which may be another card
    with torch.cuda.device(f.device):
        code = lib.repro_collide_tiles(
            build.ptr(f), build.ptr(solid), build.ptr(a_mat), build.ptr(out), m,
            lat.q, build.DTYPE_CODES[f.dtype], *args, build.stream(f.device))
    build.check(lib, code, "collide_tiles")
    collide_tiles.launches += 1
    count.kernel("collide_tiles", *cost)
    return out


collide_tiles.launches = 0
