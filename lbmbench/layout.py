"""Where each node of the reference sits in the program's state.

The program keeps a step's state as (Q, T, n): T tiles of n = a^3 slots.
Its tiling says which grid point each (tile, slot) holds
(``Tiling.node_coords``).  This module checks that tiling against the
dense grid on its own terms (the paper's Algorithm 1: every tile that holds
a non-solid node, each once, every point of it once, the node types as in
the grid) and moves states between the program's layout and the
reference's (Q, N) node order in both directions.
"""
from __future__ import annotations

import numpy as np
import torch

SOLID = 0


def _padded(x: torch.Tensor, shape: tuple, fill) -> torch.Tensor:
    out = x.new_full(shape, fill)
    out[:x.shape[0], :x.shape[1], :x.shape[2]] = x
    return out


class PortLayout:
    """The program's (tile, slot) of every reference node.

    g:           dense (X, Y, Z) uint8 node types on the device
    index:       (X, Y, Z) int64 reference node number, -1 at solid nodes
    node_coords: (T, n, 3) grid point of every (tile, slot), the program's
    node_types:  (T, n) node type of every (tile, slot), the program's
    """

    def __init__(self, g: torch.Tensor, index: torch.Tensor,
                 node_coords: np.ndarray, node_types: np.ndarray):
        dev = g.device
        t, n = node_types.shape
        a = round(n ** (1 / 3))
        self.shape = (t, n)
        # the program pads the grid with solid nodes to whole tiles
        padded = tuple(s + (-s) % a for s in g.shape)
        g, index = _padded(g, padded, SOLID), _padded(index, padded, -1)
        dims = torch.tensor(g.shape, device=dev)
        xyz = torch.as_tensor(node_coords, dtype=torch.int64, device=dev).reshape(t, n, 3)
        # counted faults of the program's tiling; 0 when it is the paper's
        faults = int(((xyz < 0) | (xyz >= dims)).any(dim=-1).sum())
        xyz = torch.minimum(torch.clamp(xyz, min=0), dims - 1)
        lin = (xyz[..., 0] * dims[1] + xyz[..., 1]) * dims[2] + xyz[..., 2]
        faults += int((torch.bincount(lin.reshape(-1)) > 1).sum())    # a point twice
        tile = xyz // a
        faults += int((tile != tile[:, :1]).any(dim=-1).any(dim=-1).sum())  # a tile astride
        tx, ty, tz = (int(s) // a for s in g.shape)
        blocks = g.reshape(tx, a, ty, a, tz, a).permute(0, 2, 4, 1, 3, 5).reshape(tx, ty, tz, -1)
        expected = (blocks != SOLID).any(dim=-1)
        held = torch.zeros_like(expected)
        held[tile[:, 0, 0], tile[:, 0, 1], tile[:, 0, 2]] = True
        faults += int((held != expected).sum()) + (t - int(held.sum()))
        types = torch.as_tensor(node_types, device=dev)
        faults += int((g[xyz[..., 0], xyz[..., 1], xyz[..., 2]] != types).sum())
        self.faults = faults
        node = index[xyz[..., 0], xyz[..., 1], xyz[..., 2]].reshape(-1)
        fluid = node >= 0
        pos = torch.nonzero(fluid).squeeze(1)
        self.n_nodes = int((index >= 0).sum())
        self.node = node[pos]                          # reference node number
        self.tile, self.slot = pos // n, pos % n       # where the program keeps it
        solid = torch.nonzero(~fluid).squeeze(1)
        self.solid_tile, self.solid_slot = solid // n, solid % n

    def to(self, device) -> "PortLayout":
        """Move the index tensors (off the card for the measured window)."""
        for name in ("node", "tile", "slot", "solid_tile", "solid_slot"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    def pack(self, f: torch.Tensor) -> torch.Tensor:
        """A (Q, N) reference-order state as the program's (Q, T, n),
        zero at solid slots."""
        out = f.new_zeros((f.shape[0],) + self.shape)
        out[:, self.tile, self.slot] = f[:, self.node]
        return out

    def unpack(self, f: torch.Tensor) -> tuple[torch.Tensor, float]:
        """The program's (Q, T, n) state in reference order (Q, N), NaN at
        any node the program does not hold, and the largest magnitude at a
        solid slot (the program keeps them zero)."""
        out = torch.full((f.shape[0], self.n_nodes), float("nan"),
                         dtype=f.dtype, device=f.device)
        out[:, self.node] = f[:, self.tile, self.slot]
        solid = f[:, self.solid_tile, self.solid_slot]
        return out, float(solid.abs().max()) if solid.numel() else 0.0
