"""The three roofline terms of one rank's counted step on the H100, and
the model FLOPs they are judged against (the reference's
``repro.roofline.analysis``, with the card's rates from ``repro_torch.hw``
in place of the reference's TPU constants).

    t_compute    = FLOPs a rank / hw.PEAK_FLOPS[the step's dtype]
    t_memory     = bytes a rank / hw.HBM_BYTES_PER_S
    t_collective = sum over mesh axes of a rank's collective operand bytes
                   on that axis / the rate of the slowest link it crosses
                   (hw.NVLINK_BYTES_PER_S inside one 8-card node,
                   hw.NETWORK_BYTES_PER_S across nodes)

The counts come from ``roofline.count.Counter`` (``launch.dryrun``,
``dist.lbm.ShardedLBM.count_step``): one rank's program, so each term is
per card, as the reference's per-device HLO figures are.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import hw


def axis_rate(mesh, axes: str) -> float:
    """Bytes per second a rank moves over the mesh axes ``axes`` (names
    joined by ","): NVLink where every axis stays inside one node, else
    the network's (``mesh``: ``launch.mesh.MeshSpec``)."""
    rate = hw.NVLINK_BYTES_PER_S
    for axis in axes.split(","):
        if mesh.spans_nodes(axis):
            rate = min(rate, hw.NETWORK_BYTES_PER_S)
    return rate


def collective_time(mesh, by_axis: dict) -> float:
    """Seconds of a rank's collectives: each axis's operand bytes over its
    rate."""
    return float(sum(b / axis_rate(mesh, axes) for axes, b in by_axis.items()))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_op: dict
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float            # 6 N D (train) / 2 N D, N active, global
    peak_bytes_per_device: float  # the counter's peak live bytes
    argument_bytes: float = 0.0   # parameters, optimizer state, caches a rank
    output_bytes: float = 0.0
    peak_flops: float = hw.BF16_PEAK
    coll_by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs over all chips: recompute and
        duplicated work show as a ratio below 1."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """max(useful compute time, useful memory time) / bound time: the
        model FLOPs at peak, or reading the step's arguments once."""
        t_useful_c = self.model_flops / (self.chips * self.peak_flops)
        t_useful_m = self.argument_bytes / hw.HBM_BYTES_PER_S
        return max(t_useful_c, t_useful_m) / self.bound_time if self.bound_time else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction, bound_time=self.bound_time)
        return d


def report(counter, *, arch: str, shape: str, mesh, dtype: torch.dtype,
           model_flops: float, argument_bytes: float = 0.0,
           output_bytes: float = 0.0) -> RooflineReport:
    """The terms of one rank's count (``roofline.count.Counter``) on
    ``mesh`` (``launch.mesh.MeshSpec``)."""
    by_axis = counter.coll_by_axis()
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh.name, chips=mesh.chips,
        flops_per_device=counter.flops, bytes_per_device=counter.bytes,
        coll_bytes_per_device=counter.collective_bytes, coll_by_op=counter.coll_by_op(),
        t_compute=counter.flops / hw.PEAK_FLOPS[dtype],
        t_memory=counter.bytes / hw.HBM_BYTES_PER_S,
        t_collective=collective_time(mesh, by_axis),
        model_flops=model_flops, peak_bytes_per_device=float(counter.peak),
        argument_bytes=argument_bytes, output_bytes=output_bytes,
        peak_flops=hw.PEAK_FLOPS[dtype], coll_by_axis=by_axis)


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6 N D for train, 2 N D for prefill, 2 N a token for decode: N the
    active parameters (``configs.param_stats``), D the tokens."""
    from ..configs import param_stats

    _, active = param_stats(cfg)
    tokens = global_batch * (seq_len if shape_kind != "decode" else 1)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * active * tokens


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time (ms) the card takes to move ``nbytes`` and do
    ``flops`` operations of ``dtype``: the larger of the two, and which."""
    t_bytes = nbytes / hw.HBM_BYTES_PER_S * 1e3
    t_ops = flops / hw.PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


__all__ = ["RooflineReport", "axis_rate", "bound_ms", "collective_time", "model_flops_for",
           "report"]
