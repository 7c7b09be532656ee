"""Counting one rank's program without running it: FLOPs, bytes,
collective bytes and peak live memory (the port's counterpart of the
reference's ``repro.roofline.hlo_cost``, which walks compiled HLO).

:class:`Counter` is a ``TorchDispatchMode``: every aten op that a pass
issues inside ``with Counter() as c:`` is counted as it runs, on meta
tensors (shapes only: nothing is allocated or computed), on the CPU or on
the card.  The conventions are the reference's:

* products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, and
  ``einsum``/``matmul``/``linear``, which reach aten as those) by
  ``torch.utils.flop_counter``'s formulas, 2 per multiply-add;
* elementwise ops (aten's ``pointwise`` tag, and a dtype conversion) one
  FLOP per output element, reductions (the ``reduction`` tag) one per
  input element; a softmax counts as its parts: two reductions and three
  elementwise passes (five per element), its backward four;
* bytes: each op's tensor operands plus its outputs.  Eager mode fuses
  nothing, so every op's operands cross HBM.  Views, reshapes, metadata
  ops and empty allocations count nothing; a gather (``index_select``,
  ``embedding``, indexing) counts twice what it touches (the output) plus
  its index, as ``hlo_cost`` counts slicing ops, and an in-place scatter
  twice its update;
* a hand-written kernel by its wrapper's cost function
  (``kernels.stream_collide.stream_collide_cost``,
  ``kernels.collide.collide_cost``, ``kernels.flash.flash_attention_cost``
  and ``flash_attention_bwd_cost``): the wrapper calls :func:`kernel` on
  the meta device (where it launches nothing) and on the card (after its
  launch);
* collectives by their operand bytes, by op and mesh axis
  (``dist.comm.CountComm``, ``dist.zero.fsdp_collectives``), as the
  reference's ``collective_bytes`` sums them; their operands and outputs
  also count as HBM bytes;
* peak live bytes: every storage an op creates is live until Python frees
  it (a weak reference on the storage), each rounded up to the caching
  allocator's 512-byte blocks; :meth:`Counter.resident` adds storages
  made before the count (parameters, optimizer state, caches).

Ops whose output shape depends on the data and that have no meta kernel
get a rule here (:data:`META_RULES`): ``bincount`` of top-k expert ids
gives ``minlength`` counts (every id lies below it).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the caching allocator's block size: max_memory_allocated counts blocks
BLOCK = 512

_EMPTY = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
# metadata only: no bytes move (views are found by their schema)
_FREE = {aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view, aten.view,
         aten.reshape, aten._reshape_alias, aten.set_, aten.resize_,
         aten.sym_size, aten.sym_stride, aten.sym_numel, aten.is_same_size,
         aten._local_scalar_dense, aten.record_stream}
_GATHERS = {aten.index_select, aten.gather, aten.embedding, aten.index, aten.take}
_SCATTERS_INPLACE = {aten.index_copy_, aten.index_put_, aten.scatter_, aten.scatter_add_,
                     aten.index_add_, aten.masked_scatter_, aten.index_fill_,
                     aten._index_put_impl_}
_CONVERTS = {aten._to_copy, aten.copy_, aten.to}
# composite ops counted by their parts, FLOPs per element of the first input
_PER_ELEMENT = {aten._softmax: 5, aten._log_softmax: 5, aten._softmax_backward_data: 4,
                aten._log_softmax_backward_data: 4, aten.logsumexp: 3, aten.bincount: 1}


def _bincount_meta(x, weights=None, minlength=0):
    dtype = torch.int64 if weights is None else torch.promote_types(weights.dtype,
                                                                     torch.float64)
    return torch.empty(int(minlength), dtype=dtype, device=x.device)


META_RULES = {aten.bincount: _bincount_meta}


def _tensors(tree, out=None) -> list:
    """The tensors in nested lists, tuples and dicts (an op's arguments and
    results; faster than a general pytree walk, once an op)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return getattr(func, "is_view", False)


class Counter(TorchDispatchMode):
    """FLOPs, bytes, collectives and peak memory of the ops run inside it.

    ``flops``/``bytes`` totals; ``dots_flops`` the products' part;
    ``by_op`` {name: [calls, flops, bytes]}; ``kernels`` {name: [launches,
    flops, bytes]}; ``coll`` {(op, axis): operand bytes}; ``peak`` the
    most bytes live at once (resident included), ``live`` now."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.dots_flops = 0.0
        self.by_op: dict = defaultdict(lambda: [0, 0.0, 0.0])
        self.kernels: dict = defaultdict(lambda: [0, 0.0, 0.0])
        self.coll: dict = defaultdict(float)
        self.live = self.peak = 0
        self._storages: dict = {}
        self._paused = False

    @contextlib.contextmanager
    def paused(self):
        """Ops inside run uncounted and untracked (state made for the count,
        registered afterwards with :meth:`resident`)."""
        was, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = was

    # ------------------------------------------------------------ records
    def add(self, name: str, flops: float, nbytes: float, dots: bool = False) -> None:
        self.flops += flops
        self.bytes += nbytes
        if dots:
            self.dots_flops += flops
        rec = self.by_op[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One launch of a hand-written kernel at its cost function's
        (FLOPs, bytes)."""
        self.add(name, flops, nbytes)
        rec = self.kernels[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def collective(self, op: str, axis: str, operand_bytes: float,
                   output_bytes: float = 0.0) -> None:
        """One collective over mesh ``axis`` (a name, or names joined by
        ","): its operand bytes, and operands plus outputs as HBM bytes."""
        self.coll[op, axis] += operand_bytes
        self.add(op, 0.0, operand_bytes + output_bytes)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll.values()))

    def coll_by_op(self) -> dict:
        out: dict = defaultdict(float)
        for (op, _), b in self.coll.items():
            out[op] += b
        return dict(out)

    def coll_by_axis(self) -> dict:
        out: dict = defaultdict(float)
        for (_, axis), b in self.coll.items():
            out[axis] += b
        return dict(out)

    # ------------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        if key in self._storages:
            return
        size = -(-st.nbytes() // BLOCK) * BLOCK
        self._storages[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def reserve(self, nbytes: float) -> None:
        """Count ``nbytes`` as live from now on (memory held outside the
        tensors the count sees: ZeRO-3 shards and gathered units)."""
        self.live += int(nbytes)
        self.peak = max(self.peak, self.live)

    def resident(self, tensors) -> int:
        """Count ``tensors`` (any pytree) as live from now on, each storage
        once; returns the bytes added."""
        before = self.live
        for t in _tensors(tensors):
            self._track(t)
        return self.live - before

    # ----------------------------------------------------------- dispatch
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        if self._paused:
            if packet in META_RULES and ins and all(t.is_meta for t in ins):
                return META_RULES[packet](*args, **kwargs)
            return func(*args, **kwargs)
        if packet in META_RULES and ins and all(t.is_meta for t in ins):
            out = META_RULES[packet](*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if _is_view(func) or packet in _FREE or packet in _EMPTY:
            return out
        name = packet.__name__
        out_b = sum(_nbytes(t) for t in outs)
        in_b = sum(_nbytes(t) for t in ins)
        first_out = outs[0].numel() if outs else 0
        flops, dots = 0.0, False
        if packet in flop_counter.flop_registry:
            flops = float(flop_counter.flop_registry[packet](*args, **kwargs, out_val=out))
            dots = True
        elif packet in _PER_ELEMENT:
            flops = float(_PER_ELEMENT[packet] * ins[0].numel())
        elif torch.Tag.reduction in func.tags:
            flops = float(ins[0].numel()) if ins else 0.0
        elif torch.Tag.pointwise in func.tags:
            flops = float(first_out)
        elif packet in _CONVERTS:
            src = ins[-1] if packet is aten.copy_ else ins[0]
            dst = outs[0] if outs else src
            flops = float(dst.numel()) if src.dtype != dst.dtype else 0.0
        if packet in _GATHERS:
            nbytes = 2 * out_b + sum(_nbytes(t) for t in ins[1:]
                                     if not t.is_floating_point())
        elif packet in _SCATTERS_INPLACE:
            upd = [t for t in ins[1:] if t.is_floating_point()]
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            nbytes = 2 * sum(_nbytes(t) for t in upd) + sum(_nbytes(t) for t in idx)
        elif packet is aten.copy_:
            nbytes = 2 * _nbytes(ins[-1]) if ins[-1].numel() == ins[0].numel() else \
                _nbytes(ins[-1]) + _nbytes(ins[0])
        elif packet in (aten.zero_, aten.fill_, aten.zeros, aten.ones, aten.full,
                        aten.zeros_like, aten.ones_like, aten.full_like, aten.arange,
                        aten.scalar_tensor):
            nbytes = out_b
        else:
            nbytes = in_b + out_b
        self.add(name, flops, float(nbytes), dots)
        return out


_ACTIVE: list = []


def active() -> Counter | None:
    """The innermost :class:`Counter` now counting, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def kernel(name: str, flops: float, nbytes: float) -> None:
    """Report one launch of a hand-written kernel to the active counter
    (nothing without one)."""
    c = active()
    if c is not None:
        c.kernel(name, flops, nbytes)


def collective(op: str, axis: str, operand_bytes: float, output_bytes: float = 0.0) -> None:
    c = active()
    if c is not None:
        c.collective(op, axis, operand_bytes, output_bytes)


def differences(a: dict, b: dict, rel: float = 0.01) -> list[tuple]:
    """Ops whose (calls, FLOPs, bytes) differ between two counts' ``by_op``
    records by more than ``rel`` of the larger: [(name, a's, b's)]."""
    out = []
    for name in sorted(set(a) | set(b)):
        ra, rb = list(a.get(name, [0, 0.0, 0.0])), list(b.get(name, [0, 0.0, 0.0]))
        if any(abs(x - y) > rel * max(abs(x), abs(y)) for x, y in zip(ra, rb)):
            out.append((name, ra, rb))
    return out


__all__ = ["BLOCK", "META_RULES", "Counter", "active", "collective", "differences", "kernel"]
