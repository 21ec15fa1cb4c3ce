"""Executed-cost analysis of a step traced on fake tensors.

The reference (``repro.launch.hlo_analysis``) re-derives executed costs from
a compiled program's optimized HLO text, multiplying every ``while`` body
by its trip count. The port has no HLO and no compiler: a step runs eagerly,
so every loop iteration is executed and seen. Its counterpart is
:class:`CostMode`, a ``TorchDispatchMode`` under which a step runs (in the
dry run on fake tensors, ``FakeTensorMode``, so nothing is computed or
allocated). It sees every operator the step dispatches on this rank's
local tensors — DTensor's sharding propagation has already turned each
DTensor operator into local operators and collectives (the mode passes
DTensors on, as ``CommDebugMode`` does) — and counts, per rank:

  * flops       — ``torch.utils.flop_counter``'s formulas (matmuls,
                  convolutions, attention) and the two attention kernels'
                  (``kernels/ops.py``);
  * bytes       — operands plus outputs of each dispatched operator, an
                  output that writes into an operand counted once, views
                  free;
  * collectives — result bytes by kind (the reference's names:
                  all-gather, all-reduce, reduce-scatter, all-to-all, and
                  collective-permute for point-to-point sends), counted
                  where issued (a functional collective's ``wait_tensor``
                  is free);
  * flops_by_op — the same by operator (``aten.mm``,
                  ``repro_torch.flash_attention``, …);
  * peak_bytes  — the most bytes of storages made under the mode alive at
                  once (the step's temporaries; its arguments are not
                  included).

Operators on fake tensors of another ``FakeTensorMode`` than the one the
step runs under (none for a step on real tensors) are not the step's:
DTensor runs each new operator once on such tensors of the global shape to
infer its output's metadata.

``unknown_trip_loops`` is always 0: eager execution runs every iteration.
``transcendentals`` is kept for the reference's fields and not counted.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# operator names (functional and in-place c10d) -> the reference's kind
_KINDS = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("send", "collective-permute"),
)
_FREE = ("wait_tensor", "recv", "barrier")


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict[str, float] = field(default_factory=dict)
    transcendentals: float = 0.0
    unknown_trip_loops: int = 0
    peak_bytes: float = 0.0
    flops_by_op: dict[str, float] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += mult * other.flops
        for k, v in other.flops_by_op.items():
            self.flops_by_op[k] = self.flops_by_op.get(k, 0.0) + mult * v
        self.bytes += mult * other.bytes
        self.transcendentals += mult * other.transcendentals
        self.unknown_trip_loops += other.unknown_trip_loops
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + mult * v
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_kind(func) -> str | None:
    """The reference's kind of a collective operator, else None."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d", "_dtensor"):
        return None
    name = func.overloadpacket.__name__
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


class CostMode(TorchDispatchMode):
    """Count the executed cost of what runs under it on this rank
    (:class:`Cost`, in :attr:`cost`)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live: dict[int, int] = {}
        self._now = 0
        self._in_dtensor = False
        self._fake = None  # the step's FakeTensorMode, taken at entry

    def __enter__(self):
        if not self._in_dtensor:
            self._fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
        return super().__enter__()

    def _free(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def _track(self, outs, ins) -> None:
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self._now += self._live[key]
            weakref.finalize(st, self._free, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:  # let DTensor desugar into local ops and collectives
                return NotImplemented
            # DTensor's own bookkeeping (shard offsets, redistribution
            # costs) computes with real tensors: outside FakeTensorMode,
            # while its local ops on fake tensors still dispatch as fake
            # ones and come back here to be counted
            from torch._subclasses.fake_tensor import unset_fake_temporarily

            self._in_dtensor = True
            try:
                with unset_fake_temporarily(), self:
                    return func(*args, **kwargs)
            finally:
                self._in_dtensor = False
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__.rstrip("_") in _FREE:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(getattr(t, "fake_mode", self._fake) is not self._fake for t in ins + outs):
            return out  # another mode's fake tensors: DTensor inferring an output's shape
        kind = collective_kind(func)
        if kind is not None:
            got = sum(_nbytes(t) for t in outs)
            self.cost.collective_bytes[kind] = self.cost.collective_bytes.get(kind, 0.0) + got
        if func.is_view:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.cost.flops += f
            name = str(packet)
            self.cost.flops_by_op[name] = self.cost.flops_by_op.get(name, 0.0) + f
        stor = {id(t.untyped_storage()) for t in ins}
        self.cost.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs if id(t.untyped_storage()) not in stor)
        self._track(outs, ins)
        return out


def analyze(fn, *args, **kwargs) -> tuple[object, Cost]:
    """``fn(*args, **kwargs)`` under a :class:`CostMode`: its result and
    its cost on this rank."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.cost
