"""Roofline terms of a step from its recorded per-device ops (deliverable g).

Hardware model: one NVIDIA H100 SXM - 989 TFLOP/s dense bf16
(``backends/tpu_graph.PEAK_FLOPS``), 3.35 TB/s HBM3 (``HBM_BW``), and
450 GB/s per direction of NVLink 4 (``LINK_BW``; ROADMAP D-entry on the
link).

  compute term    = FLOPs            / (chips * peak FLOP/s)
  memory term     = bytes            / (chips * HBM bandwidth)
  collective term = collective bytes / (chips * link bandwidth)

The reference parses the optimized, SPMD-partitioned XLA HLO of the
compiled step.  Torch has no HLO: ``StepRecorder`` runs the step once on
meta tensors (DTensors on a mesh) and records every aten op a rank
executes, at the rank's local shapes.  A dispatch mode above DTensor sees
global shapes, so the recorder hands a DTensor op back to DTensor
(``NotImplemented``) and counts the local ops DTensor then runs, its
collectives among them; the global-shape ops DTensor's sharding
propagation runs on fake tensors are not counted.  All quantities are per
device:

  - dot FLOPs = 2 * out_elems * contracted_elems of each matmul-family op
    (``tpu_graph._MATMULS``);
  - bytes = 2x each materializing op's output bytes (written once, read
    once); views and aliases are free (D32's rule); an in-place op is
    charged as the reference charges its dynamic-update-slice: its
    output plus its operands less the largest (the buffer it updates);
    allocations without a write (``empty``, ``arange``) are free;
  - collective bytes = operand bytes of each collective, by the
    reference's five kinds;
  - the peak of live bytes the step allocates (``temp_size_in_bytes``).

The models loop in Python, so every op is recorded as often as it runs:
there are no loop multiplicities (D33).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.backends.tpu_graph import (HBM_BW, PEAK_FLOPS, _MATMULS,
                                            _aliasing, _op_name)

LINK_BW = 450e9           # NVLink 4, per direction per GPU (900 GB/s both)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective ops (functional and in-place c10d forms) -> the reference's kind
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# allocations that write nothing (the reference skips parameter, constant
# and iota)
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like",
                         "new_empty", "new_empty_strided", "arange"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _flat(values) -> list:
    """The tensors among an op's arguments or results (an aten op nests
    them one list deep at most)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _local(t):
    """A DTensor's local shard, or ``t``."""
    return getattr(t, "_local_tensor", t)


def local_bytes(tree) -> int:
    """Bytes a rank holds of every tensor leaf of ``tree`` (a DTensor's
    local shard)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _storage_key(t) -> int:
    return _local(t).untyped_storage()._cdata


def aliased_bytes(outputs, inputs) -> int:
    """Bytes of the tensor leaves of ``outputs`` whose local storage is
    one of ``inputs``' (updated in place, or returned as given)."""
    given = {_storage_key(t) for t in _tensors(inputs)}
    return sum(_nbytes(_local(t)) for t in _tensors(outputs)
               if _storage_key(t) in given)


@functools.cache
def _kind(func) -> tuple:
    """(what the recorder does with ``func``, its name): a collective's
    kind, ``"view"`` (also a collective's wait), ``"inplace"``, ``"free"``
    (an allocation that writes nothing), ``"matmul"`` or ``"op"``."""
    packet = getattr(func, "_overloadpacket", None)
    namespace = getattr(packet, "_qualified_op_name", "").split("::")[0]
    name = _op_name(func)
    if namespace in _COLLECTIVE_NAMESPACES:
        return _COLLECTIVE_KIND.get(name, "view"), name
    return _aliasing(func) or ("free" if name in _NO_TRAFFIC else
                               "matmul" if name in _MATMULS else "op"), name


class StepRecorder(TorchDispatchMode):
    """Records, per device, the ops run while it is active: matmul FLOPs,
    all FLOPs (one per output element of every other materializing op),
    traffic bytes, collective bytes by kind, and the peak of live bytes
    the ops allocate.  Nothing is kept per op, only sums."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        self._fake, self._dtensor = FakeTensor, DTensor
        self.dot_flops = 0.0
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_accessed = 0.0
        self.n_dot_sites = 0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_count = 0
        self.live = 0
        self.peak = 0

    def _release(self, n):
        self.live -= n

    def _allocated(self, outs):
        for t in outs:
            n = _nbytes(t)
            if n:
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._release, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented     # DTensor runs the rank's local ops
        out = func(*args, **kwargs)
        outs = _flat((out,))
        if not outs or any(isinstance(t, self._fake) for t in outs):
            return out                # no tensor, or sharding propagation
        kind, name = _kind(func)
        if kind == "view":
            return out
        ins = _flat(args) + _flat(kwargs.values())
        if kind in COLLECTIVES:
            self.coll_bytes[kind] += sum(map(_nbytes, ins)) or \
                sum(map(_nbytes, outs))
            self.coll_count += 1
            if not name.endswith("_"):        # not an in-place c10d op
                self._allocated(outs)
            return out
        if kind == "free":
            self._allocated(outs)
            return out
        out_b = sum(map(_nbytes, outs))
        in_b = sum(map(_nbytes, ins))
        self.bytes_accessed += out_b + in_b
        flops = sum(t.numel() for t in outs)     # one per output element
        if kind == "inplace":
            buf = max(map(_nbytes, ins), default=0)
            self.bytes += out_b + max(in_b - buf, 0)
        else:
            self._allocated(outs)
            self.bytes += 2 * out_b
        if kind == "matmul":
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            flops *= 2.0 * a.shape[-1]
            self.dot_flops += flops
            self.n_dot_sites += 1
        self.flops += flops
        return out


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: float
    by_kind: dict
    count: int


def collective_bytes(rec: StepRecorder) -> CollectiveStats:
    """Per-device operand bytes of the recorded collectives, by kind."""
    by_kind = dict(rec.coll_bytes)
    return CollectiveStats(total_bytes=sum(by_kind.values()),
                           by_kind=by_kind, count=rec.coll_count)


def hlo_cost(rec: StepRecorder) -> dict:
    """The reference's ``hlo_cost`` keys from the recorded ops: per-device
    matmul FLOPs, traffic bytes, matmul sites, and no loop
    multiplicities (the recorded step is unrolled, D33)."""
    return {"dot_flops": rec.dot_flops, "bytes": rec.bytes,
            "n_dot_sites": rec.n_dot_sites, "multiplicities": {}}


def cost_summary(rec: StepRecorder) -> dict:
    """The counterpart of XLA's ``cost_analysis``: all FLOPs and the bytes
    every op reads and writes, per device."""
    return {"flops": rec.flops, "bytes accessed": rec.bytes_accessed}


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, chips: int,
                   per_device: bool = True, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> dict:
    """Terms in seconds. When per_device=True the inputs are per-chip
    and `chips` is ignored for compute/memory."""
    div = 1 if per_device else chips
    compute_s = flops / (div * peak_flops)
    memory_s = bytes_accessed / (div * hbm_bw)
    collective_s = coll_bytes / (div * link_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dominant
    terms["step_lower_bound_s"] = bound
    terms["roofline_fraction"] = (compute_s / bound) if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode uses one
    token per sequence.  Whole-job quantity (divide by chips for
    per-device)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * n * tokens
