"""Graph-walking "bring your own hardware" backend (paper §5.3).

Generates memory traces for the framework's *own* models: a step function
is captured as an aten-level torch graph (``make_fx`` over fake tensors on
the meta device: nothing is allocated and nothing is launched), then the
graph is walked node by node.  Each op advances a cycle cursor by its
roofline time on one NVIDIA H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s
HBM3, 1980 MHz SM clock), and each buffer contributes

  - a *write* burst when its producer op completes, and
  - a *read* burst at each consumer op, over the op's first half,

at 4 KiB block granularity (at most ``max_blocks_per_buffer`` blocks a
buffer; the inputs are written at t = 0).  The trace is scratchpad-mode
(Def 4.2): its one subpartition, ``"SMEM"``, is the H100's
software-managed on-chip memory, as the systolic array's buffers are in
§5.2.  The frontend then answers "how much of this model's on-chip memory
could be gain-cell memory?".

Cost model, the reference's (``_eqn_flops``): a matmul (``mm``, ``bmm``,
``addmm``, ``baddbmm``, ``matmul``) costs 2·batch·m·n·k flops, a
convolution 2·out_bytes, anything else out_bytes/2; an op lasts
``max(flops/peak, bytes/bw)·clock`` cycles, at least 1, where bytes are
its tensor inputs and outputs.  ``OpCost.name`` is the aten op's name.

Where the torch graph differs from the jaxpr (ROADMAP divergences):

  * views: jax folds a transpose into ``dot_general``'s dimension numbers,
    while the aten graph has ``t``, ``transpose``, ``view``, ``expand``,
    ``permute`` and the like as nodes of their own (``F.linear`` becomes
    ``t`` + ``mm``).  A node whose output aliases an input (its schema says
    so; also ``_unsafe_view``) *is* that input's buffer: no event and no
    cycles.  An in-place op costs as any op and writes the buffer it
    mutates.
  * loops: the models loop over layers in Python, so the graph is unrolled
    and every layer's buffers get blocks of their own (the reference's
    scan reuses one body's blocks across at most four repeats and scales
    their cycles); there is no ``scan_unroll_cap``.
  * Python scalars carry no bytes (a jaxpr literal carries its dtype's).
  * the hand kernels' wrappers take CUDA or CPU tensors only, so a step
    with ``attn_impl="flash"`` cannot be captured: ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
import operator

import numpy as np
import torch

from repro_torch.core.api import ProfileResult, register_backend
from repro_torch.core.trace import Trace, chunk_trace

PEAK_FLOPS = 989e12       # H100 SXM, dense bf16 tensor-core peak
HBM_BW = 3.35e12          # H100 SXM, HBM3
CLOCK_HZ = 1980e6         # H100 SXM, max SM clock
BLOCK_BYTES = 4096
SUBPARTITION = "SMEM"
_HASH = np.uint64(11400714819323198485)
_MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul"})
_CONVOLUTIONS = frozenset({"convolution", "_convolution"})
_VIEWS = frozenset({"_unsafe_view"})      # views whose schema does not say so


@dataclasses.dataclass(frozen=True)
class OpCost:
    name: str
    flops: float
    bytes_touched: float
    start_cycle: int
    cycles: int


def _nbytes(val) -> int:
    return val.numel() * val.element_size()


def _tensor_outputs(val) -> list:
    """The node's value as a list: a tensor per output, None elsewhere."""
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [v if isinstance(v, torch.Tensor) else None for v in val]
    return []


def _op_name(target) -> str:
    packet = getattr(target, "_overloadpacket", None)
    return packet.__name__ if packet is not None else str(target)


def _aliasing(target):
    """``"view"`` if the op's outputs alias its first tensor input,
    ``"inplace"`` if they are that input mutated, else None (D32's rule,
    which ``launch/roofline.py`` counts bytes by too)."""
    if _op_name(target) in _VIEWS:
        return "view"
    schema = getattr(target, "_schema", None)
    infos = [r.alias_info for r in schema.returns] if schema else []
    if not infos or any(i is None for i in infos):
        return None
    return "inplace" if any(i.is_write for i in infos) else "view"


def _flops(name: str, node, out_b: int) -> float:
    if name in _MATMULS:
        a = node.args[1] if name in ("addmm", "baddbmm") else node.args[0]
        shape = tuple(node.meta["val"].shape)
        shape = (1,) * (2 - len(shape)) + shape
        batch = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        m, n = shape[-2], shape[-1]
        k = a.meta["val"].shape[-1]
        return 2.0 * batch * m * n * k
    if name in _CONVOLUTIONS:
        return 2.0 * out_b             # rough: bytes-proportional
    # elementwise / reduce / copy: ~1 flop per output element
    return out_b / 2.0


def _is_spec(x) -> bool:
    """A shape-and-dtype stand-in (``TensorSpec`` or alike), not a tensor."""
    return (not isinstance(x, torch.Tensor)
            and isinstance(getattr(x, "dtype", None), torch.dtype)
            and hasattr(x, "shape"))


def _to_meta(x):
    if _is_spec(x) or isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    return x


def capture_graph(fn, *example_args) -> torch.fx.GraphModule:
    """``fn(*example_args)`` as an aten graph; each tensor or spec leaf of
    the arguments becomes a meta tensor of its shape and dtype.  Captured
    under ``no_grad`` (a parameter that requires grad would add
    ``detach`` nodes the jaxpr does not have)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree
    args = pytree.tree_map(_to_meta, example_args, is_leaf=_is_spec)
    with torch.no_grad():
        try:
            return make_fx(fn, tracing_mode="fake")(*args)
        except ValueError as err:
            if "runs on cuda or cpu" not in str(err):
                raise
            raise ValueError(
                "a step through the hand-written kernels cannot be "
                "captured: their wrappers take CUDA or CPU tensors, not "
                "meta ones; use attn_impl='ref'") from err


def trace_graph(
    fn,
    *example_args,
    clock_hz: float = CLOCK_HZ,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    sample: int = 1,
    max_blocks_per_buffer: int = 64,
) -> tuple[Trace, list[OpCost]]:
    """Walk fn's aten graph on tensor or spec args; emit an SMEM trace."""
    graph = capture_graph(fn, *example_args).graph

    times, addrs, writes = [], [], []
    base_block = [0]
    blocks: dict = {}          # buffer key -> (base_block, n_blocks)
    outs: dict = {}            # node -> [buffer key or None per output]
    ops: list[OpCost] = []

    def blocks_of(key, nbytes):
        if key not in blocks:
            nb = max(1, math.ceil(nbytes / BLOCK_BYTES))
            nb = min(nb, max_blocks_per_buffer)
            blocks[key] = (base_block[0], nb)
            base_block[0] += nb
        return blocks[key]

    def emit(key, nbytes, t0, t1, is_write):
        b0, nb = blocks_of(key, nbytes)
        lines = np.arange(b0, b0 + nb, dtype=np.int64)
        if sample > 1:
            h = (lines.astype(np.uint64) * _HASH) >> np.uint64(33)
            lines = lines[(h % np.uint64(sample)) == 0]
        n = len(lines)
        if n == 0:
            return
        ts = t0 + (np.arange(n, dtype=np.int64) * max(t1 - t0, 1)) // n
        times.append(ts)
        addrs.append(lines)
        writes.append(np.full(n, is_write, bool))

    def tensor_inputs(node):
        """(buffer key, bytes) of each tensor argument, in order."""
        found = []
        torch.fx.node.map_arg((node.args, node.kwargs), found.append)
        return [(outs[a][0], _nbytes(a.meta["val"])) for a in found
                if outs.get(a) and outs[a][0] is not None]

    cursor = 0
    for node in graph.nodes:
        val = node.meta.get("val")
        if node.op in ("placeholder", "get_attr"):
            # model inputs, weights and constants land in SMEM at t=0
            if isinstance(val, torch.Tensor):
                outs[node] = [node]
                emit(node, _nbytes(val), 0, 1, True)
            continue
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:
            parent, idx = node.args
            keys = outs.get(parent) or []
            outs[node] = [keys[idx]] if idx < len(keys) else []
            continue
        results = _tensor_outputs(val)
        if not any(r is not None for r in results):
            continue
        kind = _aliasing(node.target)
        inputs = tensor_inputs(node)
        if kind == "view" and inputs:
            outs[node] = [inputs[0][0] if r is not None else None
                          for r in results]
            continue
        if kind == "inplace" and inputs:
            outs[node] = [inputs[0][0] if r is not None else None
                          for r in results]
        else:
            outs[node] = [(node, i) if r is not None else None
                          for i, r in enumerate(results)]
        name = _op_name(node.target)
        out_b = sum(_nbytes(r) for r in results if r is not None)
        flops = _flops(name, node, out_b)
        total_b = float(sum(b for _, b in inputs) + out_b)
        dur = max(1, int(max(flops / peak_flops, total_b / hbm_bw)
                         * clock_hz))
        t0 = cursor
        for key, nbytes in inputs:
            emit(key, nbytes, t0, t0 + dur // 2, False)
        for key, r in zip(outs[node], results):
            if key is not None:
                emit(key, _nbytes(r), t0 + dur - 1, t0 + dur, True)
        ops.append(OpCost(name, flops, total_b, t0, dur))
        cursor += dur

    if not times:
        z = np.zeros(0, np.int64)
        tr = Trace(z, z, np.zeros(0, bool), np.zeros(0, bool),
                   np.zeros(0, np.int32), clock_hz, BLOCK_BYTES * 8,
                   (SUBPARTITION,))
        return tr, ops
    t = np.concatenate(times)
    a = np.concatenate(addrs)
    w = np.concatenate(writes)
    order = np.argsort(t, kind="stable")
    tr = Trace(
        time_cycles=t[order], addr=a[order], is_write=w[order],
        hit=np.ones(len(t), bool),
        subpartition=np.zeros(len(t), np.int32),
        clock_hz=clock_hz, block_bits=BLOCK_BYTES * 8,
        names=(SUBPARTITION,))
    return tr, ops


@register_backend("tpu_graph", aliases=("tpu",))
class TpuGraphBackend:
    """Registry adapter for the graph-walking backend (alias: "tpu").

    Workload: a callable, or a ``(fn, *example_args)`` tuple whose args are
    tensors or ``TensorSpec``s (pytrees of them).  Config kwargs go
    straight to :func:`trace_graph` (``clock_hz``, ``peak_flops``,
    ``hbm_bw``, ``sample``, ``max_blocks_per_buffer``).
    """
    name = "tpu_graph"
    mode = "scratchpad"

    def run(self, workload, *, chunk_events: int | None = None,
            **cfg) -> ProfileResult:
        if isinstance(workload, (tuple, list)) and workload \
                and callable(workload[0]):
            fn, *args = workload
        elif callable(workload):
            fn, args = workload, ()
        else:
            raise TypeError("tpu_graph workload must be a callable or a "
                            "(fn, *example_args) tuple")
        trace, ops = trace_graph(fn, *args, **cfg)
        kernels = [dataclasses.asdict(o) for o in ops]
        if chunk_events:
            return ProfileResult(chunks=chunk_trace(trace, chunk_events),
                                 kernels=kernels, mode=self.mode,
                                 meta={"n_ops": len(ops)})
        return ProfileResult(trace=trace, kernels=kernels, mode=self.mode,
                             meta={"n_ops": len(ops)})
