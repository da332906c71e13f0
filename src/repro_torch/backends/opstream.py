"""Operator-level address-stream generation (paper §5.1, adapted).

The paper's GPU backend replays NVBit-captured SASS through Accel-Sim.
Neither tool exists here, so we generate the address streams *from the
workload structure itself*: every framework model lowers to a sequence of
operators (GEMM, elementwise, normalization/reduction, transpose, residual),
and each operator emits the byte-address stream its tiled execution would
issue on a SIMD machine.  The streams are replayed through
``repro_torch.backends.cachesim`` to obtain hit/miss-annotated L1/L2 traces.

Line-sampling: for large tensors we keep only lines whose hashed index
falls under ``1/sample``; because sampling is *per line*, every access to a
kept line is preserved, so per-line lifetime sequences remain exact and the
lifetime distribution is an unbiased subsample (the same argument PKA makes
for kernels, made for addresses).

Per-op kernel counters (reads/writes/flops/cycles) are recorded for PKA
(Table 4) and kernel-level lifetime attribution (Fig 5).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.api import ProfileResult, register_backend
from repro_torch.core.trace import Trace, chunk_trace

LINE_BYTES = 128
FLOPS_PER_CYCLE = 1.0e5          # ~100 TFLOP/s at 1 GHz
BYTES_PER_CYCLE = 2000.0         # ~2 TB/s at 1 GHz
_HASH = np.uint64(11400714819323198485)


@dataclasses.dataclass
class TensorRef:
    name: str
    base: int          # byte address
    nbytes: int

    @property
    def n_lines(self) -> int:
        return max(1, self.nbytes // LINE_BYTES)


@dataclasses.dataclass(frozen=True)
class KernelStat:
    name: str
    op: str
    start: int
    cycles: int
    reads: int          # line reads issued (unsampled counts)
    writes: int
    flops: int


class StreamBuilder:
    """Bump allocator + op emitters producing a byte-address stream."""

    def __init__(self, sample: int = 1, seed: int = 0):
        self.sample = max(1, sample)
        self.t = 0
        self._weight_base = 0
        self._act_base = 1 << 34          # activations live above weights
        self._free: list[TensorRef] = []
        self.times: list[np.ndarray] = []
        self.addrs: list[np.ndarray] = []
        self.writes: list[np.ndarray] = []
        self.kernels: list[KernelStat] = []

    # ---------------- allocation ----------------
    def alloc_weight(self, name: str, nbytes: int) -> TensorRef:
        nbytes = _round_line(nbytes)
        t = TensorRef(name, self._weight_base, nbytes)
        self._weight_base += nbytes
        return t

    def alloc(self, name: str, nbytes: int) -> TensorRef:
        nbytes = _round_line(nbytes)
        for i, f in enumerate(self._free):       # first-fit reuse
            if f.nbytes >= nbytes:
                self._free.pop(i)
                return TensorRef(name, f.base, nbytes)
        t = TensorRef(name, self._act_base, nbytes)
        self._act_base += nbytes
        return t

    def free(self, t: TensorRef) -> None:
        self._free.insert(0, TensorRef("free", t.base, t.nbytes))

    # ---------------- emission helpers ----------------
    def _keep(self, lines: np.ndarray) -> np.ndarray:
        if self.sample == 1:
            return lines
        h = (lines.astype(np.uint64) * _HASH) >> np.uint64(33)
        return lines[(h % np.uint64(self.sample)) == 0]

    def _emit(self, lines: np.ndarray, t0: int, t1: int, is_write: bool):
        lines = self._keep(np.asarray(lines, np.int64))
        n = len(lines)
        if n == 0:
            return
        ts = t0 + (np.arange(n, dtype=np.int64) * max(t1 - t0, 1)) // n
        self.times.append(ts)
        self.addrs.append(lines * LINE_BYTES)
        self.writes.append(np.full(n, is_write, bool))

    def _lines(self, t: TensorRef, start: int = 0, n: int | None = None):
        base = t.base // LINE_BYTES
        n = t.n_lines if n is None else n
        return base + np.arange(start, start + n, dtype=np.int64)

    def _record(self, name, op, start, cycles, reads, writes, flops):
        self.kernels.append(KernelStat(
            name=name, op=op, start=start, cycles=max(cycles, 1),
            reads=reads, writes=writes, flops=flops))
        self.t = start + max(cycles, 1)

    # ---------------- operators ----------------
    def gemm(self, name: str, a: TensorRef, bmat: TensorRef, c: TensorRef,
             M: int, N: int, K: int, dtype_bytes: int = 2,
             bm: int = 64, bn: int = 64):
        """Tiled GEMM: output tiles serialized; A row-panels and B
        col-panels re-read once per opposing tile (classic SIMD blocking)."""
        t0 = self.t
        flops = 2 * M * N * K
        a_panel = max(1, (bm * K * dtype_bytes) // LINE_BYTES)
        b_panel = max(1, (K * bn * dtype_bytes) // LINE_BYTES)
        c_tile = max(1, (bm * bn * dtype_bytes) // LINE_BYTES)
        m_t, n_t = math.ceil(M / bm), math.ceil(N / bn)
        total_reads = m_t * n_t * (a_panel + b_panel)
        total_writes = m_t * n_t * c_tile
        cycles = int(max(flops / FLOPS_PER_CYCLE,
                         (total_reads + total_writes)
                         * LINE_BYTES / BYTES_PER_CYCLE))
        tile_cyc = max(1, cycles // (m_t * n_t))
        t = t0
        for mt in range(m_t):
            for nt in range(n_t):
                self._emit(self._lines(a, mt * a_panel % a.n_lines,
                                       min(a_panel, a.n_lines)),
                           t, t + tile_cyc // 2, False)
                self._emit(self._lines(bmat, nt * b_panel % bmat.n_lines,
                                       min(b_panel, bmat.n_lines)),
                           t, t + tile_cyc // 2, False)
                self._emit(self._lines(c, (mt * n_t + nt) * c_tile
                                       % c.n_lines,
                                       min(c_tile, c.n_lines)),
                           t + tile_cyc - 1, t + tile_cyc, True)
                t += tile_cyc
        self._record(name, "gemm", t0, cycles, total_reads, total_writes,
                     flops)

    def elementwise(self, name: str, ins: list, out: TensorRef,
                    flops_per_elem: int = 1, dtype_bytes: int = 2):
        t0 = self.t
        n_elem = out.nbytes // dtype_bytes
        reads = sum(x.n_lines for x in ins)
        writes = out.n_lines
        cycles = int(max(n_elem * flops_per_elem / FLOPS_PER_CYCLE,
                         (reads + writes) * LINE_BYTES / BYTES_PER_CYCLE))
        for x in ins:
            self._emit(self._lines(x), t0, t0 + cycles, False)
        self._emit(self._lines(out), t0 + cycles // 2, t0 + cycles, True)
        self._record(name, "elementwise", t0, cycles, reads, writes,
                     n_elem * flops_per_elem)

    def normalization(self, name: str, x: TensorRef, out: TensorRef,
                      dtype_bytes: int = 2):
        """Two-pass mean/var + scale: reads x twice -> long-lived data
        (paper Fig 5: normalization exceeds GCRAM retention)."""
        t0 = self.t
        n_elem = x.nbytes // dtype_bytes
        reads, writes = 2 * x.n_lines, out.n_lines
        cycles = int(max(4 * n_elem / FLOPS_PER_CYCLE,
                         (reads + writes) * LINE_BYTES / BYTES_PER_CYCLE))
        self._emit(self._lines(x), t0, t0 + cycles // 2, False)
        self._emit(self._lines(x), t0 + cycles // 2, t0 + cycles, False)
        self._emit(self._lines(out), t0 + cycles // 2, t0 + cycles, True)
        self._record(name, "normalization", t0, cycles, reads, writes,
                     4 * n_elem)

    def softmax(self, name: str, x: TensorRef, dtype_bytes: int = 2):
        """In-place 3-pass softmax (max, exp-sum, scale)."""
        t0 = self.t
        n_elem = x.nbytes // dtype_bytes
        reads, writes = 3 * x.n_lines, x.n_lines
        cycles = int(max(5 * n_elem / FLOPS_PER_CYCLE,
                         (reads + writes) * LINE_BYTES / BYTES_PER_CYCLE))
        third = cycles // 3
        self._emit(self._lines(x), t0, t0 + third, False)
        self._emit(self._lines(x), t0 + third, t0 + 2 * third, False)
        self._emit(self._lines(x), t0 + 2 * third, t0 + cycles, False)
        self._emit(self._lines(x), t0 + 2 * third, t0 + cycles, True)
        self._record(name, "softmax", t0, cycles, reads, writes, 5 * n_elem)

    def transpose(self, name: str, x: TensorRef, out: TensorRef,
                  rows: int = 0, cols: int = 0):
        """Strided copy: reads linger across the whole op -> long lifetimes
        (paper Fig 5: transpose exceeds Si-GCRAM retention)."""
        t0 = self.t
        reads, writes = x.n_lines, out.n_lines
        cycles = int((reads + writes) * LINE_BYTES / BYTES_PER_CYCLE * 4)
        self._emit(self._lines(x), t0, t0 + cycles, False)
        # scattered writes: permute line order deterministically
        lines = self._lines(out)
        perm = np.argsort((lines * 2654435761) % (1 << 32), kind="stable")
        self._emit(lines[perm], t0, t0 + cycles, True)
        self._record(name, "transpose", t0, cycles, reads, writes, 0)

    # ---------------- trace assembly ----------------
    def finish(self):
        if not self.times:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, bool)
        t = np.concatenate(self.times)
        a = np.concatenate(self.addrs)
        w = np.concatenate(self.writes)
        order = np.argsort(t, kind="stable")
        return t[order], a[order], w[order]


def _round_line(nbytes: int) -> int:
    return max(LINE_BYTES,
               ((nbytes + LINE_BYTES - 1) // LINE_BYTES) * LINE_BYTES)


@register_backend("opstream")
class OpStreamBackend:
    """Registry adapter exposing the raw operator address stream.

    Workload: a callable op program ``fn(sb: StreamBuilder)`` or a filled
    builder.  The result is the line-granular DRAM-side stream *before*
    any cache model (every access "hits"), analyzed scratchpad-mode -
    useful for footprint/reuse studies; feed the same workload to the
    ``cachesim`` backend for hit/miss-annotated L1/L2 traces.
    """
    name = "opstream"
    mode = "scratchpad"

    def run(self, workload, *, sample: int = 1, seed: int = 0,
            clock_hz: float = 1.0e9,
            chunk_events: int | None = None) -> ProfileResult:
        if hasattr(workload, "finish"):
            sb = workload
        elif callable(workload):
            sb = StreamBuilder(sample=sample, seed=seed)
            workload(sb)
        else:
            raise TypeError("opstream workload must be a StreamBuilder or "
                            "a callable op program fn(sb)")
        t, a, w = sb.finish()
        trace = Trace(
            time_cycles=t, addr=a // LINE_BYTES, is_write=w,
            hit=np.ones(len(t), bool),
            subpartition=np.zeros(len(t), np.int32),
            clock_hz=clock_hz, block_bits=LINE_BYTES * 8,
            names=("stream",))
        kernels = [k.__dict__ for k in sb.kernels]
        if chunk_events:
            return ProfileResult(chunks=chunk_trace(trace, chunk_events),
                                 kernels=kernels, mode=self.mode)
        return ProfileResult(trace=trace, kernels=kernels, mode=self.mode)


# --------------------------------------------------------------------------
# Workload lowerings (paper Table 5 analogues, driven by framework configs)
# --------------------------------------------------------------------------

def transformer_ops(
    sb: StreamBuilder,
    d_model: int,
    n_heads: int,
    kv_heads: int,
    d_ff: int,
    seq: int,
    n_layers: int = 2,
    moe_experts: int = 0,
    moe_topk: int = 0,
    dtype_bytes: int = 2,
) -> None:
    """Lower a decoder block stack to the op stream (one fwd pass)."""
    hd = d_model // n_heads
    x = sb.alloc("x", seq * d_model * dtype_bytes)
    for li in range(n_layers):
        p = f"L{li}."
        wqkv = sb.alloc_weight(p + "wqkv",
                               d_model * (d_model + 2 * kv_heads * hd)
                               * dtype_bytes)
        wo = sb.alloc_weight(p + "wo", d_model * d_model * dtype_bytes)
        w1 = sb.alloc_weight(p + "w1", d_model * d_ff * dtype_bytes)
        w2 = sb.alloc_weight(p + "w2", d_ff * d_model * dtype_bytes)

        xn = sb.alloc(p + "xn", x.nbytes)
        sb.normalization(p + "ln1", x, xn, dtype_bytes)
        qkv = sb.alloc(p + "qkv",
                       seq * (d_model + 2 * kv_heads * hd) * dtype_bytes)
        sb.gemm(p + "qkv_proj", xn, wqkv, qkv, seq,
                d_model + 2 * kv_heads * hd, d_model, dtype_bytes)
        sb.free(xn)
        # attention scores + value gemm
        scores = sb.alloc(p + "scores",
                          n_heads * seq * seq * dtype_bytes // 8)
        kt = sb.alloc(p + "kT", seq * kv_heads * hd * dtype_bytes)
        sb.transpose(p + "k_transpose", qkv, kt)
        sb.gemm(p + "qk", qkv, kt, scores, seq, seq, hd, dtype_bytes)
        sb.softmax(p + "softmax", scores, dtype_bytes)
        attn = sb.alloc(p + "attn", seq * d_model * dtype_bytes)
        sb.gemm(p + "pv", scores, qkv, attn, seq, hd, seq, dtype_bytes)
        sb.free(scores)
        sb.free(kt)
        sb.free(qkv)
        proj = sb.alloc(p + "proj", seq * d_model * dtype_bytes)
        sb.gemm(p + "o_proj", attn, wo, proj, seq, d_model, d_model,
                dtype_bytes)
        sb.free(attn)
        sb.elementwise(p + "residual1", [x, proj], x, 1, dtype_bytes)
        sb.free(proj)

        xn = sb.alloc(p + "xn2", x.nbytes)
        sb.normalization(p + "ln2", x, xn, dtype_bytes)
        if moe_experts:
            # router + top-k expert GEMMs over 1/topk of tokens each
            logits = sb.alloc(p + "router",
                              seq * moe_experts * dtype_bytes)
            wr = sb.alloc_weight(p + "wr",
                                 d_model * moe_experts * dtype_bytes)
            sb.gemm(p + "route", xn, wr, logits, seq, moe_experts, d_model,
                    dtype_bytes)
            sb.softmax(p + "route_softmax", logits, dtype_bytes)
            sb.free(logits)
            tok = max(1, seq // max(moe_experts // moe_topk, 1))
            for e in range(min(moe_experts, 4)):     # sampled experts
                we1 = sb.alloc_weight(f"{p}e{e}.w1",
                                      d_model * d_ff * dtype_bytes)
                we2 = sb.alloc_weight(f"{p}e{e}.w2",
                                      d_ff * d_model * dtype_bytes)
                h = sb.alloc(f"{p}e{e}.h", tok * d_ff * dtype_bytes)
                sb.gemm(f"{p}e{e}.up", xn, we1, h, tok, d_ff, d_model,
                        dtype_bytes)
                sb.elementwise(f"{p}e{e}.act", [h], h, 4, dtype_bytes)
                y = sb.alloc(f"{p}e{e}.y", tok * d_model * dtype_bytes)
                sb.gemm(f"{p}e{e}.down", h, we2, y, tok, d_model, d_ff,
                        dtype_bytes)
                sb.free(h)
                sb.elementwise(f"{p}e{e}.combine", [x, y], x, 1,
                               dtype_bytes)
                sb.free(y)
        else:
            h = sb.alloc(p + "h", seq * d_ff * dtype_bytes)
            sb.gemm(p + "ffn_up", xn, w1, h, seq, d_ff, d_model,
                    dtype_bytes)
            sb.elementwise(p + "ffn_act", [h], h, 4, dtype_bytes)
            y = sb.alloc(p + "y", seq * d_model * dtype_bytes)
            sb.gemm(p + "ffn_down", h, w2, y, seq, d_model, d_ff,
                    dtype_bytes)
            sb.free(h)
            sb.elementwise(p + "residual2", [x, y], x, 1, dtype_bytes)
            sb.free(y)
        sb.free(xn)


def resnet_ops(sb: StreamBuilder, blocks: list[tuple[int, int, int, int]],
               dtype_bytes: int = 2) -> None:
    """CNN stages as im2col GEMMs + residuals (resnet-18/50 style).

    blocks: (out_hw, out_c, in_c, k) per conv.
    """
    for i, (hw, oc, ic, k) in enumerate(blocks):
        M, N, K = hw * hw, oc, k * k * ic
        a = sb.alloc(f"c{i}.im2col", M * K * dtype_bytes)
        w = sb.alloc_weight(f"c{i}.w", K * N * dtype_bytes)
        y = sb.alloc(f"c{i}.y", M * N * dtype_bytes)
        sb.gemm(f"c{i}.conv", a, w, y, M, N, K, dtype_bytes)
        sb.free(a)
        out = sb.alloc(f"c{i}.bnrelu", y.nbytes)
        sb.normalization(f"c{i}.bn", y, out, dtype_bytes)
        sb.free(y)
        sb.free(out)


def polybench_conv_ops(sb: StreamBuilder, dim: int = 2,
                       n: int = 128, dtype_bytes: int = 4) -> None:
    """PolyBench 2D/3D convolution: one big stencil pass."""
    size = n ** dim * dtype_bytes
    a = sb.alloc("A", size)
    b = sb.alloc("B", size)
    # stencil = k reads of shifted A per output
    sb.elementwise("stencil", [a] * (3 ** dim), b, 3 ** dim, dtype_bytes)
    sb.free(a)
    sb.free(b)
