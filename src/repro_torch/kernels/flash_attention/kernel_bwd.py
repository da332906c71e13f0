"""The flash-attention backward kernels: wrappers, plain versions, launch
counts.

Contract (the JAX package's ``flash_attention_bwd_bhsd``, with the GQA
group-sum of its ``ops.py`` applied):

  q, o, do  [B, H, Sq, hd]   float32 or bfloat16 (one dtype)
  k, v      [B, KV, Skv, hd] same dtype, H % KV == 0
  lse       [B, H, Sq]       float32, the forward's logsumexp
  -> dq [B, H, Sq, hd], dk / dv [B, KV, Skv, hd], in the inputs' dtype

Both passes recompute ``p = exp(s - lse)`` with the forward's scores,
scaling and mask (-1e30, top-left aligned causal); ``delta = rowsum(dO .
O)``, ``ds = p * (dp - delta)`` with ``dp = dO . v``; ``dq = scale * ds .
k``; per query head ``dv_h = p^T . dO`` and ``dk_h = ds^T . (q * scale)``,
rounded to the inputs' dtype, then summed over the H / KV query heads of
each kv head (as the reference does).

Two passes, two kernels (``csrc/flash_attention_bwd.cu``, built at first
use), each output written once by one block, so the gradient is the same
bit for bit from run to run:

* :func:`flash_attention_bwd_dq` (pass A, replaces ``_dq_kernel``): dq, and
  delta for pass B;
* :func:`flash_attention_bwd_dkv` (pass B, replaces ``_dkv_kernel``): the
  per-query-head dk_h and dv_h.

:func:`flash_attention_bwd_bhsd` chains them and sums the GQA groups.  On
CUDA tensors each wrapper launches its kernel or raises; on CPU tensors it
runs its plain version in stock torch ops; there is no fallback from one to
the other.  :func:`flash_attention_bwd_plain` is the whole function in
stock torch ops, which the tests and the on-card comparison hold the
kernels against.  The wrappers take any strides whose last dimension is
contiguous.

In both passes the dtype alone chooses the CUDA kernel
(:func:`_kernel_variant`, the forward's choice): float32 runs on fp32 FMAs
(``"fp32 fma"``), bfloat16 on the tensor cores (``"bf16 mma"``).  Pass A
rounds ds to bfloat16 once before ds . k; pass B feeds p and ds to its two
products as a bfloat16 high plus a bfloat16 low part.  The tensor-core
kernels' inputs must start on a 16-byte boundary with strides that are
multiples of 8 elements; a call that breaks this raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    _KERNEL_CODES, KERNEL_HEAD_DIMS, MAX_GRID_Y, NEG_INF, _check,
    _kernel_variant, _mma_layout_error)


def _grouped(x, KV):
    """[B, H, S, hd] -> [B, KV, G, S, hd] float32 (query head h is group
    h % G of kv head h // G)."""
    B, H, S, hd = x.shape
    return x.reshape(B, KV, H // KV, S, hd).float()


def _probs(q, k, lse, causal):
    """(q * scale grouped, p = exp(s - lse) with masked pairs exactly 0)."""
    B, H, Sq, hd = q.shape
    _, KV, Skv, _ = k.shape
    qg = _grouped(q, KV) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgqh,bkph->bkgqp", qg, k.float())
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse.reshape(B, KV, H // KV, Sq)[..., None])
    return qg, p


def _dscores(p, do, v, delta):
    """ds = p * (dO . v^T - delta)."""
    KV = v.shape[1]
    dp = torch.einsum("bkgqh,bkph->bkgqp", _grouped(do, KV), v.float())
    B, H, Sq = delta.shape
    return p * (dp - delta.reshape(B, KV, H // KV, Sq)[..., None])


def bwd_dq_plain(q, k, v, o, lse, do, *, causal=True):
    """Plain version of pass A: (dq, delta)."""
    B, H, Sq, hd = q.shape
    delta = (do.float() * o.float()).sum(-1)
    _, p = _probs(q, k, lse, causal)
    ds = _dscores(p, do, v, delta)
    dq = torch.einsum("bkgqp,bkph->bkgqh", ds, k.float()) / math.sqrt(hd)
    return dq.reshape(B, H, Sq, hd).to(q.dtype), delta


def bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=True):
    """Plain version of pass B: per-query-head (dk_h, dv_h)."""
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    qg, p = _probs(q, k, lse, causal)
    ds = _dscores(p, do, v, delta)
    dv_h = torch.einsum("bkgqp,bkgqh->bkgph", p, _grouped(do, k.shape[1]))
    dk_h = torch.einsum("bkgqp,bkgqh->bkgph", ds, qg)
    return (dk_h.reshape(B, H, Skv, hd).to(q.dtype),
            dv_h.reshape(B, H, Skv, hd).to(q.dtype))


def group_sum(x_h, KV, dtype):
    """Per-query-head [B, H, S, hd] -> [B, KV, S, hd] in ``dtype``."""
    B, H, S, hd = x_h.shape
    if H == KV:
        return x_h.to(dtype)
    return x_h.reshape(B, KV, H // KV, S, hd).sum(2).to(dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True):
    """Plain PyTorch version of the whole backward (any device)."""
    dq, delta = bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    dk_h, dv_h = bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    KV = k.shape[1]
    return dq, group_sum(dk_h, KV, k.dtype), group_sum(dv_h, KV, v.dtype)


def _check_bwd(q, k, v, lse, *rows):
    _check(q, k, v)
    B, H, Sq, _ = q.shape
    for x in rows:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"o/do must match q: {tuple(x.shape)} "
                             f"{x.dtype} vs {tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 or \
            lse.device != q.device:
        raise ValueError(f"lse must be float32 [B, H, Sq] = {(B, H, Sq)} "
                         f"on {q.device}, got {tuple(lse.shape)} {lse.dtype}")


def _cuda_ready(q, k, tensors) -> bool:
    """False for CPU tensors (plain version); raises on what the kernels do
    not take; True when the kernel is to be launched."""
    dev = q.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {dev}")
    B, H, _, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds the kernels' grid "
                         f"({MAX_GRID_Y} batch-heads)")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("the head dimension of every input must be "
                         "contiguous")
    if q.shape[2] == 0 or k.shape[2] == 0 or B * H == 0:
        raise ValueError("flash_attention_bwd needs Sq, Skv, B * H > 0")
    return True


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = _build.load_library("flash_attention_bwd")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    tail = [ctypes.c_float, i32, i32, ptr]      # scale causal kernel stream
    dq = lib.flash_attention_bwd_dq_launch
    dq.argtypes = ([ptr] * 8 + [i32] * 6 + [i64] * 15 + tail)
    dkv = lib.flash_attention_bwd_dkv_launch
    dkv.argtypes = ([ptr] * 8 + [i32] * 6 + [i64] * 12 + tail)
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal=True):
    """Pass A: (dq [B, H, Sq, hd] in q's dtype, delta [B, H, Sq] float32)."""
    _check_bwd(q, k, v, lse, o, do)
    if not _cuda_ready(q, k, (q, k, v, o, do)):
        return bwd_dq_plain(q, k, v, o, lse, do, causal=causal)
    variant = _kernel_variant(q.dtype)
    if variant == "bf16 mma" and (err := _mma_layout_error(q, k, v, o, do)):
        raise ValueError(err)
    B, H, Sq, hd = q.shape
    _, KV, Skv, _ = k.shape
    lse = lse.contiguous()
    dq = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    launch = _launchers()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), B, H, KV, Sq, Skv, hd,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3], *do.stride()[:3], 1.0 / math.sqrt(hd),
                     int(causal), _KERNEL_CODES[variant], stream)
    flash_attention_bwd_dq.launches += 1
    _raise_on(err, "flash_attention_bwd_dq")
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True):
    """Pass B: per-query-head (dk_h, dv_h) [B, H, Skv, hd] in q's dtype;
    ``delta`` is pass A's."""
    _check_bwd(q, k, v, lse, do)
    if tuple(delta.shape) != tuple(lse.shape) or \
            delta.dtype != torch.float32 or delta.device != q.device:
        raise ValueError("delta must be float32 shaped like lse")
    if not _cuda_ready(q, k, (q, k, v, do)):
        return bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    variant = _kernel_variant(q.dtype)
    if variant == "bf16 mma" and (err := _mma_layout_error(q, k, v, do)):
        raise ValueError(err)
    B, H, Sq, hd = q.shape
    _, KV, Skv, _ = k.shape
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty((B, H, Skv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    launch = _launchers()[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), B, H, KV, Sq, Skv, hd,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *do.stride()[:3], 1.0 / math.sqrt(hd), int(causal),
                     _KERNEL_CODES[variant], stream)
    flash_attention_bwd_dkv.launches += 1
    _raise_on(err, "flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd_bhsd(q, k, v, o, lse, do, *, causal=True):
    """(dq, dk, dv); see the module docstring.  CUDA tensors go to the two
    kernels, CPU tensors to their plain versions."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal)
    dk_h, dv_h = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal)
    KV = k.shape[1]
    return dq, group_sum(dk_h, KV, k.dtype), group_sum(dv_h, KV, v.dtype)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
