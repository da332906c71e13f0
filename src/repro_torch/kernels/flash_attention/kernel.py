"""The flash-attention forward kernel: wrapper, plain version, launch count.

Contract (the JAX package's ``flash_attention_bhsd``):

  q    [B, H, Sq, hd]   float32 or bfloat16
  k/v  [B, KV, Skv, hd] same dtype, H % KV == 0 (query head h reads kv head
                        h // (H // KV); nothing is repeated in memory)
  o    [B, H, Sq, hd]   in q's dtype
  lse  [B, H, Sq]       float32, m + log(max(l, 1e-30))

Scores are ``(q * hd**-0.5) @ k^T`` in float32; masked scores are -1e30
(not -inf).  The causal mask is top-left aligned: query i sees keys 0..i
whatever Sq and Skv are.

:func:`flash_attention_bhsd` is the wrapper: on CUDA tensors it launches
a hand-written kernel (``csrc/flash_attention_fwd.cu``, built at first
use) or raises; on CPU tensors it runs :func:`flash_attention_plain`, the
same function in stock torch ops, which is also what the tests and the
on-card comparison hold the kernel against.  The wrapper takes any strides
whose last dimension is contiguous, so the model layout [B, S, H, hd] goes
in as a transposed view without a copy.

The dtype alone chooses the CUDA kernel (:func:`_kernel_variant`): float32
runs on fp32 FMAs (``"fp32 fma"``), bfloat16 on the tensor cores
(``"bf16 mma"``, which rounds the probabilities to bfloat16 before P . V).
The tensor-core kernel moves 16-byte rows, so its inputs must start on a
16-byte boundary with strides that are multiples of 8 elements
(:func:`_mma_layout_error`); a call that breaks this raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# head dims the CUDA kernel is instantiated for (templated on hd)
KERNEL_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
MAX_GRID_Y = 65535       # one grid row per (batch, head)
# the CUDA kernel each dtype runs, and its code in the launcher's `kernel`
_VARIANTS = {torch.float32: "fp32 fma", torch.bfloat16: "bf16 mma"}
_KERNEL_CODES = {"fp32 fma": 0, "bf16 mma": 1}


def _kernel_variant(dtype) -> str:
    """The CUDA kernel that inputs of ``dtype`` run, in the forward and in
    both backward passes: ``"fp32 fma"`` for float32, ``"bf16 mma"``
    (tensor cores) for bfloat16."""
    if dtype not in _VARIANTS:
        raise TypeError(f"no flash-attention kernel for {dtype}")
    return _VARIANTS[dtype]


def _mma_layout_error(*tensors):
    """Why the tensor-core kernels cannot take these [B, heads, S, hd]
    tensors, or None.  cp.async and ldmatrix move 16-byte rows: each tensor
    must start on a 16-byte boundary and its batch, head and row strides
    must be multiples of 8 elements (a dimension of size 1 is never
    strided)."""
    for i, t in enumerate(tensors):
        if t.data_ptr() % 16:
            return (f"input {i} of the bf16 tensor-core kernel does not "
                    f"start on a 16-byte boundary")
        if any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
               if n > 1):
            return (f"input {i} of the bf16 tensor-core kernel has strides "
                    f"{tuple(t.stride())}, not multiples of 8 elements")
    return None


def flash_attention_plain(q, k, v, *, causal=True):
    """Plain PyTorch version of the kernel (any device): one softmax over
    all keys, with the kernel's scaling, masking and lse."""
    B, H, Sq, hd = q.shape
    _, KV, Skv, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, Sq, hd).float() * scale
    s = torch.einsum("bkgqh,bkph->bkgqp", qg, k.float())
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bkgqp,bkph->bkgqh", p, v.float()) / l[..., None]
    lse = m + torch.log(l)
    return (o.reshape(B, H, Sq, hd).to(q.dtype),
            lse.reshape(B, H, Sq))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [B, heads, S, hd]")
    B, H, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if q.dtype not in _VARIANTS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load_library("flash_attention_fwd").flash_attention_fwd_launch
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([ptr, ptr, ptr, ptr, ptr]          # q k v o lse
                   + [i32] * 6                        # B H KV Sq Skv hd
                   + [i64] * 12                       # q k v o strides
                   + [ctypes.c_float, i32, i32, ptr])  # scale causal kernel st
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bhsd(q, k, v, *, causal=True):
    """(o [B, H, Sq, hd], lse [B, H, Sq]); see the module docstring.  CUDA
    tensors go to the kernel, CPU tensors to the plain version; there is no
    fallback from one to the other."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    B, H, Sq, hd = q.shape
    _, KV, Skv, _ = k.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid "
                         f"({MAX_GRID_Y} batch-heads)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dimension of q/k/v must be contiguous")
    variant = _kernel_variant(q.dtype)
    if variant == "bf16 mma" and (err := _mma_layout_error(q, k, v)):
        raise ValueError(err)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    if B * H * Sq == 0 or Skv == 0:
        return o.zero_(), lse.fill_(NEG_INF)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), B, H, KV, Sq, Skv, hd,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3], 1.0 / math.sqrt(hd), int(causal),
                     _KERNEL_CODES[variant], stream)
    flash_attention_bhsd.launches += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    return o, lse


flash_attention_bhsd.launches = 0
