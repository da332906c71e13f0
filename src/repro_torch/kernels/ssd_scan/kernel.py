"""The SSD chunked-scan kernel: wrapper, plain version, launch count.

Contract (the JAX package's ``ssd_scan_chunked``):

  x     [b, l, h, p]  float32 or bfloat16; l a multiple of ``chunk``
  dt    [b, l, h]     float32
  A, D  [h]           float32
  B, C  [b, l, n]     float32 or bfloat16
  y     [b, l, h, p]  in x's dtype

Per chunk of ``chunk`` steps and per head: ``cum = cumsum(dt * A)``; the
intra-chunk term ``sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j``;
the inter-chunk term ``exp(cum_i) C_i . state``; then the state
``[p, n]`` (float32, zero at the start) becomes ``exp(cum_last) state +
sum_j exp(cum_last - cum_j) dt_j x_j B_j^T``; finally ``+ D x``.

:func:`ssd_scan_chunked` is the wrapper: on CUDA tensors it launches the
hand-written kernels (``csrc/ssd_scan.cu``, built at first use) or raises;
on CPU tensors it runs :func:`ssd_scan_plain`, the same function in stock
torch ops, which is also what the tests and the on-card comparison hold
the kernels against.

The dtype pair alone chooses the CUDA kernels (:func:`_kernel_variant`):
bfloat16 x with bfloat16 B and C runs on the tensor cores (``"bf16
mma"``: three launches per call, chunk states, their chain, then the
output, with an fp32 scratch of one [p, n] state per batch, chunk and
head and of (cum, dt) per step; W, the scaled B rows and the state go
into their products as a bfloat16 high plus a bfloat16 low part); every
other pair runs one launch on fp32 FMAs (``"fp32 fma"``).  The
tensor-core kernels take chunk and n multiples of 16 and p a multiple of
8 (:func:`_mma_limits_error`), with x, B and C starting on a 16-byte
boundary (:func:`_mma_layout_error`); a call that breaks this raises.
``ssd_scan_chunked.launches`` counts calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 256          # cum/dt of one chunk live in shared memory
MAX_HEAD_DIM = 64        # p: four 16-wide column groups per thread
MAX_STATE = 128          # n: the [p, n] state lives in shared memory
MAX_GRID_Y = 65535       # one grid row per batch entry
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_variant(x_dtype, bc_dtype) -> str:
    """The CUDA kernels that x of ``x_dtype`` with B and C of ``bc_dtype``
    run: ``"bf16 mma"`` (tensor cores) for bfloat16 with bfloat16,
    ``"fp32 fma"`` for every other float32/bfloat16 pair."""
    if x_dtype not in _DTYPES or bc_dtype not in _DTYPES:
        raise TypeError(f"no SSD scan kernel for {x_dtype} with {bc_dtype}")
    if x_dtype == bc_dtype == torch.bfloat16:
        return "bf16 mma"
    return "fp32 fma"


def _mma_limits_error(p, n, chunk):
    """Why the tensor-core kernels cannot take these widths, or None: the
    products run in 16-wide steps over chunk and n, and x rows move as
    16-byte runs (p is padded to 16 columns in shared memory)."""
    if chunk % 16 or n % 16 or p % 8:
        return (f"the bf16 tensor-core SSD kernels take chunk and n "
                f"multiples of 16 and p a multiple of 8; got chunk {chunk}, "
                f"n {n}, p {p}")
    return None


def _mma_layout_error(*tensors):
    """Why the tensor-core kernels cannot take these contiguous tensors, or
    None: cp.async moves 16-byte rows, so each must start on a 16-byte
    boundary."""
    for i, t in enumerate(tensors):
        if t.data_ptr() % 16:
            return (f"input {i} of the bf16 tensor-core SSD kernels does not "
                    f"start on a 16-byte boundary")
    return None


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk=64):
    """Plain PyTorch version of the kernel (any device)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    Af, Df = A.float(), D.float()
    later = ~torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty((b, nc, chunk, h, p), dtype=torch.float32,
                    device=x.device)
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(dtc * Af, dim=1)                 # [b,q,h]
        # exp only where j <= i: exp(-inf) = 0 above the diagonal
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            later[None, :, :, None], float("-inf"))
        w = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None] * torch.exp(seg)
        xdt = xc * dtc[..., None]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xdt)
        y_inter = torch.einsum("bin,bhpn->bihp", Cc, state) \
            * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:, :] - cum) * dtc      # [b,q,h]
        state = state * torch.exp(cum[:, -1, :])[..., None, None] \
            + torch.einsum("bjh,bjn,bjhp->bhpn", to_end, Bc, xc)
        y[:, c] = y_intra + y_inter + xc * Df[None, None, :, None]
    return y.reshape(b, l, h, p).to(x.dtype)


def _check(x, dt, A, B, C, D, chunk):
    if x.dim() != 4:
        raise ValueError("x must be [b, l, h, p]")
    b, l, h, p = x.shape
    if dt.shape != (b, l, h) or A.shape != (h,) or D.shape != (h,):
        raise ValueError(f"dt/A/D shapes {tuple(dt.shape)}/{tuple(A.shape)}"
                         f"/{tuple(D.shape)} do not match x {tuple(x.shape)}")
    if B.dim() != 3 or B.shape[:2] != (b, l) or C.shape != B.shape:
        raise ValueError(f"B/C shapes {tuple(B.shape)}/{tuple(C.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if chunk < 1 or l % chunk:
        raise ValueError(f"l = {l} is not a multiple of chunk = {chunk} "
                         "(ops.ssd_scan pads)")
    if x.dtype not in _DTYPES or B.dtype not in _DTYPES or \
            C.dtype != B.dtype:
        raise TypeError(f"x and B/C must be float32 or bfloat16, got "
                        f"{x.dtype} and {B.dtype}/{C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("all inputs must lie on one device")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load_library("ssd_scan").ssd_scan_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 9 + [i32] * 5 + [i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_chunked(x, dt, A, B, C, D, *, chunk=64):
    """y [b, l, h, p]; see the module docstring.  CUDA tensors go to the
    kernel, CPU tensors to the plain version; there is no fallback from one
    to the other."""
    _check(x, dt, A, B, C, D, chunk)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {dev}")
    b, l, h, p = x.shape
    n = B.shape[-1]
    if chunk > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE or \
            b > MAX_GRID_Y:
        raise ValueError(
            f"the CUDA kernel takes chunk <= {MAX_CHUNK}, p <= "
            f"{MAX_HEAD_DIM}, n <= {MAX_STATE}, b <= {MAX_GRID_Y}; got "
            f"{chunk}, {p}, {n}, {b}")
    x, dt, A, B, C, D = (t.contiguous() for t in (x, dt, A, B, C, D))
    mma = _kernel_variant(x.dtype, B.dtype) == "bf16 mma"
    if mma and (err := _mma_limits_error(p, n, chunk)
                or _mma_layout_error(x, B, C)):
        raise ValueError(err)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    # the tensor-core path's scratch: each chunk's state, and (cum, dt) of
    # each step
    nc = l // chunk if mma else 0
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
    cumdt = torch.empty((b, nc, h, chunk, 2), dtype=torch.float32,
                        device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
                     states.data_ptr(), cumdt.data_ptr(), b, l, h, p, n,
                     chunk, _DTYPES[x.dtype], _DTYPES[B.dtype], stream)
    ssd_scan_chunked.launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    return y


ssd_scan_chunked.launches = 0
