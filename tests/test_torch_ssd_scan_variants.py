"""Which CUDA kernels the SSD scan (K5) runs, what its bf16 tensor-core
kernels take, and their arithmetic, checked on the CPU (no CUDA, no
compiler).

bfloat16 x with bfloat16 B and C runs on the tensor cores, every other
dtype pair on fp32 FMAs; the choice is a pure function of the dtype pair.
The tensor-core kernels take chunk and n multiples of 16 and p a multiple
of 8, with x, B and C on 16-byte boundaries; both checks are pure functions
of the widths and the tensors' pointers.  On CPU tensors the wrapper runs
the plain version whatever the widths or the layout.  Last, the kernels'
arithmetic is emulated in float64: their decomposition (each chunk's own
state, the chain over chunks, then the output) and their roundings (C B^T
exact; W, the scaled B rows and the entering state as a bf16 high plus a
bf16 low part against exact x or C), held against the plain version and
against the JAX package's Pallas kernel (interpret mode) with the on-card
bf16 tolerance (5e-2 abs + rel), at the smoke config's, Zamba2-2.7B's and
Mamba-2-130M's widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ops
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel, ops

BF16, F32 = torch.bfloat16, torch.float32
TOL = 5e-2


@pytest.mark.parametrize("x_dtype,bc_dtype,variant", [
    (BF16, BF16, "bf16 mma"),
    (BF16, F32, "fp32 fma"),
    (F32, BF16, "fp32 fma"),
    (F32, F32, "fp32 fma")])
def test_kernel_variant_is_chosen_by_the_dtype_pair_alone(x_dtype, bc_dtype,
                                                          variant):
    assert kernel._kernel_variant(x_dtype, bc_dtype) == variant


@pytest.mark.parametrize("pair", [(torch.float16, BF16),
                                  (BF16, torch.float64)])
def test_kernel_variant_refuses_other_dtypes(pair):
    with pytest.raises(TypeError, match="no SSD scan kernel"):
        kernel._kernel_variant(*pair)


@pytest.mark.parametrize("p,n,chunk,ok", [
    (64, 64, 256, True),          # Zamba2-2.7B
    (64, 128, 256, True),         # Mamba-2-130M
    (16, 16, 32, True),           # the smoke configs
    (8, 128, 16, True),
    (24, 48, 64, True),
    (12, 64, 64, False),          # p not a multiple of 8
    (64, 72, 64, False),          # n not a multiple of 16
    (64, 8, 64, False),
    (64, 64, 40, False),          # chunk not a multiple of 16
    (64, 64, 8, False)])
def test_mma_limits(p, n, chunk, ok):
    err = kernel._mma_limits_error(p, n, chunk)
    if ok:
        assert err is None
    else:
        assert f"got chunk {chunk}, n {n}, p {p}" in err


def _offset(elements):
    """A contiguous bf16 [1, 8, 2, 16] starting `elements` past an aligned
    start."""
    buf = torch.zeros(256 + 64, dtype=BF16)
    assert buf.data_ptr() % 16 == 0
    return buf[elements:elements + 256].view(1, 8, 2, 16)


@pytest.mark.parametrize("elements,want", [(0, None), (8, None), (16, None),
                                           (1, "16-byte"), (4, "16-byte")])
def test_mma_layout_check(elements, want):
    x = _offset(elements)
    good = torch.zeros(1, 8, 16, dtype=BF16)
    for i, args in ((0, (x,)), (2, (good, good, x))):
        err = kernel._mma_layout_error(*args)
        if want is None:
            assert err is None
        else:
            assert want in err and f"input {i} " in err


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _inputs(b, l, h, p, n, seed):
    """x, B, C rounded to bf16 once; dt = softplus(normal), A = -exp(0.5
    normal), D normal (as tests/test_torch_ssd_scan.py draws them)."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to(BF16)
    x = bf16(b, l, h, p)
    dt = torch.from_numpy(_softplus(rng.standard_normal((b, l, h))))
    A = torch.from_numpy(-np.exp(rng.standard_normal(h) * 0.5)
                         .astype(np.float32))
    B, C = bf16(b, l, n), bf16(b, l, n)
    D = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
    return x, dt, A, B, C, D


@pytest.mark.parametrize("p,n,chunk", [(16, 16, 32), (64, 128, 256),
                                       (12, 8, 16)])
def test_cpu_wrapper_runs_the_plain_version(monkeypatch, p, n, chunk):
    """CPU tensors never reach a kernel, a compiler or the checks: bf16
    inputs of any width (12 and 8 the tensor-core kernels refuse) and any
    alignment give the plain version's result bit for bit."""
    def no_compiler(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")
    monkeypatch.setattr(_build, "load_library", no_compiler)
    x, dt, A, B, C, D = _inputs(1, 2 * chunk, 3, p, n, seed=5)
    before = kernel.ssd_scan_chunked.launches
    got = kernel.ssd_scan_chunked(x, dt, A, B, C, D, chunk=chunk)
    want = kernel.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    assert torch.equal(got, want)
    buf = torch.zeros(x.numel() + 1, dtype=BF16)
    shifted = buf[1:].view(x.shape).copy_(x)         # 2 bytes off a boundary
    assert torch.equal(
        kernel.ssd_scan_chunked(shifted, dt, A, B, C, D, chunk=chunk), want)
    assert kernel.ssd_scan_chunked.launches == before


# ---- the tensor-core kernels' arithmetic, emulated ------------------------

def _split(x):
    """x as a bf16 high part plus a bf16 low part (K5's rounded operands)."""
    hi = x.to(BF16).double()
    return hi + (x - hi).to(BF16).double()


def _emulated_ssd(x, dt, A, B, C, D, chunk, split=("W", "B", "state")):
    """K5 on the tensor cores, in float64: per chunk its own state X^T
    (scaled B), the chain over chunks, then y = exp(cum_i) C_i . state +
    W X + D x with W = (C B^T) exp(cum_i - cum_j) dt_j for j <= i; W, the
    scaled B rows and the entering state split into bf16 high + low parts
    (those not named in ``split`` rounded to bf16 once).  l must be a
    multiple of ``chunk``."""
    def rounded(t, name):
        return _split(t) if name in split else t.to(BF16).double()

    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xf = x.double().reshape(b, nc, chunk, h, p)
    dtf = dt.double().reshape(b, nc, chunk, h)
    Bf = B.double().reshape(b, nc, chunk, n)
    Cf = C.double().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A.double(), 2)                   # b c q h
    # 1. each chunk's own state, from B scaled by exp(cum_last - cum_j) dt_j
    to_end = torch.exp(cum[:, :, -1:, :] - cum) * dtf
    Bsc = rounded(Bf[:, :, :, None, :] * to_end[..., None], "B")
    own = torch.einsum("bcjhn,bcjhp->bchpn", Bsc, xf)
    # 2. the chain: the state entering each chunk
    entering = torch.zeros_like(own)
    for c in range(1, nc):
        entering[:, c] = torch.exp(cum[:, c - 1, -1])[..., None, None] \
            * entering[:, c - 1] + own[:, c - 1]
    # 3. the output
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cf,
                           rounded(entering, "state")) \
        * torch.exp(cum)[..., None]
    later = ~torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        later[None, None, :, :, None], float("-inf"))
    G = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    W = rounded(G[..., None] * torch.exp(seg) * dtf[:, :, None, :, :],
                "W")
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xf)
    y = y_inter + y_intra + xf * D.double()[None, None, None, :, None]
    return y.reshape(b, l, h, p).to(x.dtype)


def _padded(x, dt, B, C, chunk):
    """ops.ssd_scan's padding of l to a multiple of chunk (dt = 0)."""
    pad = (-x.shape[1]) % chunk
    F = torch.nn.functional
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)))


EMULATED = [  # (b, l, h, p, n, chunk): ragged l
    (2, 100, 4, 16, 16, 32),      # the smoke configs' widths
    (1, 600, 3, 64, 64, 256),     # Zamba2-2.7B's
    (1, 520, 2, 64, 128, 256),    # Mamba-2-130M's
    (1, 200, 3, 8, 128, 16),
]


@pytest.mark.parametrize("shape", EMULATED,
                         ids=[f"p{s[3]}n{s[4]}c{s[5]}" for s in EMULATED])
def test_tensor_core_arithmetic_stays_within_the_bf16_tolerance(shape):
    """The kernels' decomposition and roundings, emulated, against the
    plain version and the JAX package's Pallas kernel (interpret mode) on
    the same bf16 inputs."""
    b, l, h, p, n, chunk = shape
    x, dt, A, B, C, D = _inputs(b, l, h, p, n, seed=sum(shape))
    xp, dtp, Bp, Cp = _padded(x, dt, B, C, chunk)
    got = _emulated_ssd(xp, dtp, A, Bp, Cp, D, chunk)[:, :l]
    want = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)      # plain on CPU
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (x, B, C)]
    ref = jax_ops.ssd_scan(jx[0], jnp.asarray(dt.numpy()),
                           jnp.asarray(A.numpy()), jx[1], jx[2],
                           jnp.asarray(D.numpy()), chunk=chunk)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=TOL,
                               rtol=TOL)
