"""The port's SSD scan against the JAX reference (CPU).

Inputs come from a numpy seed (x rounded to the working dtype once), as
``tests/test_kernels.py`` draws them: dt = softplus(normal), A =
-exp(0.5 normal), B and C normal, D ones.  The JAX side runs its Pallas
kernel in interpret mode; the port, given CPU tensors, runs the kernel's
plain version.  Tolerances are the reference's own: 5e-4 in float32, 5e-2
in bfloat16 (abs and rel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ops
from repro.kernels.ssd_scan import ref as jax_ref
from repro_torch.kernels.ssd_scan import kernel, ops, ref

SSD_SHAPES = [
    # (b, l, h, p, n, chunk): tests/test_kernels.py's, plus chunk 256 with
    # a ragged l
    (2, 128, 4, 16, 16, 32),
    (1, 100, 8, 32, 64, 64),
    (2, 256, 2, 64, 32, 64),
    (1, 37, 3, 8, 8, 16),
    (1, 300, 2, 16, 16, 256),
]
TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _inputs(b, l, h, p, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    x = np.asarray(jnp.asarray(x).astype(getattr(jnp, dtype)), np.float32)
    dt = _softplus(rng.standard_normal((b, l, h), dtype=np.float32))
    A = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.5)
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    D = np.ones(h, np.float32)
    return x, dt, A.astype(np.float32), B, C, D


def _jax(arrs, dtype):
    x, *rest = arrs
    return [jnp.asarray(x).astype(getattr(jnp, dtype))] + \
        [jnp.asarray(a) for a in rest]


def _torch(arrs, dtype):
    x, *rest = arrs
    return [torch.from_numpy(np.array(x)).to(getattr(torch, dtype))] + \
        [torch.from_numpy(a) for a in rest]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=[f"b{b}l{l}h{h}p{p}n{n}c{c}"
                              for b, l, h, p, n, c in SSD_SHAPES])
def test_port_matches_pallas_kernel_and_sequential(shape, dtype):
    b, l, h, p, n, chunk = shape
    arrs = _inputs(b, l, h, p, n, dtype)
    xj, dtj, Aj, Bj, Cj, Dj = _jax(arrs, dtype)
    want = jax_ops.ssd_scan(xj, dtj, Aj, Bj, Cj, Dj, chunk=chunk)
    seq = jax_ref.ssd_sequential(xj.astype(jnp.float32), dtj, Aj, Bj, Cj,
                                 Dj)
    before = kernel.ssd_scan_chunked.launches
    got = ops.ssd_scan(*_torch(arrs, dtype), chunk=chunk)
    assert kernel.ssd_scan_chunked.launches == before       # plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, l, h, p)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(seq), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 96, 4, 16, 16, 32),
                                   (1, 37, 3, 8, 8, 16)])
def test_chunked_and_sequential_oracles_match_the_reference(shape):
    b, l, h, p, n, chunk = shape
    arrs = _inputs(b, l, h, p, n, "float32", seed=1)
    xj, dtj, Aj, Bj, Cj, Dj = _jax(arrs, "float32")
    xt, dtt, At, Bt, Ct, Dt = _torch(arrs, "float32")
    np.testing.assert_allclose(
        _np(ref.ssd_chunked(xt, dtt, At, Bt, Ct, Dt, chunk=chunk)),
        _np(jax_ref.ssd_chunked(xj, dtj, Aj, Bj, Cj, Dj, chunk=chunk)),
        atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(
        _np(ref.ssd_sequential(xt, dtt, At, Bt, Ct, Dt)),
        _np(jax_ref.ssd_sequential(xj, dtj, Aj, Bj, Cj, Dj)),
        atol=5e-4, rtol=5e-4)


def test_decode_step_matches_the_reference():
    b, h, p, n = 2, 4, 16, 8
    rng = np.random.default_rng(2)
    state = rng.standard_normal((b, h, p, n), dtype=np.float32)
    x = rng.standard_normal((b, h, p), dtype=np.float32)
    dt = _softplus(rng.standard_normal((b, h), dtype=np.float32))
    A = -np.exp(rng.standard_normal(h, dtype=np.float32))
    B = rng.standard_normal((b, n), dtype=np.float32)
    C = rng.standard_normal((b, n), dtype=np.float32)
    D = rng.standard_normal(h, dtype=np.float32)
    s_j, y_j = jax_ref.ssd_decode_step(*(jnp.asarray(a) for a in
                                         (state, x, dt, A, B, C)),
                                       D=jnp.asarray(D))
    s_t, y_t = ref.ssd_decode_step(*(torch.from_numpy(a) for a in
                                     (state, x, dt, A, B, C)),
                                   D=torch.from_numpy(D))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, A, B, C, D = _torch(_inputs(1, 40, 2, 8, 8, "float32"),
                               "float32")
    with pytest.raises(ValueError, match="multiple of chunk"):
        kernel.ssd_scan_chunked(x, dt, A, B, C, D, chunk=32)
    with pytest.raises(TypeError, match="dt must be float32"):
        kernel.ssd_scan_chunked(x, dt.double(), A, B, C, D, chunk=8)
    meta = [t.to("meta") for t in (x, dt, A, B, C, D)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel.ssd_scan_chunked(*meta, chunk=8)
