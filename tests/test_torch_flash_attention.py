"""The port's flash-attention forward against the JAX reference (CPU).

Inputs come from a numpy seed and are rounded to the working dtype once,
so both packages see the same values.  The JAX side runs its Pallas kernel
in interpret mode; the port, given CPU tensors, runs the kernel's plain
version.  Tolerances are the reference's own (``tests/test_kernels.py``):
2e-6 in float32, 2e-2 in bfloat16 (abs and rel), on ``o`` and ``lse``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd as jax_flash
from repro.kernels.flash_attention.ref import \
    attention_reference as jax_reference
from repro_torch.kernels.flash_attention import kernel, ops, ref

FA_SHAPES = [
    # (B, H, KV, Sq, Skv, hd, causal): tests/test_kernels.py's, plus hd 80
    (1, 2, 2, 128, 128, 64, True),
    (2, 4, 2, 256, 256, 32, True),
    (1, 4, 1, 64, 192, 64, False),
    (1, 2, 2, 100, 100, 64, True),
    (2, 3, 1, 77, 130, 16, False),
    (1, 8, 2, 256, 100, 64, True),
    (1, 4, 2, 96, 120, 80, True),
]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _inputs(shape, dtype, seed=0):
    B, H, KV, Sq, Skv, hd, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FA_SHAPES,
                         ids=[f"B{b}H{h}KV{k}q{q}k{s}d{d}{'c' if c else 'f'}"
                              for b, h, k, q, s, d, c in FA_SHAPES])
def test_port_matches_pallas_kernel_and_reference(shape, dtype):
    causal = shape[-1]
    (qj, kj, vj), (qt, kt, vt) = _inputs(shape, dtype)
    o_j, lse_j = jax_flash(qj, kj, vj, causal=causal, q_block=64,
                           kv_block=64, interpret=True)
    ref_j = jax_reference(qj, kj, vj, causal=causal)
    before = kernel.flash_attention_bhsd.launches
    o_t, lse_t = kernel.flash_attention_bhsd(qt, kt, vt, causal=causal)
    assert kernel.flash_attention_bhsd.launches == before     # plain version
    assert o_t.dtype == qt.dtype and lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == shape[:2] + (shape[3],)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(o_t), _np(ref_j), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(ref.attention_reference(qt, kt, vt, causal=causal)),
        _np(ref_j), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_model_layout_entry_point_matches_reference(causal):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 50, 6, 80), dtype=np.float32)
    k = rng.standard_normal((2, 70, 2, 80), dtype=np.float32)
    v = rng.standard_normal((2, 70, 2, 80), dtype=np.float32)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


def test_forward_only_until_the_backward_kernels_are_ported():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="B3"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 3, 4, 16)
    with pytest.raises(ValueError, match="multiple"):
        kernel.flash_attention_bhsd(q, torch.zeros(1, 2, 4, 16),
                                    torch.zeros(1, 2, 4, 16))
    with pytest.raises(TypeError):
        kernel.flash_attention_bhsd(q.half(), q.half(), q.half())
    meta = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel.flash_attention_bhsd(meta, meta, meta)
